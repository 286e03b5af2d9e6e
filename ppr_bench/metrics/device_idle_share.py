"""Device: the share of the traced window in which no device activity ran,
in percent (1 - busy / window, busy being the union of the kernels',
copies' and sets' intervals)."""


def read(data):
    if data.window_s <= 0:
        return None
    return 100.0 * (1.0 - data.busy_s / data.window_s)
