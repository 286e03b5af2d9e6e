"""Host loop: device kernels launched over the traced window, per
half-sweep that the program reports (``iterations_ran``, summed over the
traced jobs); the init sweep and the final cut count with them."""


def read(data):
    sweeps = data.counters.get("iterations_ran", 0)
    if not sweeps:
        return None
    return len(data.kernels()) / sweeps
