"""Merge kernel: device milliseconds of the program's CUDA merge kernel
(``csrc/merge_topl.cu``, both entries: the template ``merge_kernel<...>``)
over the traced window, per half-sweep (``iterations_ran``)."""

KERNEL = "merge_kernel"


def read(data):
    sweeps = data.counters.get("iterations_ran", 0)
    ms = sum(a.end - a.start for a in data.kernels() if KERNEL in a.name) * 1e3
    if not sweeps or not ms:
        return None
    return ms / sweeps
