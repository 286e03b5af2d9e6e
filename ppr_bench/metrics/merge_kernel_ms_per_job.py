"""Merge kernel: device milliseconds of the program's CUDA merge kernel
(``csrc/merge_topl.cu``, the template ``merge_kernel<...>``; in MC the
matrix entry on the walks' trace rows) over the traced window, per job (the
counter ``jobs``)."""

KERNEL = "merge_kernel"


def read(data):
    jobs = data.counters.get("jobs", 0)
    ms = sum(a.end - a.start for a in data.kernels() if KERNEL in a.name) * 1e3
    if not jobs or not ms:
        return None
    return ms / jobs
