"""Walker: device kernels launched over the traced window, per job that the
program reports (the counter ``jobs``, summed over the traced jobs); the
walks' hops, the trace top-L and the combine count together."""


def read(data):
    jobs = data.counters.get("jobs", 0)
    if not jobs:
        return None
    return len(data.kernels()) / jobs
