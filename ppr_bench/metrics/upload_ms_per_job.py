"""Host loop: milliseconds of the program's ``grank.upload`` span (the
plans, the damping scalar, the empty baskets and the dangling rows sent to
the device at every call), per job (``grank.job``)."""

from ppr_bench.metrics._program_spans import ms, named, per


def read(data):
    parts = named("grank.upload")
    return per(ms(parts), parts, "grank.job")
