"""Host loop: milliseconds of the program's ``grank.init_sweep`` span (the
init sweep's enqueue; it reads nothing back), per job (``grank.job``)."""

from ppr_bench.metrics._program_spans import ms, named, per


def read(data):
    parts = named("grank.init_sweep")
    return per(ms(parts), parts, "grank.job")
