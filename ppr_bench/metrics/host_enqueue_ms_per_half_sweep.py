"""Host loop: milliseconds a half-sweep spends enqueueing its device work,
the program's ``grank.half_sweep`` spans less their ``grank.diff_wait``
children, per half-sweep."""

from ppr_bench.metrics._program_spans import ms, named, per


def read(data):
    parts = named("grank.half_sweep")
    return per(ms(parts) - ms(named("grank.diff_wait")), parts, "grank.half_sweep")
