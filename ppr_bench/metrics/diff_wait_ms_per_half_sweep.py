"""Host loop: milliseconds the host waits for a half-sweep's max diff (the
program's ``grank.diff_wait`` span, the loop's one read from the device),
per half-sweep (``grank.half_sweep``)."""

from ppr_bench.metrics._program_spans import ms, named, per


def read(data):
    parts = named("grank.diff_wait")
    return per(ms(parts), parts, "grank.half_sweep")
