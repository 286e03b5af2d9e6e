"""Walker: milliseconds the host waits on the walker's one read from the
device, whether any walk of a chunk is alive (the program's
``mc.alive_wait`` spans, one a macro step), per job (``mc.job``)."""

from ppr_bench.metrics._program_spans import ms, named, per


def read(data):
    parts = named("mc.alive_wait")
    return per(ms(parts), parts, "mc.job")
