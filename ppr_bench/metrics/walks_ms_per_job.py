"""Walker: milliseconds of the program's ``mc.walks`` span (the walks, their
alive checks and the trace top-L of every source chunk), per job
(``mc.job``)."""

from ppr_bench.metrics._program_spans import ms, named, per


def read(data):
    parts = named("mc.walks")
    return per(ms(parts), parts, "mc.job")
