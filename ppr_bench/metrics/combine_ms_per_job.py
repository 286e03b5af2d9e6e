"""Combine: milliseconds of the program's ``mc.combine`` span (the
adjacency's upload and build, the combine's passes and the final top K),
per job (``mc.job``)."""

from ppr_bench.metrics._program_spans import ms, named, per


def read(data):
    parts = named("mc.combine")
    return per(ms(parts), parts, "mc.job")
