"""Sparse combine: milliseconds of the program's ``mc.final_cut`` span (the
cut of the last pass's ``[N, L]`` baskets to K, inside ``mc.combine``), per
job (``mc.job``).  None where the program records no such span (the dense
engine, or a program without it)."""

from ppr_bench.metrics._program_spans import ms, named, per


def read(data):
    parts = named("mc.final_cut")
    return per(ms(parts), parts, "mc.job")
