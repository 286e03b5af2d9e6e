"""Merge kernel: launches of the program's CUDA merge kernel in the sparse
combine, the count ``merge_launches`` of its ``mc.combine_pass`` spans
(the increase of the kernel's own launch counters over each pass), per job
(``mc.job``).  None where the program records no such span (the dense
engine, or a program without it)."""

from ppr_bench.metrics._program_spans import named, per


def read(data):
    parts = named("mc.combine_pass")
    return per(sum(s.counts.get("merge_launches", 0) for s in parts), parts, "mc.job")
