"""Merge kernel: launches of the program's CUDA merge kernel per half-sweep,
the program's count ``merge_launches`` on its ``grank.half_sweep`` spans
(the increase of the kernel's own launch counters over each)."""

from ppr_bench.metrics._program_spans import named, per


def read(data):
    parts = named("grank.half_sweep")
    return per(sum(s.counts.get("merge_launches", 0) for s in parts), parts,
               "grank.half_sweep")
