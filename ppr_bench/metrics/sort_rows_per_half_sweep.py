"""Host loop: rows a GRank half-sweep merges through the sort pipeline
(rows too narrow or too wide for the merge kernel, ops/merge.py::merge_route),
the program's count ``sort_rows`` on its ``grank.half_sweep`` spans, per
half-sweep.  None where no half-sweep carries the count (a program
without it)."""

from ppr_bench.metrics._program_spans import named, per


def read(data):
    parts = named("grank.half_sweep")
    if not any("sort_rows" in s.counts for s in parts):
        return None
    return per(sum(s.counts.get("sort_rows", 0) for s in parts), parts, "grank.half_sweep")
