"""Host loop: the share of half-sweeps that ran as a replay of a captured
CUDA graph, the program's count ``graph_replays`` (1 for a replay, 0 for
an eager half-sweep) on its ``grank.half_sweep`` spans, per half-sweep.
None where no half-sweep carries the count (a program without it)."""

from ppr_bench.metrics._program_spans import named, per


def read(data):
    parts = named("grank.half_sweep")
    if not any("graph_replays" in s.counts for s in parts):
        return None
    return per(sum(s.counts["graph_replays"] for s in parts), parts, "grank.half_sweep")
