"""Host loop: the init sweeps that ran as a replay of a captured CUDA
graph, the program's count ``graph_replays`` (1 for a replay, 0 for an
eager init sweep) on its ``grank.init_sweep`` spans, per job
(``grank.job``).  None where no init sweep carries the count (a program
whose init sweep counts no replays)."""

from ppr_bench.metrics._program_spans import named, per


def read(data):
    parts = named("grank.init_sweep")
    if not any("graph_replays" in s.counts for s in parts):
        return None
    return per(sum(s.counts.get("graph_replays", 0) for s in parts), parts, "grank.job")
