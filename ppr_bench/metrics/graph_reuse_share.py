"""Host loop: the share of GRank jobs that replayed half-sweep graphs an
earlier job captured, the program's count ``sweep_graphs_reused`` (1 where
the job found its captured state kept on the graph, 0 where it captured)
over the ``grank.job`` spans.  None where no ``grank.job`` span carries
the count (a program that keeps no graphs between calls, or jobs on the
CPU)."""

from ppr_bench.metrics._program_spans import named


def read(data):
    jobs = named("grank.job")
    if not any("sweep_graphs_reused" in s.counts for s in jobs):
        return None
    return sum(s.counts.get("sweep_graphs_reused", 0) for s in jobs) / len(jobs)
