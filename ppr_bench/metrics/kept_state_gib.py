"""Host loop: GiB that sparse GRank's kept CUDA graphs' state holds on the
card after a call (``models/grank.py::_SweepGraphs``: both static
baskets, the plans, the dangling rows and the segments of its memory
pool), the program's count ``kept_bytes`` on its ``grank.job`` spans, per
job.  None where no job carries the count (an eager engine, or a program
without it)."""

from ppr_bench.metrics._program_spans import named, per


def read(data):
    parts = named("grank.job")
    if not any("kept_bytes" in s.counts for s in parts):
        return None
    return per(sum(s.counts.get("kept_bytes", 0) for s in parts) / 2**30, parts, "grank.job")
