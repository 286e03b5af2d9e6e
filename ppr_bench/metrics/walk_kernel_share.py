"""Walker: the share of the walks' source chunks that the walk cohort
kernel walked, the program's count ``walk_kernel_chunks`` over its count
``chunks`` on its ``mc.walks`` spans (1.0 where every chunk ran in one
launch of the kernel).  None where no ``mc.walks`` span carries the count
(a program without the kernel, or walks on the CPU)."""

from ppr_bench.metrics._program_spans import named


def read(data):
    parts = named("mc.walks")
    if not any("walk_kernel_chunks" in s.counts for s in parts):
        return None
    chunks = sum(s.counts.get("chunks", 0) for s in parts)
    return sum(s.counts.get("walk_kernel_chunks", 0) for s in parts) / chunks
