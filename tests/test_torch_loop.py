"""GRank's one main loop (``ops/loop.py::run_half_sweeps``) driven by
scripted half-sweeps: the partitions it visits, when it stops, and its spans.

This file imports neither JAX nor the JAX package.
"""

import numpy as np
import pytest
import torch

from approximated_personalized_pagerank_tpu_torch.ops.loop import run_half_sweeps
from approximated_personalized_pagerank_tpu_torch.utils import profiling

F32_TOL = float(np.float32(1e-4))  # the dense engine's threshold for 1e-4

# (each partition's scripted diffs, None for no diff; iterations; tolerance;
#  the half-sweeps the reference's loop runs, include/grank.h:87-147)
CASES = {
    # both slots under the tolerance: partition 0's second diff is small,
    # then partition 1's, and the loop stops after it
    "both_slots_fall": ([[1.0, 1e-5, 1.0], [0.5, 1e-5, 1.0]], 10, 1e-4, 4),
    # a negative tolerance computes no diff and never stops early
    "negative_tolerance": ([[None] * 7, [None] * 7], 7, -1.0, 7),
    # an empty partition is a half-sweep with diff 0: the loop waits for
    # partition 0 alone
    "empty_partition": ([[1.0, 1.0, 1e-5], [None] * 3], 10, 1e-4, 5),
    # float32(1e-4) is below 1e-4: under the Python float (the sparse and
    # ring engines) both slots fall at once ...
    "f32_tolerance_python": ([[F32_TOL] * 3, [F32_TOL] * 3], 6, 1e-4, 2),
    # ... and equal to the dense engine's float32 threshold: never below
    "f32_tolerance_dense": ([[F32_TOL] * 3, [F32_TOL] * 3], 6, F32_TOL, 6),
    "no_iterations": ([[1.0], [1.0]], 0, 1e-4, 0),
}


@pytest.mark.parametrize("diffs,iterations,tolerance,want", CASES.values(), ids=CASES.keys())
def test_the_loop_stops_where_the_reference_does(diffs, iterations, tolerance, want):
    turns = []

    def step(p):
        d = diffs[p][sum(q == p for q in turns)]
        turns.append(p)
        return None if d is None else torch.tensor(d, dtype=torch.float32)

    profiling.clear()
    with profiling.record():
        ran = run_half_sweeps(step, iterations, tolerance)
    spans = profiling.recorded()
    profiling.clear()
    assert ran == want
    assert turns == [i % 2 for i in range(want)]
    sweeps = [s for s in spans if s.name == "grank.half_sweep"]
    waits = [s for s in spans if s.name == "grank.diff_wait"]
    assert len(sweeps) == want
    assert [w.parent for w in waits] == [s.id for s in sweeps]
    assert all(s.counts == {"graph_replays": 0, "merge_launches": 0} for s in sweeps)
