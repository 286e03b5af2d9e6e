"""GRank's main loop (include/grank.h:87-147; its semantics: the doc of
models/grank.py), written once.  The sparse engine (models/grank.py), the
dense engine (ops/dense.py) and the ring (parallel/ring.py) supply its
half-sweep.  With recording on (utils/profiling.py) each turn is the span
``grank.half_sweep`` (counts ``merge_launches``, the merge kernel's
launches, and ``graph_replays``, which a step that replays a CUDA graph
adds to) with ``grank.diff_wait``, the host's read of the max diff, inside
it.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..utils.profiling import span
from .merge_kernel import launch_count

__all__ = ["run_half_sweeps"]


def run_half_sweeps(step: Callable[[int], Optional[torch.Tensor]], iterations: int,
                    tolerance: float) -> int:
    """Run GRank's half-sweeps; returns how many ran.

    ``step(p)`` runs partition ``p``'s half-sweep and returns its max L1
    diff, a 0-d tensor, or None where it computed none (an empty partition,
    or a negative tolerance): the loop then takes 0.  ``tolerance`` is
    compared as given, so an engine passes the value its comparisons use.
    """
    max_diff = [tolerance, tolerance]
    i = 0
    while i < iterations and max(max_diff) >= tolerance:
        with span("grank.half_sweep") as half:
            launches = launch_count() if half else 0
            half.count("graph_replays", 0)
            d = step(i % 2)
            if half:
                half.count("merge_launches", launch_count() - launches)
            with span("grank.diff_wait"):
                max_diff[0] = 0.0 if d is None else float(d)
        max_diff[0], max_diff[1] = max_diff[1], max_diff[0]
        i += 1
    return i
