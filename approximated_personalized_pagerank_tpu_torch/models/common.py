"""Engine selection and result conversion shared by the models."""

from __future__ import annotations

from typing import Dict, Hashable

from ..graph import Graph
from ..ops.basket import Baskets


def check_engine(engine: str) -> None:
    """``"auto"`` and ``"sparse"`` run the sparse engine; ``"dense"`` is
    not ported yet."""
    if engine == "dense":
        raise NotImplementedError(
            "the dense engine is not ported yet (ROADMAP.md, queue A item 8); "
            "use engine='sparse' or 'auto'"
        )
    if engine not in ("auto", "sparse"):
        raise ValueError(f"unknown engine {engine!r}")


def baskets_to_dict(
    baskets: Baskets, graph: Graph
) -> Dict[Hashable, Dict[Hashable, float]]:
    """Convert [N, K] basket tensors to the reference's map-of-maps shape
    (unordered_map<Key, unordered_map<Key, double>>, include/grank.h:40-48),
    with external keys."""
    ids = baskets.ids.cpu().numpy()
    scores = baskets.scores.cpu().numpy()
    keys = graph.keys
    out: Dict[Hashable, Dict[Hashable, float]] = {}
    for v in range(graph.num_nodes):
        live = ids[v] >= 0
        out[keys[v]] = {
            keys[i]: float(s) for i, s in zip(ids[v][live], scores[v][live])
        }
    return out
