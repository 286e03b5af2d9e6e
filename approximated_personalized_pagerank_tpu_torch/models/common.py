"""Result conversion shared by the models."""

from __future__ import annotations

from typing import Dict, Hashable

from ..graph import DeviceGraph, Graph
from ..ops.basket import Baskets


def device_graph(graph: Graph, device="cuda") -> DeviceGraph:
    """The graph's CSR on ``device`` (the card by default), cached on the
    graph: :meth:`Graph.device_graph`, exported at the top level as the
    JAX package exports its ``device_graph``."""
    return graph.device_graph(device)


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
