"""Host-side execution-order heuristic.

Reference: ``executionOrder`` (include/mccompletepathv2.h:36-113): sort nodes
by (indegree desc, outdegree asc), then a greedy queue pass appends a node,
decrements each predecessor's count of not-yet-ordered successors, and
appends predecessors whose successors are all ordered.

MCCompletePathV2 does not need it here (every source walks at once, see
models/mccompletepathv2.py); it is exposed for users of the reference's
serial pipeline and for schedule analysis.  Pure numpy.
"""

from __future__ import annotations

from collections import deque
from typing import List

import numpy as np

from ..graph import Graph

__all__ = ["execution_order"]


def execution_order(graph: Graph) -> List[int]:
    """Heuristic processing order over internal node ids."""
    n = graph.num_nodes
    cindptr, cindices = graph.csc
    indeg = np.diff(cindptr)
    outdeg = graph.out_degree
    # (indegree desc, outdegree asc): mccompletepathv2.h:57-62
    sorted_nodes = np.lexsort((outdeg, -indeg))

    wait_for = outdeg.astype(np.int64).copy()
    visited = np.zeros(n, dtype=bool)
    order: List[int] = []
    qu: deque = deque()
    for node in sorted_nodes:
        if visited[node]:
            continue
        qu.append(int(node))
        visited[node] = True
        while qu:
            nxt = qu.popleft()
            order.append(nxt)
            for pred in cindices[cindptr[nxt] : cindptr[nxt + 1]]:
                pred = int(pred)
                if wait_for[pred] > 0:
                    wait_for[pred] -= 1
                    if wait_for[pred] == 0 and not visited[pred]:
                        visited[pred] = True
                        qu.append(pred)
    return order
