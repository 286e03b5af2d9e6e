"""Exact personalized PageRank by power iteration: the ground-truth oracle.

Reference: ``pprInternal::pprSingleSource``
(include/internal/pprSingleSource.h:28-75).  Semantics preserved:

* power iteration pushing ``score * damping/outdeg`` along edges (absent
  key = 0);
* the teleport mass ``1 - damping`` is re-injected at the source each sweep;
* **dangling nodes lose their mass** (no redistribution), like the
  approximation algorithms;
* per-source L1 tolerance stop; a negative tolerance disables the early
  stop (pprSingleSource.h:23-25).

Batched over sources: the state is node-major ``[N, B]``.  The push
``nxt[v] = sum over predecessors u of x[u] * damping/outdeg(u)`` is a
gather/reduce over in-degree-bucketed ELL of the reverse graph: for each
bucket of destinations, gather ``pushes[pred]`` into ``[C, cap, B]`` and
sum over ``cap``, with no scatter-add.
"""

from __future__ import annotations

from typing import Dict, Hashable, Sequence

import numpy as np
import torch

from ..graph import Graph
from ..parallel.mesh import put_sharded
from ..utils.device import resolve_device
from ..utils.validation import check_damping, check_iterations

# Bound on the [chunk, cap, B] gather intermediate per push step.
DEFAULT_EDGE_ELEM_BUDGET = 1 << 24


def _pred_buckets(graph: Graph, device: torch.device):
    """In-degree ELL buckets (rows, pred) of ``graph`` on ``device``, cached
    on the graph per device."""
    cache = graph.__dict__.setdefault("_torch_pred_buckets", {})
    key = str(device)
    if key not in cache:
        cindptr, cindices = graph.csc
        plan = Graph(cindptr, cindices).merge_plan(None)
        cache[key] = tuple(
            (
                torch.as_tensor(bk.rows, dtype=torch.int64).to(device),
                torch.as_tensor(bk.succ, dtype=torch.int64).to(device),
            )
            for bk in plan.buckets
        )
    return cache[key]


def _power_iterate(
    pred_buckets,
    coef: torch.Tensor,  # float32[N] damping/outdeg, 0 for dangling
    sources: torch.Tensor,  # int64[B]
    damping: float,
    tolerance: float,
    iterations: int,
    elem_budget: int,
) -> torch.Tensor:
    n = coef.shape[0]
    b = sources.shape[0]
    dev = coef.device
    cols = torch.arange(b, device=dev)
    teleport = 1.0 - torch.tensor(damping, dtype=torch.float32, device=dev)
    x = torch.zeros((n, b), dtype=torch.float32, device=dev)
    x[sources, cols] = 1.0
    active = torch.ones(b, dtype=torch.bool, device=dev)
    for _ in range(iterations):
        pushes = x * coef[:, None]
        nxt = torch.zeros_like(x)
        for rows, pred in pred_buckets:
            c, cap = pred.shape
            chunk = int(max(1, min(c, elem_budget // max(b * cap, 1))))
            for s0 in range(0, c, chunk):
                p = pred[s0 : s0 + chunk]
                valid = (p >= 0).to(torch.float32)
                vals = pushes[p.clamp(min=0)] * valid[..., None]  # [c, cap, B]
                nxt[rows[s0 : s0 + chunk]] = vals.sum(dim=1)
        nxt[sources, cols] += teleport
        diff = (x - nxt).abs().sum(dim=0)
        x = torch.where(active[None, :], nxt, x)
        active = active & (diff >= tolerance)
        if not bool(active.any()):
            break
    return x.T.contiguous()


def _oracle_on(graph, sources: torch.Tensor, damping, tolerance, iterations,
               edge_elem_budget) -> torch.Tensor:
    """The oracle's ``[B, N]`` vectors for ``sources``, on their device."""
    dev = sources.device
    deg = torch.as_tensor(graph.out_degree, dtype=torch.float32).to(dev)
    coef = torch.where(
        deg > 0,
        torch.tensor(damping, dtype=torch.float32, device=dev) / deg.clamp(min=1.0),
        torch.zeros_like(deg),
    )
    return _power_iterate(
        _pred_buckets(graph, dev), coef, sources, damping, tolerance, iterations,
        edge_elem_budget,
    )


def ppr_single_source_batch(
    graph: Graph,
    sources: Sequence[int] | np.ndarray,
    iterations: int,
    damping: float,
    tolerance: float,
    edge_elem_budget: int = DEFAULT_EDGE_ELEM_BUDGET,
    mesh=None,
    device=None,
) -> torch.Tensor:
    """Dense exact PPR vectors ``float32[B, N]`` for internal-id sources,
    on ``device`` (``None`` means ``"cuda"``).

    With ``mesh`` (parallel/mesh.py, one process) the source batch is
    padded to a multiple of the shard count and split across the shards,
    the CSR replicated on their devices; each source's vector is the
    unsharded one (sources never interact).  The result lives on the first
    shard's device.
    """
    check_iterations(iterations)
    check_damping(damping)
    src_np = np.asarray(sources, dtype=np.int64)
    b = int(src_np.shape[0])
    if mesh is None:
        src = torch.as_tensor(src_np).to(resolve_device(device))
        out = _oracle_on(graph, src, damping, tolerance, iterations, edge_elem_budget)
    else:
        if mesh.group is not None:
            raise ValueError("the sharded oracle runs in one process")
        padded = np.pad(src_np, (0, (-b) % mesh.n_shards))
        out = torch.cat([
            _oracle_on(graph, part, damping, tolerance, iterations,
                       edge_elem_budget).to(mesh.devices[0])
            for part in put_sharded(padded, mesh)
        ], dim=0)[:b]
    # Mass conservation: every true PPR vector sums to <= 1 (dangling mass
    # is only lost, pprSingleSource.h:57-66).  A row summing to more means a
    # broken push; fail loudly rather than score against a wrong oracle.
    if b > 0:
        sums = out.sum(dim=-1)
        max_sum = float(sums.max())
        if max_sum > 1.0 + 1e-3 or not bool(torch.isfinite(sums).all()):
            raise RuntimeError(
                "exact-PPR oracle violated mass conservation "
                f"(max row sum {max_sum:.4f} for batch shape "
                f"[{b}, {graph.num_nodes}])"
            )
    return out


def ppr_single_source(
    graph: Graph,
    iterations: int,
    damping: float,
    tolerance: float,
    source: Hashable,
    device=None,
) -> Dict[Hashable, float]:
    """Single-source exact PPR as a sparse dict over external keys.

    Only touched nodes are present (untouched = absent = 0), and the source
    is always present (pprSingleSource.h:45-54).
    """
    check_iterations(iterations)
    check_damping(damping)
    if source not in graph:
        raise ValueError("source node not part of the graph")
    sid = graph.key_to_id(source)
    dense = (
        ppr_single_source_batch(
            graph, [sid], iterations, damping, tolerance, device=device
        )[0]
        .cpu()
        .numpy()
    )
    keys = graph.keys
    out = {keys[i]: float(dense[i]) for i in np.nonzero(dense > 0)[0]}
    out.setdefault(keys[sid], float(dense[sid]))
    return out
