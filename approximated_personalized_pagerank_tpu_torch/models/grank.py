"""GRank: all-sources top-K personalized PageRank by iterative basket merging.

Reference: ``ppr::grank`` (include/grank.h:42-150).  Semantics preserved:

* init: ``scores[v] = keepTop_L({v: 1-damping} + {succ: += damping/outdeg})``
  (include/grank.h:64-83);
* the main loop sweeps ONE partition per iteration (``iterations`` counts
  half-sweeps); the other partition's baskets carry over, so a node reads
  t-1 data from the other partition and t-2 data from its own
  (include/grank.h:92-140);
* two ``maxDiff`` slots, one per partition, keep a trivial partition from
  ending the loop before the other ran (include/grank.h:87-92);
* a negative tolerance disables the early stop (include/grank.h:37-39);
* final ``keepTop(K)`` truncation (include/grank.h:143-147).

Baskets are ``[N, L]`` id/score tensors; each half-sweep merges the active
partition's degree buckets (ops/merge.py).  The loop runs on the host and
reads the half-sweep's max L1 diff once per half-sweep.  Graphs up to
16,384 nodes take the dense engine by default (ops/dense.py); with a
``mesh`` the run is the ring-sharded one (parallel/ring.py).
"""

from __future__ import annotations

from typing import Dict, Hashable

import numpy as np
import torch

from ..graph import Graph
from ..ops.basket import Baskets, empty_baskets, keep_top_chunked
from ..ops.dense import dense_grank_run, use_dense_engine
from ..ops.merge import (
    DEFAULT_ELEM_BUDGET,
    device_plan,
    merge_sweep,
    net_max_width,
    resolve_merge_algo,
)
from ..parallel.mesh import mesh_for
from ..parallel.ring import ring_grank_baskets
from ..utils.device import resolve_device
from ..utils.validation import (
    check_basket_params,
    check_damping,
    check_iterations,
    check_shards,
)
from .common import baskets_to_dict


def _set_dangling(basket: Baskets, rows: np.ndarray, damping: float) -> Baskets:
    """Dangling nodes' baskets are exactly {v: 1-damping}, forever (in place)."""
    if rows.size == 0:
        return basket
    rows_d = torch.as_tensor(rows, dtype=torch.int64).to(basket.ids.device)
    basket.ids[rows_d, 0] = rows_d.to(torch.int32)
    basket.scores[rows_d, 0] = 1.0 - float(damping)
    return basket


def grank_baskets(
    graph: Graph,
    K: int,
    L: int,
    iterations: int,
    damping: float,
    tolerance: float,
    elem_budget: int = DEFAULT_ELEM_BUDGET,
    merge_algo: str | None = None,
    engine: str = "auto",
    matmul_dtype=None,
    exact_trunc: bool = False,
    return_info: bool = False,
    device=None,
    mesh=None,
    host_loop: bool = False,
):
    """GRank returning ``[N, K]`` basket tensors over internal node ids.

    ``device`` is where the run happens: ``None`` means ``"cuda"``, which
    raises when no card is present; pass ``"cpu"`` for the CPU.  With a
    ``mesh`` (parallel/mesh.py) the run is sharded over its shards
    (``ring_grank_baskets``; ``device`` is the mesh's) unless ``engine`` is
    ``"dense"``: ``"auto"`` is then sparse.

    ``engine``: ``"sparse"`` is the merge pipeline over degree buckets;
    ``"dense"`` runs each half-sweep as one matrix product over an
    ``[N, N]`` score matrix (ops/dense.py); ``"auto"`` picks dense up to
    ``PPR_DENSE_MAX_NODES`` (16,384) nodes, as the JAX package does.
    ``merge_algo`` (sparse) is ``"sort"`` or ``"kernel"``, optionally with
    ``":<cap>"`` (see ops/merge.py); ``None`` picks the kernel on CUDA and
    the sort pipeline on the CPU.  ``matmul_dtype`` (dense) is the product's
    input dtype, bfloat16 on the card by default; ``exact_trunc`` (dense)
    keeps exactly L entries a row at each cut.

    With ``return_info=True`` returns ``(baskets, info)``, where
    ``info["iterations_ran"]`` is the number of half-sweeps the loop ran
    (a tolerance stop can end it before ``iterations``); the dense engine
    adds ``info["flops"]``, its products' FLOPs.

    ``host_loop`` is the JAX package's flag: there it steps the sparse
    runner from the host, so ``host_loop=True`` turns ``engine="auto"``
    into ``"sparse"``.  That is all it does here, where the loop always
    runs on the host.
    """
    check_basket_params(K, L)
    if host_loop and engine == "auto":
        engine = "sparse"
    check_iterations(iterations)
    check_damping(damping)
    dev = resolve_device(device) if mesh is None else mesh.devices[0]
    algo = resolve_merge_algo(merge_algo, dev)

    n = graph.num_nodes
    dense = use_dense_engine(n, engine, mesh=mesh)
    if n == 0:
        out = empty_baskets(0, K, dev)
        return (out, {"iterations_ran": 0}) if return_info else out
    if dense:
        return dense_grank_run(
            graph, K, L, iterations, damping, tolerance,
            matmul_dtype=matmul_dtype, exact_trunc=exact_trunc,
            return_info=return_info, device=dev,
        )
    if mesh is not None:
        return ring_grank_baskets(
            graph, K, L, iterations, damping, tolerance, mesh=mesh,
            elem_budget=elem_budget, merge_algo=algo, return_info=return_info,
        )

    # The kernel pipeline plans width-aligned caps (cap*L+1 lands at a power
    # of two) and gives hub rows (deg > the largest aligned cap) multiple-of-
    # sub caps and the hierarchical hub merge (see graph._assign_caps).
    net = net_max_width(algo)
    plan_L = L if net else None
    plans = [
        graph.merge_plan(0, L=plan_L, net_width=net),
        graph.merge_plan(1, L=plan_L, net_width=net),
    ]
    hub_sub = max((net - 1) // L, 1) if net else None
    dev_buckets = [device_plan(p, dev) for p in plans]
    damping_t = torch.tensor(damping, dtype=torch.float32, device=dev)

    basket = empty_baskets(n, L, dev)
    _set_dangling(
        basket,
        np.concatenate([plans[0].dangling_rows, plans[1].dangling_rows]),
        damping,
    )
    basket, _ = merge_sweep(
        None, dev_buckets[0] + dev_buckets[1], damping_t, L, algo,
        out_basket=basket, elem_budget=elem_budget, hub_sub=hub_sub,
    )

    compute_diff = tolerance >= 0
    # Per-partition maxDiff slots, initialised to the tolerance so each
    # partition gets at least one sweep (include/grank.h:87-92).
    max_diff = [tolerance, tolerance]
    active = 0
    i = 0
    while i < iterations and max(max_diff) >= tolerance:
        basket, d = merge_sweep(
            basket, dev_buckets[active], damping_t, L, algo,
            compute_diff=compute_diff, elem_budget=elem_budget,
            hub_sub=hub_sub,
        )
        max_diff[0] = float(d) if compute_diff else 0.0
        active = 1 - active
        max_diff[0], max_diff[1] = max_diff[1], max_diff[0]
        i += 1

    out = keep_top_chunked(basket.ids, basket.scores, K)
    if return_info:
        return out, {"iterations_ran": i}
    return out


def grank(
    graph: Graph,
    K: int,
    L: int,
    iterations: int,
    damping: float,
    tolerance: float,
    elem_budget: int = DEFAULT_ELEM_BUDGET,
    merge_algo: str | None = None,
    engine: str = "auto",
    matmul_dtype=None,
    exact_trunc: bool = False,
    device=None,
) -> Dict[Hashable, Dict[Hashable, float]]:
    """GRank with the reference's call signature and map-of-maps result
    (include/grank.h:42-48)."""
    return baskets_to_dict(
        grank_baskets(
            graph, K, L, iterations, damping, tolerance, elem_budget,
            merge_algo=merge_algo, engine=engine, matmul_dtype=matmul_dtype,
            exact_trunc=exact_trunc, device=device,
        ),
        graph,
    )


def grank_multi_baskets(
    graph: Graph,
    K: int,
    L: int,
    iterations: int,
    damping: float,
    tolerance: float,
    n_shards: int,
    elem_budget: int = DEFAULT_ELEM_BUDGET,
    merge_algo: str | None = None,
    devices=None,
    device=None,
):
    """Sharded GRank over ``n_shards`` shards, the successor of
    ``grankMulti`` (header-only/grankMulti.h:289-296): node ranges owned
    per shard, successor baskets passed around a ring, convergence by a
    global max.  The shards are ``devices`` if given, else the first
    ``n_shards`` cards, or ``n_shards`` shards on the CPU with
    ``device="cpu"`` (parallel/mesh.mesh_for)."""
    check_shards(n_shards)
    return grank_baskets(
        graph, K, L, iterations, damping, tolerance, elem_budget,
        merge_algo=merge_algo, mesh=mesh_for(n_shards, devices, device),
    )


def grank_multi(
    graph: Graph,
    K: int,
    L: int,
    iterations: int,
    damping: float,
    tolerance: float,
    n_shards: int,
    device=None,
) -> Dict[Hashable, Dict[Hashable, float]]:
    """grankMulti-shaped API (graph, K, L, iterations, damping, tolerance,
    parallelism degree) returning the reference's map-of-maps."""
    return baskets_to_dict(
        grank_multi_baskets(graph, K, L, iterations, damping, tolerance, n_shards,
                            device=device),
        graph,
    )
