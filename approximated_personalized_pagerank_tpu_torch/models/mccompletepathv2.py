"""MCCompletePathV2: all-sources top-K PPR from shared Monte-Carlo walks.

Reference: ``ppr::mccompletepathv2`` (include/mccompletepathv2.h:182-258).
The reference walks nodes lazily in a heuristic execution order
(mccompletepathv2.h:36-113) so that a node's combine step
(``map = {v: 1/factor} + sum of successors' baskets; keepTop(L); *factor``,
mccompletepathv2.h:211-250) can reuse its successors' results.  Here, as in
the JAX package, every source walks at once (ops/walk.py) and the combine
is a batched merge sweep over all nodes (``merge_sweep(mode="mc_combine")``,
the sparse engine) or a matrix product over an ``[N, N]`` count matrix (the
dense engine, ops/dense.py, which ``engine="auto"`` picks up to 32,768
nodes), with R walks per node as in the reference.

``combine_passes`` repeats the combine on the previous pass's baskets: the
parallel analogue of the reference's propagation of already-combined
successor results along its execution order (mccompletepathv2.h:230-234).

Deliberate divergences, those of the JAX package:

* uniform random successor choice instead of the serial rotating index
  (``successor_choice="stratified"`` recovers its effect on the first hop);
* no in-walk L cap: full counts are kept, then truncated
  (mccompletepathv2.h:152-153 drops visits);
* results are deterministic given ``seed`` (the reference's mt19937 is
  seeded from entropy, mccompletepathv2.h:32-34).
"""

from __future__ import annotations

from typing import Dict, Hashable

import torch

from ..graph import Graph
from ..ops.basket import empty_baskets, keep_top_chunked
from ..ops.dense import MC_DENSE_MAX_NODES, dense_mc_run, use_dense_engine
from ..ops.merge import (
    DEFAULT_ELEM_BUDGET,
    device_plan,
    merge_sweep,
    net_max_width,
    resolve_merge_algo,
)
from ..ops.walk import walk_baskets
from ..parallel.mesh import mesh_for
from ..parallel.ring import ring_mc_combine
from ..utils.device import resolve_device
from ..utils.profiling import span
from ..utils.validation import (
    check_basket_params,
    check_combine_passes,
    check_damping,
    check_iterations,
    check_shards,
    check_successor_choice,
)
from .common import baskets_to_dict


def mccompletepathv2_baskets(
    graph: Graph,
    K: int,
    L: int,
    iterations: int,
    damping: float,
    seed: int | None = None,
    combine_passes: int = 2,
    elem_budget: int = DEFAULT_ELEM_BUDGET,
    merge_algo: str | None = None,
    engine: str = "auto",
    matmul_dtype=None,
    return_info: bool = False,
    mesh=None,
    successor_choice: str = "uniform",
    device=None,
):
    """MCCompletePathV2 returning ``[N, K]`` baskets over internal ids.

    ``iterations`` is R, the Monte-Carlo walks per node in the worst case
    (include/mccompletepathv2.h:186).  ``successor_choice="stratified"``
    spaces a source's first hops evenly over its successors (see
    ops/walk._cohort_hop).  ``merge_algo`` (``"sort"`` or ``"kernel"``,
    optionally ``":<cap>"``; None: the kernel on CUDA, the sort pipeline on
    the CPU) runs both the walks' trace top-L and the combine.
    ``return_info=True`` returns ``(baskets, info)`` with the walks' counters
    (ops/walk.walk_baskets).  ``device``: None means ``"cuda"``, which
    raises without a card; pass ``"cpu"`` for the CPU.

    ``engine``: ``"sparse"`` combines through the merge pipeline,
    ``"dense"`` keeps the walk counts in an ``[N, N]`` matrix and combines
    with matrix products (ops/dense.py; ``matmul_dtype`` is their input
    dtype, bfloat16 on the card by default), ``"auto"`` picks dense up to
    ``PPR_MC_DENSE_MAX_NODES`` (32,768) nodes, Eat included, as the JAX
    package does.

    ``mesh`` (parallel/mesh.py, one process) shards the run whatever
    ``engine`` says: the walks split each source chunk across the shards
    (bitwise the unsharded walks at the same chunk size), the combine is
    the ring's exact merge (``ring_mc_combine``); ``device`` is the mesh's.

    With recording on (utils/profiling.py) the call is the span ``mc.job``;
    the sparse engine without a mesh opens ``mc.walks`` and ``mc.combine``
    (the plan's upload and the passes) inside it.
    """
    with span("mc.job"):
        return _mc_run(graph, K, L, iterations, damping, seed, combine_passes,
                       elem_budget, merge_algo, engine, matmul_dtype, return_info,
                       mesh, successor_choice, device)


def _mc_run(graph, K, L, iterations, damping, seed, combine_passes, elem_budget,
            merge_algo, engine, matmul_dtype, return_info, mesh, successor_choice,
            device):
    """``mccompletepathv2_baskets``' run."""
    check_basket_params(K, L)
    check_iterations(iterations)
    check_damping(damping)
    check_combine_passes(combine_passes)
    check_successor_choice(successor_choice)
    dev = resolve_device(device) if mesh is None else mesh.devices[0]
    algo = resolve_merge_algo(merge_algo, dev)
    stratified = successor_choice == "stratified"

    n = graph.num_nodes
    if n == 0:
        out = empty_baskets(0, K, dev)
        return (out, {"walk_steps": 0}) if return_info else out
    if mesh is not None:
        basket = walk_baskets(
            graph, L, iterations, damping, seed=seed, return_info=return_info,
            stratified=stratified, merge_algo=algo, mesh=mesh,
        )
        info = None
        if return_info:
            basket, info = basket
        out = ring_mc_combine(
            graph, basket, K, L, damping, combine_passes, mesh=mesh,
            elem_budget=elem_budget, merge_algo=algo,
        )
        return (out, info) if return_info else out

    dense = use_dense_engine(n, engine, max_nodes=MC_DENSE_MAX_NODES)
    if dense:
        return dense_mc_run(
            graph, K, L, iterations, damping, seed=seed,
            combine_passes=combine_passes, matmul_dtype=matmul_dtype,
            return_info=return_info, stratified=stratified, merge_algo=algo,
            device=dev,
        )

    with span("mc.walks"):
        basket = walk_baskets(
            graph, L, iterations, damping, seed=seed, return_info=return_info,
            stratified=stratified, merge_algo=algo, device=dev,
        )
    info = None
    if return_info:
        basket, info = basket
    with span("mc.combine"):
        net = net_max_width(algo)
        plan = graph.merge_plan(None, L=L if net else None, net_width=net)
        hub_sub = max((net - 1) // L, 1) if net else None
        buckets = device_plan(plan, dev)
        damping_t = torch.tensor(damping, dtype=torch.float32, device=dev)
        # each pass reads the previous baskets and writes a copy (dangling
        # rows keep their walk basket)
        for _ in range(combine_passes):
            basket, _ = merge_sweep(
                basket, buckets, damping_t, L, algo, mode="mc_combine",
                elem_budget=elem_budget, hub_sub=hub_sub,
            )
    # dangling nodes keep their walk basket {v: 1.0}
    # (mccompletepathv2.h:213-214: factor 1, no successor contributions)
    out = keep_top_chunked(basket.ids, basket.scores, K)
    return (out, info) if return_info else out


def mccompletepathv2_multi_baskets(
    graph: Graph,
    K: int,
    L: int,
    iterations: int,
    damping: float,
    n_shards: int,
    seed: int | None = None,
    combine_passes: int = 2,
    elem_budget: int = DEFAULT_ELEM_BUDGET,
    merge_algo: str | None = None,
    devices=None,
    device=None,
):
    """Sharded MCCompletePathV2 over ``n_shards`` shards (chosen as in
    ``grank_multi_baskets``): source-sharded walks and the exact ring
    combine.  The reference parallelizes only GRank
    (header-only/grankMulti.h); this extends its node-range data
    parallelism to the Monte-Carlo algorithm."""
    check_shards(n_shards)
    return mccompletepathv2_baskets(
        graph, K, L, iterations, damping, seed=seed,
        combine_passes=combine_passes, elem_budget=elem_budget,
        merge_algo=merge_algo, mesh=mesh_for(n_shards, devices, device),
    )


def mccompletepathv2_multi(
    graph: Graph,
    K: int,
    L: int,
    iterations: int,
    damping: float,
    n_shards: int,
    seed: int | None = None,
    combine_passes: int = 2,
    device=None,
) -> Dict[Hashable, Dict[Hashable, float]]:
    """grankMulti-shaped sharded MC API returning the reference's
    map-of-maps."""
    return baskets_to_dict(
        mccompletepathv2_multi_baskets(
            graph, K, L, iterations, damping, n_shards, seed=seed,
            combine_passes=combine_passes, device=device,
        ),
        graph,
    )


def mccompletepathv2(
    graph: Graph,
    K: int,
    L: int,
    iterations: int,
    damping: float,
    seed: int | None = None,
    combine_passes: int = 2,
    engine: str = "auto",
    matmul_dtype=None,
    device=None,
) -> Dict[Hashable, Dict[Hashable, float]]:
    """MCCompletePathV2 with the reference call signature and map-of-maps
    result (include/mccompletepathv2.h:182-187)."""
    return baskets_to_dict(
        mccompletepathv2_baskets(
            graph, K, L, iterations, damping, seed=seed,
            combine_passes=combine_passes, engine=engine,
            matmul_dtype=matmul_dtype, device=device,
        ),
        graph,
    )
