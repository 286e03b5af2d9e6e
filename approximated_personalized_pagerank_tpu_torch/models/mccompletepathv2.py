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
nodes), with R walks per node as in the reference.  The pipeline, the
walks then the combine, is written once (``_mc_run``); the sparse engine,
the dense engine and the ring (parallel/ring.py) supply the combine.

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
from ..ops.dense import MC_DENSE_MAX_NODES, dense_mc_combine, use_dense_engine
from ..ops.merge import (
    DEFAULT_ELEM_BUDGET,
    count_routes,
    device_plan,
    merge_sweep,
    plan_widths,
    resolve_merge_algo,
)
from ..ops.merge_kernel import launch_count
from ..ops.walk import walk_rows
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

    With recording on (utils/profiling.py) the call is the span ``mc.job``,
    with ``mc.walks`` and then ``mc.combine`` (count ``passes``: the
    engine's combine, the final cut to K included) inside it on every
    engine; on the sparse engine ``mc.combine`` holds a ``mc.combine_pass``
    a pass and then ``mc.final_cut`` (``_sparse_mc_combine``).
    """
    with span("mc.job"):
        return _mc_run(graph, K, L, iterations, damping, seed, combine_passes,
                       elem_budget, merge_algo, engine, matmul_dtype, return_info,
                       mesh, successor_choice, device)


def _mc_run(graph, K, L, iterations, damping, seed, combine_passes, elem_budget,
            merge_algo, engine, matmul_dtype, return_info, mesh, successor_choice,
            device):
    """``mccompletepathv2_baskets``' run: the walks-then-combine pipeline,
    written once; the engine supplies the combine."""
    check_basket_params(K, L)
    check_iterations(iterations)
    check_damping(damping)
    check_combine_passes(combine_passes)
    check_successor_choice(successor_choice)
    dev = resolve_device(device) if mesh is None else mesh.devices[0]
    algo = resolve_merge_algo(merge_algo, dev)

    n = graph.num_nodes
    if n == 0:
        out = empty_baskets(0, K, dev)
        return (out, {"walk_steps": 0}) if return_info else out
    dense = mesh is None and use_dense_engine(n, engine, max_nodes=MC_DENSE_MAX_NODES)
    if dense:
        L = min(L, n)
    with span("mc.walks"):
        walk, read_info = walk_rows(
            graph, L, iterations, damping, seed, None, None, None, "trace", mesh,
            successor_choice == "stratified", algo, dev,
        )
    with span("mc.combine") as s:
        s.count("passes", combine_passes)
        if mesh is not None:
            out = ring_mc_combine(graph, walk, K, L, damping, combine_passes, mesh=mesh,
                                  elem_budget=elem_budget, merge_algo=algo)
        elif dense:
            out = dense_mc_combine(graph, walk, K, L, damping, combine_passes,
                                   matmul_dtype, dev)
        else:
            out = _sparse_mc_combine(graph, walk, K, L, damping, combine_passes,
                                     elem_budget, algo, dev)
    return (out, read_info()) if return_info else out


def _sparse_mc_combine(graph, walk, K, L, damping, combine_passes, elem_budget, algo,
                       dev):
    """The sparse engine's combine: ``combine_passes`` merge sweeps over every
    node (``mode="mc_combine"``), then the cut to K.  With recording on each
    pass is the span ``mc.combine_pass`` (counts ``buckets``, the rows each
    route merges, ``hub_rows`` / ``gather_rows`` / ``sort_rows``
    (ops/merge.py::count_routes; together the nodes with successors), and
    ``merge_launches``, the merge kernel's launches) and the cut
    ``mc.final_cut``."""
    plan_L, net, hub_sub = plan_widths(L, algo)
    buckets = device_plan(graph.merge_plan(None, L=plan_L, net_width=net), dev)
    damping_t = torch.tensor(damping, dtype=torch.float32, device=dev)
    # each pass reads the previous baskets and writes a copy; dangling nodes
    # are in no bucket and keep their walk basket {v: 1.0}
    # (mccompletepathv2.h:213-214: factor 1, no successor contributions)
    for _ in range(combine_passes):
        with span("mc.combine_pass") as s:
            if s:
                launches = launch_count()
                s.count("buckets", len(buckets))
                count_routes(s, buckets, walk.width, algo, hub_sub)
            walk, _ = merge_sweep(
                walk, buckets, damping_t, L, algo, mode="mc_combine",
                elem_budget=elem_budget, hub_sub=hub_sub,
            )
            if s:
                s.count("merge_launches", launch_count() - launches)
    with span("mc.final_cut"):
        return keep_top_chunked(walk.ids, walk.scores, K)


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
