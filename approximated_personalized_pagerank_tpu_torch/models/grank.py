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
partition's degree buckets (ops/merge.py).  The loop, its maxDiff slots and
its spans live once in ops/loop.py (``run_half_sweeps``); the engines supply
its half-sweep.  The sparse engine is this module's: on the card each
partition's half-sweep is one CUDA graph, captured at its first turn and
replayed after (``_SweepGraphs``).  Graphs up to 16,384 nodes take the
dense engine by default (ops/dense.py); with a ``mesh`` the run is the
ring-sharded one (parallel/ring.py).
"""

from __future__ import annotations

import contextlib
from typing import Dict, Hashable

import numpy as np
import torch

from ..graph import Graph
from ..ops.basket import Baskets, empty_baskets, keep_top_chunked
from ..ops.dense import dense_grank_run, use_dense_engine
from ..ops.loop import run_half_sweeps
from ..ops.merge import (
    DEFAULT_ELEM_BUDGET,
    device_plan,
    merge_sweep,
    plan_widths,
    resolve_merge_algo,
)
from ..ops.merge_kernel import capture_counts, load_library, replay_counts
from ..parallel.mesh import mesh_for
from ..parallel.ring import ring_grank_baskets
from ..utils.device import resolve_device
from ..utils.profiling import current, span
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
    mesh=None,
    host_loop: bool = False,
    merge_algo: str | None = None,
    engine: str = "auto",
    matmul_dtype=None,
    exact_trunc: bool = False,
    return_info: bool = False,
    device=None,
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

    With recording on (utils/profiling.py) the call is the span
    ``grank.job``, its count ``half_sweeps`` the half-sweeps run; inside it
    every engine opens a ``grank.half_sweep`` a half-sweep (ops/loop.py),
    and the sparse engine without a mesh its other parts (``_sparse_run``).
    """
    with span("grank.job") as job:
        out, info = _grank_run(
            graph, K, L, iterations, damping, tolerance, elem_budget, mesh,
            host_loop, merge_algo, engine, matmul_dtype, exact_trunc, device)
        if job:
            job.count("half_sweeps", info["iterations_ran"])
    return (out, info) if return_info else out


def _grank_run(graph, K, L, iterations, damping, tolerance, elem_budget, mesh,
               host_loop, merge_algo, engine, matmul_dtype, exact_trunc, device):
    """``grank_baskets``' run, always returning ``(baskets, info)``."""
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
        return empty_baskets(0, K, dev), {"iterations_ran": 0}
    if dense:
        return dense_grank_run(
            graph, K, L, iterations, damping, tolerance,
            matmul_dtype=matmul_dtype, exact_trunc=exact_trunc,
            return_info=True, device=dev,
        )
    if mesh is not None:
        return ring_grank_baskets(
            graph, K, L, iterations, damping, tolerance, mesh=mesh,
            elem_budget=elem_budget, merge_algo=algo, return_info=True,
        )
    return _sparse_run(graph, K, L, iterations, damping, tolerance, elem_budget,
                       algo, dev)


class _SweepGraphs:
    """GRank's half-sweeps on the card as CUDA graphs, one a partition.

    Two static baskets take turns: partition 0's graph reads ``bufs[0]``
    (the init sweep's basket) and writes ``bufs[1]``, partition 1's reads
    ``bufs[1]`` and writes ``bufs[0]``, so after ``i`` half-sweeps the
    newest basket is ``bufs[i % 2]``.  A graph's body is the eager
    half-sweep: the source copied into the destination (the eager loop's
    clone), then ``sweep(src, partition, dst)``, whose max diff tensor (the
    second of what it returns) is the graph's static output.  Each graph
    is captured at its partition's first half-sweep (span
    ``grank.graph_capture``) and replayed then and at every later turn of
    its partition.  Both capture on one side stream
    into one memory pool, so the second capture reuses the blocks the
    first one's temporaries freed.  A replay adds to the merge kernel's
    counters (launches, tied rows) what its capture noted, so they count
    what the card ran (``merge_kernel.capture_counts``), and adds 1 to the
    open span's ``graph_replays`` (the loop's ``grank.half_sweep``).  Nothing
    outlives the call: :meth:`release` drops the graphs, their outputs and
    the older basket, then the pool, whose memory goes back to the card.
    """

    def __init__(self, basket: Baskets, sweep):
        load_library()  # no build or load inside a capture
        self.bufs = (basket, Baskets(torch.empty_like(basket.ids),
                                     torch.empty_like(basket.scores)))
        self.sweep = sweep
        with torch.cuda.device(basket.ids.device):
            self.pool = torch.cuda.MemPool()
            self.stream = torch.cuda.Stream()
        self.graphs = [None, None]
        self.diffs = [None, None]
        self.rises = [None, None]

    def release(self) -> None:
        """Free everything but the newest basket, which the caller holds.
        The caller drops its own references to ``diffs`` first: a block
        still in use keeps its segment of the pool from the card."""
        self.graphs = self.diffs = self.bufs = None
        self.pool = None  # MemPool's destructor frees the pool's memory

    def run(self, p: int) -> torch.Tensor:
        """Partition ``p``'s half-sweep: capture at its first turn, then
        replay; returns its max diff (a 0-d tensor, the graph's output)."""
        if self.graphs[p] is None:
            with span("grank.graph_capture"):
                self._capture(p)
        self.graphs[p].replay()
        replay_counts(self.rises[p])
        current().count("graph_replays")
        return self.diffs[p]

    def _capture(self, p: int) -> None:
        src, dst = self.bufs[p], self.bufs[1 - p]
        graph = torch.cuda.CUDAGraph()
        with capture_counts(src.ids.device) as rise:
            self.stream.wait_stream(torch.cuda.current_stream(src.ids.device))
            with torch.cuda.stream(self.stream):
                graph.capture_begin(pool=self.pool.id)
                try:
                    dst.ids.copy_(src.ids)
                    dst.scores.copy_(src.scores)
                    _, self.diffs[p] = self.sweep(src, p, dst)
                except BaseException:
                    with contextlib.suppress(RuntimeError):
                        graph.capture_end()
                    raise
                graph.capture_end()
        self.graphs[p] = graph
        self.rises[p] = rise


def _sparse_run(graph, K, L, iterations, damping, tolerance, elem_budget, algo, dev):
    """The sparse engine on one device.  Its spans: ``grank.upload`` (the
    plans, the damping scalar, the empty baskets and the dangling rows;
    count ``bytes``, what crosses from host to device), ``grank.init_sweep``,
    the loop's (ops/loop.py) and at each partition's first turn on the card
    ``grank.graph_capture``.  The final cut is the job's own.

    On the card the half-sweeps replay CUDA graphs (``_SweepGraphs``),
    bitwise the eager loop's baskets, with its counts; on the CPU the loop
    is eager."""
    n = graph.num_nodes
    with span("grank.upload") as upload:
        plan_L, net, hub_sub = plan_widths(L, algo)
        plans = [
            graph.merge_plan(0, L=plan_L, net_width=net),
            graph.merge_plan(1, L=plan_L, net_width=net),
        ]
        dev_buckets = [device_plan(p, dev) for p in plans]
        damping_t = torch.tensor(damping, dtype=torch.float32, device=dev)

        basket = empty_baskets(n, L, dev)
        dangling = np.concatenate([plans[0].dangling_rows, plans[1].dangling_rows])
        _set_dangling(basket, dangling, damping)
        if upload:
            upload.count("bytes", damping_t.nbytes + 8 * dangling.size + sum(
                b.rows.nbytes + b.succ.nbytes for part in dev_buckets for b in part))
    with span("grank.init_sweep"):
        basket, _ = merge_sweep(
            None, dev_buckets[0] + dev_buckets[1], damping_t, L, algo,
            out_basket=basket, elem_budget=elem_budget, hub_sub=hub_sub,
        )

    compute_diff = tolerance >= 0

    def sweep(src, p, dst=None):
        return merge_sweep(
            src, dev_buckets[p], damping_t, L, algo, compute_diff=compute_diff,
            out_basket=dst, elem_budget=elem_budget, hub_sub=hub_sub,
        )

    def step(p):
        nonlocal basket
        if graphs is not None:
            d = graphs.run(p)
        else:
            basket, d = sweep(basket, p)
        return d if compute_diff else None

    graphs = None
    if dev.type == "cuda" and iterations > 0:
        graphs = _SweepGraphs(basket, sweep)
    try:
        i = run_half_sweeps(step, iterations, tolerance)
        if graphs is not None:
            basket = graphs.bufs[i % 2]
    finally:
        if graphs is not None:
            graphs.release()

    return keep_top_chunked(basket.ids, basket.scores, K), {"iterations_ran": i}


def grank(
    graph: Graph,
    K: int,
    L: int,
    iterations: int,
    damping: float,
    tolerance: float,
    elem_budget: int = DEFAULT_ELEM_BUDGET,
    engine: str = "auto",
    matmul_dtype=None,
    exact_trunc: bool = False,
    merge_algo: str | None = None,
    device=None,
) -> Dict[Hashable, Dict[Hashable, float]]:
    """GRank with the reference's call signature and map-of-maps result
    (include/grank.h:42-48)."""
    return baskets_to_dict(
        grank_baskets(
            graph, K, L, iterations, damping, tolerance,
            elem_budget=elem_budget, merge_algo=merge_algo, engine=engine, matmul_dtype=matmul_dtype,
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
        graph, K, L, iterations, damping, tolerance, elem_budget=elem_budget,
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
