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
its half-sweep.  The sparse engine is this module's: on the card the init
sweep and each partition's half-sweep are one CUDA graph each, captured at
their first turn and replayed after, kept on the ``Graph`` for later calls
(``_SweepGraphs``).
Graphs up to 16,384 nodes take the dense engine by default (ops/dense.py);
with a ``mesh`` the run is the ring-sharded one (parallel/ring.py).
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Hashable

import numpy as np
import torch

from ..graph import Graph
from ..ops.basket import SENTINEL, Baskets, empty_baskets, keep_top_chunked
from ..ops.dense import dense_grank_run, use_dense_engine
from ..ops.loop import run_half_sweeps
from ..ops.merge import (
    DEFAULT_ELEM_BUDGET,
    count_routes,
    device_plan,
    merge_sweep,
    plan_widths,
    resolve_merge_algo,
)
from ..ops.merge_kernel import capture_counts, load_library, replay_counts, tie_counting
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


def _set_dangling(basket: Baskets, rows, damping: float) -> Baskets:
    """Dangling nodes' baskets are exactly {v: 1-damping}, forever (in place).
    ``rows``: a host array, or an int64 tensor on the baskets' device."""
    if len(rows) == 0:
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


def _plans(graph: Graph, L: int, algo: str, dev: torch.device) -> tuple:
    """The sparse engine's upload: both partitions' merge plans on ``dev``
    (``device_plan``), the dangling rows (a host array) and ``hub_sub``."""
    plan_L, net, hub_sub = plan_widths(L, algo)
    plans = [graph.merge_plan(p, L=plan_L, net_width=net) for p in (0, 1)]
    dangling = np.concatenate([plans[0].dangling_rows, plans[1].dangling_rows])
    return [device_plan(p, dev) for p in plans], dangling, hub_sub


def _plan_bytes(dev_buckets) -> int:
    return sum(b.rows.nbytes + b.succ.nbytes for part in dev_buckets for b in part)


def _sweep_key(dev: torch.device, L: int, algo: str, elem_budget: int,
               compute_diff: bool) -> tuple:
    """What a call's captured half-sweeps depend on, beside the graph: the
    device, the basket width, the resolved merge pipeline, the element
    budget and whether the diff is computed (``tolerance >= 0``); and
    whether and into which counters the kernel counts tied rows
    (``merge_kernel.tie_counting``).  ``iterations``, ``K`` and ``damping``
    are not in it: the loop, the final cut and the damping tensor's value
    are the call's own."""
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev, L, algo, elem_budget, compute_diff, tie_counting()


class _SweepGraphs:
    """The sparse engine's state on the card, kept on its ``Graph``
    (``Graph._sweep_graphs``) between calls of one :func:`_sweep_key`: the
    device plans, the dangling rows, the damping tensor the graphs read,
    two static baskets, and three CUDA graphs: the init sweep and each
    partition's half-sweep.

    Two static baskets take turns: the init sweep writes ``bufs[0]``,
    partition 0's graph reads ``bufs[0]`` and writes ``bufs[1]``, partition
    1's reads ``bufs[1]`` and writes ``bufs[0]``, so after ``i`` half-sweeps
    the newest basket is ``bufs[i % 2]``.  A graph's body is the eager
    sweep: for the init sweep :meth:`init_merge`; for a half-sweep the
    source copied into the destination (the eager loop's clone), then
    :meth:`sweep`, whose max diff tensor (the second of what it returns) is
    the graph's static output.  Each graph is captured at its first turn
    under this state (span ``grank.graph_capture``) and replayed then and at
    every later turn, in this call and the later ones.  All three capture
    on one side stream into one memory pool, the init sweep first, so each
    later capture reuses the blocks the earlier ones' temporaries freed.  A
    replay adds to the merge kernel's counters (launches, tied rows) what
    its capture noted, so they count what the card ran
    (``merge_kernel.capture_counts``), and adds 1 to the open span's
    ``graph_replays`` (``grank.init_sweep``, or the loop's
    ``grank.half_sweep``).

    Every call starts from :meth:`reset` and runs every sweep: graphs are
    kept, results never.  :meth:`release` (``Graph.release_device_state``,
    a call of another key, a call that raised, or the collection of the
    ``Graph``) drops the graphs, their outputs and the baskets, then the
    pool, whose memory goes back to the card; a pool is not reused for new
    captures.
    """

    def __init__(self, graph: Graph, key: tuple, L: int, algo: str, elem_budget: int,
                 compute_diff: bool, dev: torch.device):
        load_library()  # no build or load inside a capture
        self.key = key
        self.L, self.algo, self.elem_budget = L, algo, elem_budget
        self.compute_diff = compute_diff
        self.dev_buckets, dangling, self.hub_sub = _plans(graph, L, algo, dev)
        self.dangling = torch.as_tensor(dangling, dtype=torch.int64).to(dev)
        self.damping = torch.empty((), dtype=torch.float32, device=dev)
        self.upload_bytes = (self.damping.nbytes + self.dangling.nbytes
                             + _plan_bytes(self.dev_buckets))
        n = graph.num_nodes
        self.graphs, self.rises = {}, {}  # by "init", 0, 1
        self.diffs = [None, None]
        self.bufs = (empty_baskets(n, L, dev), empty_baskets(n, L, dev))
        with torch.cuda.device(dev):
            self.pool = torch.cuda.MemPool()
            self.stream = torch.cuda.Stream()
            self.done = torch.cuda.Event()

    def release(self) -> None:
        """Free the graphs, the baskets and the pool.  No reference to
        ``diffs`` may be held: a block still in use keeps its segment of
        the pool from the card."""
        self.graphs = self.diffs = self.bufs = None
        self.pool = None  # MemPool's destructor frees the pool's memory

    __del__ = release  # the graphs go before their pool

    def reset(self, damping: float) -> None:
        """``bufs[0]`` back to the empty basket with the dangling rows
        (after the previous call's last read of it, on any stream), and the
        damping tensor set to ``damping``: a fresh call's start."""
        torch.cuda.current_stream(self.damping.device).wait_event(self.done)
        ids, scores = self.bufs[0]
        ids.fill_(SENTINEL)
        scores.zero_()
        self.damping.fill_(damping)
        _set_dangling(self.bufs[0], self.dangling, damping)

    def init_sweep(self) -> None:
        """The init sweep into ``bufs[0]``: its graph's replay."""
        self._replay("init", self.init_merge)

    def init_merge(self) -> None:
        """The init sweep's body: both partitions merged into ``bufs[0]``."""
        merge_sweep(
            None, self.dev_buckets[0] + self.dev_buckets[1], self.damping, self.L,
            self.algo, out_basket=self.bufs[0], elem_budget=self.elem_budget,
            hub_sub=self.hub_sub,
        )

    def sweep(self, src: Baskets, p: int, dst: Baskets) -> tuple:
        return merge_sweep(
            src, self.dev_buckets[p], self.damping, self.L, self.algo,
            compute_diff=self.compute_diff, out_basket=dst,
            elem_budget=self.elem_budget, hub_sub=self.hub_sub,
        )

    def run(self, p: int) -> torch.Tensor | None:
        """Partition ``p``'s half-sweep: its graph's replay; returns its max
        diff (a 0-d tensor, the graph's output), or None where none is
        computed."""
        self._replay(p, lambda: self._half_sweep(p))
        count_routes(current(), self.dev_buckets[p], self.L, self.algo, self.hub_sub)
        return self.diffs[p] if self.compute_diff else None

    def kept_bytes(self) -> int:
        """The bytes this state holds on the card: the upload (plans,
        dangling rows, damping), the two baskets and the segments of its
        memory pool (the graphs' temporaries and outputs).  Read from the
        caching allocator's host-side snapshot: no device work."""
        pool = tuple(self.pool.id)
        segments = sum(s["total_size"] for s in torch.cuda.memory_snapshot()
                       if tuple(s.get("segment_pool_id", ())) == pool)
        baskets = sum(t.nbytes for b in self.bufs for t in b)
        return self.upload_bytes + baskets + segments

    def cut(self, i: int, K: int) -> Baskets:
        """The top ``K`` of the newest basket after ``i`` half-sweeps, as
        new tensors; the next call's reset waits for this read."""
        newest = self.bufs[i % 2]
        out = keep_top_chunked(newest.ids, newest.scores, K)
        self.done.record(torch.cuda.current_stream(newest.ids.device))
        return out

    def _half_sweep(self, p: int) -> None:
        src, dst = self.bufs[p], self.bufs[1 - p]
        dst.ids.copy_(src.ids)
        dst.scores.copy_(src.scores)
        _, self.diffs[p] = self.sweep(src, p, dst)

    def _replay(self, name: str | int, body: Callable[[], None]) -> None:
        """Replay graph ``name``, captured from ``body`` at its first turn."""
        if name not in self.graphs:
            with span("grank.graph_capture"):
                self._capture(name, body)
        self.graphs[name].replay()
        replay_counts(self.rises[name])
        current().count("graph_replays")

    def _capture(self, name: str | int, body: Callable[[], None]) -> None:
        dev = self.damping.device
        graph = torch.cuda.CUDAGraph()
        with capture_counts(dev) as rise:
            self.stream.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(self.stream):
                graph.capture_begin(pool=self.pool.id)
                try:
                    body()
                except BaseException:
                    with contextlib.suppress(RuntimeError):
                        graph.capture_end()
                    raise
                graph.capture_end()
        self.graphs[name], self.rises[name] = graph, rise


def _sparse_run(graph, K, L, iterations, damping, tolerance, elem_budget, algo, dev):
    """The sparse engine on one device.  Its spans: ``grank.upload`` (the
    plans, the damping scalar, the empty baskets and the dangling rows;
    count ``bytes``, what crosses from host to device), ``grank.init_sweep``
    (count ``graph_replays``, 1 where it replayed a graph, 0 where eager),
    the loop's (ops/loop.py), each ``grank.half_sweep`` also counting the
    swept partition's rows by route (``hub_rows``, ``gather_rows``,
    ``sort_rows``: ops/merge.py::count_routes, from the plan), and on the
    card, inside the init sweep and each partition's first half-sweep under
    a new state, ``grank.graph_capture``.  The final cut is the job's own.

    On the card the init sweep and the half-sweeps replay CUDA graphs
    (``_SweepGraphs``), bitwise the eager loop's baskets, with its counts.
    That state is kept on ``graph`` for the next call of the same
    :func:`_sweep_key`, whose upload is then the reset of the first basket;
    the job's count ``sweep_graphs_reused`` is 1 where the call found it, 0
    where it made it, and its count ``kept_bytes`` what the state holds on
    the card after the call (:meth:`_SweepGraphs.kept_bytes`).  A call holds
    ``graph``'s lock throughout.  On the CPU the loop is eager and keeps
    nothing."""
    if dev.type != "cuda":
        return _eager_run(graph, K, L, iterations, damping, tolerance, elem_budget,
                          algo, dev)
    compute_diff = tolerance >= 0
    key = _sweep_key(dev, L, algo, elem_budget, compute_diff)
    with graph._sweep_lock:
        kept, graph._sweep_graphs = graph._sweep_graphs, None
        reused = kept is not None and kept.key == key
        current().count("sweep_graphs_reused", int(reused))
        try:
            with span("grank.upload") as upload:
                if not reused:
                    if kept is not None:
                        kept.release()
                    kept = _SweepGraphs(graph, key, L, algo, elem_budget, compute_diff,
                                        dev)
                kept.reset(damping)
                upload.count("bytes", 0 if reused else kept.upload_bytes)
            with span("grank.init_sweep") as init:
                init.count("graph_replays", 0)
                kept.init_sweep()
            i = run_half_sweeps(kept.run, iterations, tolerance)
            out = kept.cut(i, K)
        except BaseException:
            if kept is not None:
                kept.release()  # a call that raised, a capture among them, keeps nothing
            raise
        graph._sweep_graphs = kept
        job = current()
        if job:
            job.count("kept_bytes", kept.kept_bytes())
    return out, {"iterations_ran": i}


def _eager_run(graph, K, L, iterations, damping, tolerance, elem_budget, algo, dev):
    """``_sparse_run``'s eager loop: a basket set made at each half-sweep."""
    with span("grank.upload") as upload:
        dev_buckets, dangling, hub_sub = _plans(graph, L, algo, dev)
        damping_t = torch.tensor(damping, dtype=torch.float32, device=dev)
        basket = _set_dangling(empty_baskets(graph.num_nodes, L, dev), dangling, damping)
        if upload:
            upload.count("bytes", damping_t.nbytes + 8 * dangling.size
                         + _plan_bytes(dev_buckets))
    with span("grank.init_sweep") as init:
        init.count("graph_replays", 0)
        basket, _ = merge_sweep(
            None, dev_buckets[0] + dev_buckets[1], damping_t, L, algo,
            out_basket=basket, elem_budget=elem_budget, hub_sub=hub_sub,
        )

    compute_diff = tolerance >= 0

    def step(p):
        nonlocal basket
        basket, d = merge_sweep(
            basket, dev_buckets[p], damping_t, L, algo, compute_diff=compute_diff,
            elem_budget=elem_budget, hub_sub=hub_sub,
        )
        count_routes(current(), dev_buckets[p], L, algo, hub_sub)
        return d if compute_diff else None

    i = run_half_sweeps(step, iterations, tolerance)
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
