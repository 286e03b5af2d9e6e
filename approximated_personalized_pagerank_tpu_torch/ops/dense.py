"""Dense engine for GRank and MCCompletePathV2: the half-sweep as one matrix product.

The port of the JAX package's ``ops/dense.py``.  For graphs whose
``[N, N]`` score matrix fits the card, one GRank half-sweep over partition
``p`` (reference include/grank.h:96-126) is

    S[p, :]  <-  trunc_L( (1 - d) * I[p, :]  +  W[p, :] @ S )

where ``W[v, s] = damping / outdeg(v) * multiplicity(v -> s)`` (a zero row
for a dangling node keeps the reference's mass loss, include/grank.h:
100-101) and ``trunc_L`` zeroes every row entry below the row's L-th
largest score (``keepTop``, include/internal/pprInternal.h:110-137).

* The product runs on the card in bfloat16 with float32 accumulation and a
  float32 result (``torch.mm(..., out_dtype=torch.float32)``), so the self
  entry, the truncation and the diff see float32, as in the JAX package
  (``preferred_element_type=float32``).  The JAX package left this product
  to XLA, outside its one Pallas kernel; the port leaves it to torch.  On
  the CPU the default is float32 throughout.
* ``S`` is stored in the matmul dtype between half-sweeps (bf16 on the
  card): the product reads it directly, at half the bytes.
* Truncation is exact: ``exact_trunc=True`` keeps exactly L entries a row,
  equal values at the cut by lowest column (``jax.lax.top_k``'s order,
  which ``torch.topk`` does not promise on CUDA); ``exact_trunc=False``
  keeps every entry at or above the row's L-th value, ties included.  The
  JAX package finds that threshold with ``approx_max_k``, a TPU reduce that
  equals the exact top-k off the TPU; the port takes the exact value, so
  it has no ``recall`` target.  MC's combine always takes the threshold
  cut.

Nodes are renumbered so that each 2-colouring partition is a contiguous
row range; ``perm`` maps the partition order back to node ids.  This
module is an engine: it supplies GRank's half-sweep to the one main loop
(ops/loop.py) and MC's combine to the one walks-then-combine pipeline
(models/mccompletepathv2.py), which own the reference's control.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..utils.device import resolve_device
from .basket import SENTINEL, Baskets
from .loop import run_half_sweeps

__all__ = [
    "DensePlan",
    "build_dense_plan",
    "dense_grank_run",
    "dense_mc_combine",
    "default_matmul_dtype",
    "use_dense_engine",
]

# Auto-engine cutoffs, the JAX package's, so that both packages run the
# same engine on the same graph.  GRank takes the dense engine up to
# DENSE_MAX_NODES nodes, MC (2 combine passes, not 30 half-sweeps) up to
# MC_DENSE_MAX_NODES.  They were set from the TPU's crossover; the card's
# is measured at one size only (chip_smoke.py phase 6d, PERF.md).
DENSE_MAX_NODES = int(os.environ.get("PPR_DENSE_MAX_NODES", "16384"))
MC_DENSE_MAX_NODES = int(os.environ.get("PPR_MC_DENSE_MAX_NODES", "32768"))

_LANE = 128
# The truncation and the final top-K run over row chunks of at most this
# many elements: it bounds their masks, counters and float32 copies.
TRUNC_ELEMS = 1 << 26


def use_dense_engine(
    num_nodes: int, engine: str, max_nodes: int | None = None, *, mesh=None
) -> bool:
    """Resolve ``engine`` ("auto" | "sparse" | "dense"): "auto" is dense
    for ``0 < num_nodes <= max_nodes`` (default ``DENSE_MAX_NODES``;
    MCCompletePathV2 passes ``MC_DENSE_MAX_NODES``) unless a ``mesh`` is
    given: the sharded runs are sparse."""
    if engine == "dense":
        return True
    if engine == "sparse" or mesh is not None:
        return False
    if engine != "auto":
        raise ValueError(f"unknown engine {engine!r}")
    return 0 < num_nodes <= (DENSE_MAX_NODES if max_nodes is None else max_nodes)


def default_matmul_dtype(device) -> torch.dtype:
    """bfloat16 on the card (float32 accumulation), float32 on the CPU."""
    return torch.bfloat16 if torch.device(device).type == "cuda" else torch.float32


class DensePlan(NamedTuple):
    """Host-side prep: partition-contiguous renumbering + per-partition edges.

    ``perm`` maps new (partition-ordered) ids to original internal ids;
    edge arrays are in the renumbered space with rows local to the partition
    (row, col, weight), where the weight includes damping/outdeg and
    parallel edges stay separate (the scatter-add accumulates them,
    include/grank.h:79-80).
    """

    n: int
    n0: int
    n1: int
    n_pad: int
    perm: np.ndarray  # int32[n]   new id -> old id
    edges0: Tuple[np.ndarray, np.ndarray, np.ndarray]  # rows, cols, weights
    edges1: Tuple[np.ndarray, np.ndarray, np.ndarray]


def _padded(n: int) -> int:
    return max(_LANE, -(-n // _LANE) * _LANE)


def build_dense_plan(graph, damping: float) -> DensePlan:
    n = graph.num_nodes
    part = graph.partition
    perm = np.argsort(part, kind="stable").astype(np.int32)  # new -> old
    inv = np.empty(n, dtype=np.int32)
    inv[perm] = np.arange(n, dtype=np.int32)  # old -> new
    n0 = int((part == 0).sum())

    deg = graph.out_degree.astype(np.int64)
    src_old = np.repeat(np.arange(n, dtype=np.int64), deg)
    dst_old = graph.indices.astype(np.int64)
    src_new = inv[src_old]
    dst_new = inv[dst_old]
    w = (damping / np.maximum(deg, 1).astype(np.float64))[src_old].astype(
        np.float32
    )
    in0 = src_new < n0
    edges0 = (
        src_new[in0].astype(np.int32),
        dst_new[in0].astype(np.int32),
        w[in0],
    )
    edges1 = (
        (src_new[~in0] - n0).astype(np.int32),
        dst_new[~in0].astype(np.int32),
        w[~in0],
    )
    return DensePlan(
        n=n, n0=n0, n1=n - n0, n_pad=_padded(n), perm=perm, edges0=edges0,
        edges1=edges1,
    )


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` accumulated and returned in float32."""
    if a.dtype == torch.float32:
        return torch.mm(a, b)
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    # The CPU has no kernel for mm with an out_dtype.  A bf16 or fp16 value,
    # and the product of two, are exact in float32, so this is the same sum.
    return torch.mm(a.float(), b.float())


def _keep_mask(x: torch.Tensor, thr: torch.Tensor, k: int) -> torch.Tensor:
    """The k entries of each row that ``jax.lax.top_k`` keeps, given each
    row's k-th largest value ``thr`` ([R, 1]): every entry above it, and the
    lowest-column entries equal to it."""
    gt = x > thr
    eq = x == thr
    need = k - gt.sum(dim=-1, keepdim=True)
    return gt | (eq & (torch.cumsum(eq, dim=-1, dtype=torch.int32) <= need))


def _kth_largest(x: torch.Tensor, k: int) -> torch.Tensor:
    return torch.topk(x, k, dim=-1, sorted=False).values.amin(dim=-1, keepdim=True)


def _topk_stable(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row-wise top-k of ``x`` by descending value, equal values by
    ascending column: ``jax.lax.top_k``'s result."""
    keep = _keep_mask(x, _kth_largest(x, k), k)
    idx = keep.nonzero()[:, 1].view(x.shape[0], k)  # ascending columns
    vals, order = torch.sort(torch.gather(x, 1, idx), dim=-1, descending=True,
                             stable=True)
    return vals, torch.gather(idx, 1, order)


def _trunc_rows(C: torch.Tensor, L: int, exact: bool) -> torch.Tensor:
    """Zero row entries below the row's L-th largest score (``keepTop``,
    include/internal/pprInternal.h:110-137), in place over row chunks.

    ``exact=True`` keeps exactly L entries a row (lowest-column ties,
    the sparse pipeline's keep_top up to tie order); ``exact=False`` keeps
    every entry at or above the L-th value, boundary ties included.
    """
    if L >= C.shape[-1]:
        return C
    chunk = max(1, TRUNC_ELEMS // C.shape[-1])
    for s in range(0, C.shape[0], chunk):
        c = C[s : s + chunk]
        thr = _kth_largest(c, L)
        keep = _keep_mask(c, thr, L) if exact else c >= thr
        c.masked_fill_(~keep, 0.0)
    return C


def _dense_init(plan: DensePlan, damping: float, L: int, mm_dtype, exact_trunc: bool,
                device):
    """The adjacency halves and the truncated initial score matrix, in the
    matmul dtype.

    Init semantics (include/grank.h:64-83): ``scores[v] = keepTop_L(
    {v: 1-damping} + {succ: += damping/outdeg})``, row ``v`` of the scaled
    adjacency plus the self entry, which is added after the edges.
    """
    n, n0, n_pad = plan.n, plan.n0, plan.n_pad

    def build_w(edges, n_rows):
        rows, cols, w = (torch.as_tensor(x).to(device) for x in edges)
        A = torch.zeros((n_rows, n_pad), dtype=torch.float32, device=device)
        if rows.numel():
            A.index_put_((rows.long(), cols.long()), w, accumulate=True)
        return A

    A0 = build_w(plan.edges0, n0)
    A1 = build_w(plan.edges1, plan.n1)
    S = torch.zeros((n_pad, n_pad), dtype=torch.float32, device=device)
    S[:n0] = A0
    S[n0:n] = A1
    diag = torch.arange(n, device=device)
    S[diag, diag] += _self_score(damping, device)
    _trunc_rows(S, L, exact_trunc)
    return A0.to(mm_dtype), A1.to(mm_dtype), S.to(mm_dtype)


def _self_score(damping: float, device) -> torch.Tensor:
    """``1 - damping`` computed in float32, as the JAX package does."""
    return 1.0 - torch.tensor(damping, dtype=torch.float32, device=device)


def _dense_half(A, S, off: int, self_score, L: int, exact: bool,
                compute_diff: bool):
    """One half-sweep over the partition whose rows of ``S`` start at
    ``off`` (``A``: its adjacency rows); writes them into ``S`` in place
    (their old values are read first, for the diff).  Returns the max L1
    diff of its rows, a 0-d tensor, or None without ``compute_diff``."""
    n_rows = A.shape[0]
    C = _mm_f32(A, S)
    r = torch.arange(n_rows, device=S.device)
    C[r, off + r] += self_score
    _trunc_rows(C, L, exact)
    d = None
    if compute_diff:
        d = (C - S[off : off + n_rows].float()).abs_().sum(dim=-1).max()
    S[off : off + n_rows] = C
    return d


def _dense_run(A0, A1, S, perm, damping: float, tolerance: float, iterations: int,
               n: int, n0: int, n1: int, L: int, K: int, compute_diff: bool,
               exact_trunc: bool):
    """GRank's half-sweeps through the one loop (ops/loop.py) and the final
    keepTop(K) (include/grank.h:87-147).

    A partition with no rows still counts as a half-sweep (diff 0); without
    ``compute_diff`` (a negative tolerance) no diff is computed.  ``S`` is
    updated in place.  Returns ``(Baskets, half-sweeps run)``.
    """
    self_score = _self_score(damping, S.device)
    parts = ((A0, 0, n0), (A1, n0, n1))

    def step(p):
        A, off, n_rows = parts[p]
        if not n_rows:
            return None
        return _dense_half(A, S, off, self_score, L, exact_trunc, compute_diff)

    # the comparisons are float32's, as in the JAX package's device loop
    h = run_half_sweeps(step, iterations, float(np.float32(tolerance)))
    return _topk_baskets(S, n, K, perm=perm), h


def _topk_baskets(S: torch.Tensor, n: int, K: int, perm=None) -> Baskets:
    """Exact row-wise top-K of a dense score matrix as ``[n, K]`` Baskets,
    equal scores by lowest column.

    Entries with score <= 0 are absent (every genuine basket score is a
    positive sum).  ``perm`` (new id -> original id) translates both row
    order and column ids back from a renumbered space.
    """
    kk = min(K, S.shape[-1])
    chunk = max(1, TRUNC_ELEMS // S.shape[-1])
    parts = [_topk_stable(S[s : min(s + chunk, n)].float(), kk) for s in range(0, n, chunk)]
    vals = torch.cat([p[0] for p in parts])
    idx = torch.cat([p[1] for p in parts])
    live = vals > 0
    ids = perm[idx.clamp(max=n - 1)] if perm is not None else idx
    row_ids = torch.where(live, ids, SENTINEL).to(torch.int32)
    row_scores = torch.where(live, vals, 0.0)
    if kk < K:
        row_ids = torch.nn.functional.pad(row_ids, (0, K - kk), value=SENTINEL)
        row_scores = torch.nn.functional.pad(row_scores, (0, K - kk))
    if perm is not None:
        out_ids = torch.empty_like(row_ids)
        out_scores = torch.empty_like(row_scores)
        out_ids[perm] = row_ids
        out_scores[perm] = row_scores
        return Baskets(out_ids, out_scores)
    return Baskets(row_ids, row_scores)


def dense_grank_run(
    graph,
    K: int,
    L: int,
    iterations: int,
    damping: float,
    tolerance: float,
    matmul_dtype=None,
    exact_trunc: bool = False,
    return_info: bool = False,
    device=None,
):
    """The dense engine of GRank (see the module doc): the plan, the init,
    the half-sweeps through the one loop (ops/loop.py) and the final cut.

    ``matmul_dtype``: a torch dtype (None: :func:`default_matmul_dtype`).
    ``return_info=True`` also returns
    ``{"iterations_ran": h, "flops": f}``: the half-sweeps run and the
    products' FLOPs, ``2 n_pad^2 (sweeps0 n0 + sweeps1 n1)``.
    """
    dev = resolve_device(device)
    plan = build_dense_plan(graph, damping)
    mm_dtype = matmul_dtype or default_matmul_dtype(dev)
    A0, A1, S = _dense_init(plan, damping, L, mm_dtype, exact_trunc, dev)
    perm = torch.as_tensor(plan.perm).to(dev).long()
    baskets, h = _dense_run(
        A0, A1, S, perm, damping, tolerance, iterations, plan.n, plan.n0,
        plan.n1, L, K, tolerance >= 0, exact_trunc,
    )
    if not return_info:
        return baskets
    # partition 0 sweeps first; h half-sweeps alternate 0,1,0,1,...
    sweeps0, sweeps1 = (h + 1) // 2, h // 2
    flops = 2 * plan.n_pad * plan.n_pad * (sweeps0 * plan.n0 + sweeps1 * plan.n1)
    return baskets, {"iterations_ran": h, "flops": flops}


# --------------------------------------------------------------------------
# Dense MCCompletePathV2: walk counts in an [N, N] matrix, the combine as
# matrix products (reference combine: include/mccompletepathv2.h:211-250).
# --------------------------------------------------------------------------


def _scatter_baskets(ids: torch.Tensor, scores: torch.Tensor, n_pad: int) -> torch.Tensor:
    """Dense [n_pad, n_pad] float32 count matrix from [N, L] basket rows;
    sentinel slots add 0.0 at column 0, which changes no value."""
    rows = torch.arange(ids.shape[0], device=ids.device)[:, None].expand(ids.shape)
    valid = ids >= 0
    counts = torch.zeros((n_pad, n_pad), dtype=torch.float32, device=ids.device)
    counts.index_put_(
        (rows, torch.where(valid, ids, 0).long()),
        torch.where(valid, scores, 0.0),
        accumulate=True,
    )
    return counts


def _dense_mc_combine(edges, factor: torch.Tensor, walk: Baskets, n_pad: int,
                      L: int, K: int, passes: int, mm_dtype) -> Baskets:
    """The MC combine as matrix products over the walks' ``[N, L]``
    baskets: ``map_v = {v: 1/factor_v} + sum of successors' baskets;
    keepTop(L); *factor_v`` (mccompletepathv2.h:211-250).

    ``factor_v = damping/outdeg(v)`` (1.0 for dangling nodes, whose rows
    thereby reduce to ``{v: 1.0}``: the self entry is 1/1 and a zero
    adjacency row adds nothing).
    """
    n = walk.ids.shape[0]
    dev = walk.ids.device
    src, dst, w = edges
    A = torch.zeros((n, n_pad), dtype=torch.float32, device=dev)
    if src.numel():
        A.index_put_((src, dst), w, accumulate=True)
    A = A.to(mm_dtype)
    S = _scatter_baskets(walk.ids, walk.scores, n_pad).to(mm_dtype)
    diag = torch.arange(n, device=dev)
    self_score = 1.0 / factor
    for _ in range(passes):
        C = _mm_f32(A, S)
        C[diag, diag] += self_score
        _trunc_rows(C, L, False)
        C *= factor[:, None]
        # in place: the product above has read all of S; rows n.. stay zero
        S[:n] = C
    return _topk_baskets(S, n, K)


def _mc_edges(graph, damping: float, device):
    """The adjacency (unit weights, parallel edges kept) and the per-node
    ``factor`` of the dense combine."""
    n = graph.num_nodes
    deg = graph.out_degree.astype(np.int64)
    factor = np.where(
        deg > 0, damping / np.maximum(deg, 1).astype(np.float64), 1.0
    ).astype(np.float32)
    src = torch.as_tensor(np.repeat(np.arange(n, dtype=np.int64), deg)).to(device)
    dst = torch.as_tensor(graph.indices.astype(np.int64)).to(device)
    ones = torch.ones(src.shape, dtype=torch.float32, device=device)
    return (src, dst, ones), torch.as_tensor(factor).to(device)


def dense_mc_combine(graph, walk: Baskets, K: int, L: int, damping: float,
                     combine_passes: int, matmul_dtype=None, device=None) -> Baskets:
    """MCCompletePathV2's combine on the dense engine: the walks' ``[N, L]``
    baskets (exact top-L normalized count rows) are scattered into an
    ``[N, N]`` matrix and combined with ``combine_passes`` matrix products
    (``matmul_dtype`` their input dtype; None: :func:`default_matmul_dtype`).
    Returns the ``[N, K]`` baskets."""
    dev = resolve_device(device)
    edges, factor = _mc_edges(graph, damping, dev)
    return _dense_mc_combine(
        edges, factor, walk, _padded(graph.num_nodes), L, K, combine_passes,
        matmul_dtype or default_matmul_dtype(dev),
    )
