"""Plain MCCompletePathV2 in blocks, the reference for MC cells whose
``[N, N]`` matrices do not fit a card: every node's top-K from shared
Monte-Carlo walks, in plain PyTorch on any device, without an ``[N, N]``
allocation.

The semantics, the stream and the plan are ``reference/mc.py``'s (its
module doc), and so are its functions for them: the same edges and seed
give the same walks, draw for draw, and the same baskets up to the order
of float64 sums.  Only the layout differs:

* **The walks** run source chunk by source chunk (the plan's chunks, each
  under its own key, so each chunk's draws are those of the all-at-once
  walk).  A chunk records its visits as ``(row, node)`` keys, counts them
  by sort, adds ``R`` at each source and cuts each row to its top L (equal
  counts by lower id): the walks' rows, stored row by row (:class:`Rows`)
  as counts.
* **The combine**, per pass and per block of rows: each row ``v`` gathers
  its successors' rows (a successor reached by ``m`` parallel edges counts
  ``m`` times: its row times ``m``), sums them by id in float64 (in
  successor order), adds ``1/factor_v`` at ``v`` last, as ``A @ S + diag``
  does, keeps every entry at or above the row's L-th largest (ties at the
  cut kept) and scales by ``factor_v = damping / outdeg(v)`` (1 without
  successors).  The first pass sums the walks' integer counts and divides
  each sum by R once, so its sums are exact and equal sums tie whatever
  their order (``reference/mc.py`` sums ``count / R``: the same where R is
  a power of two).  A block holds at most ``block_elems`` candidates (one
  row more where a single row is wider).
* **The result**: each row's top L after the last pass, equal scores by
  lower id, then the first K columns are its top K.

``dtype`` rounds each pass's input rows (and the multiplicities) to a
lower dtype first: the control.  Nothing here is imported from the program
under test.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .mc import (
    SENTINEL,
    UNROLL,
    McResult,
    csr,
    fold_in,
    random_bits,
    root_key,
    split,
    trace_plan,
    uniform_from_bits,
)

# Candidates a combine block gathers at once (~70 bytes of temporaries each).
BLOCK_ELEMS = 1 << 27


class Rows(NamedTuple):
    """Sparse rows, row by row: row ``v`` is ``ids[start[v]:start[v] +
    length[v]]`` with ``values`` beside them, by descending value (equal
    values by lower id)."""

    start: torch.Tensor  # int64[N]
    length: torch.Tensor  # int64[N]
    ids: torch.Tensor  # int64[nnz]
    values: torch.Tensor  # float64[nnz]


class BlockedWalks(NamedTuple):
    rows: Rows  # each source's visit counts (R at itself) cut to its top L
    walk_steps: int  # hops that deposited a visit
    abandoned_walks: int  # walks running or unstarted at the horizon


def _rows_of(row: torch.Tensor, ids: torch.Tensor, values: torch.Tensor, n: int) -> Rows:
    """:class:`Rows` of entries already ordered by row."""
    length = torch.bincount(row, minlength=n)
    return Rows(torch.cumsum(length, 0) - length, length, ids, values)


def _ranks(row: torch.Tensor, n: int) -> torch.Tensor:
    """Each entry's place in its row, entries ordered by row."""
    length = torch.bincount(row, minlength=n)
    start = torch.cumsum(length, 0) - length
    return torch.arange(row.numel(), device=row.device) - start[row]


def _walk_chunk(a: int, b: int, first, succ, deg, plan, key, R: int, damping: float,
                n: int, L: int):
    """Sources ``a:b`` (one chunk of the plan, under the chunk's ``key``):
    their walks as ``reference/mc.py::walks`` runs them, then each row's
    counts cut to its top L.  Returns (rows, ids, counts, visits, abandoned)
    with rows global and ordered, abandoned as a 0-d tensor."""
    dev = deg.device
    m, S = b - a, plan.slots
    local = torch.arange(m, device=dev)
    node = local + a
    has = deg[a:b] > 0
    alive = has[:, None] & (torch.arange(S, device=dev) < plan.total)[None, :]
    pool = has.to(torch.int64) * max(plan.total - S, 0)
    home = node[:, None].expand(m, S)
    at = home.clone()
    key_row = (local * n)[:, None].expand(m, S)
    d32 = torch.tensor(damping, dtype=torch.float32, device=dev)
    index = ((torch.arange(UNROLL, device=dev)[:, None, None] * plan.chunk
              + local[None, :, None]) * S + torch.arange(S, device=dev)[None, None, :])
    visits = []
    hops = torch.empty((UNROLL, m, S), dtype=torch.int64, device=dev)
    none = torch.full((), -1, dtype=torch.int64, device=dev)
    for t in range(plan.macro_steps):
        if succ.numel() == 0 or not bool(alive.any()):
            break  # nothing left walking: the later macro steps change nothing
        k_choice, k_cont = split(fold_in(key, t))
        u_all = uniform_from_bits(random_bits(k_choice, index))
        u2_all = uniform_from_bits(random_bits(k_cont, index))
        for h in range(UNROLL):
            d = deg[at]
            stranded = d == 0
            moving = alive & ~stranded
            j = torch.minimum((u_all[h] * d.to(torch.float32)).to(torch.int64),
                              (d - 1).clamp(min=0))
            to = succ[(first[at] + j).clamp(0, succ.numel() - 1)]
            torch.where(moving, key_row + to, none, out=hops[h])
            ended = alive & (stranded | (u2_all[h] > d32))
            claims = torch.cumsum(ended.to(torch.int64), dim=1)
            again = ended & (claims <= pool[:, None])
            pool = (pool - claims[:, -1]).clamp(min=0)
            alive = (alive & ~ended) | again
            at = torch.where(moving & ~ended, to, home)
        visits.append(hops[hops >= 0])
    abandoned = alive.sum() + pool.sum()
    visited = torch.cat(visits) if visits else torch.empty(0, dtype=torch.int64, device=dev)
    n_visits = visited.numel()
    # R at each source, one a visit: counted by sort
    keys = torch.cat([visited, local * n + node])
    weights = torch.cat([torch.ones_like(visited), torch.full_like(local, int(R))])
    keys, order = torch.sort(keys)
    uniq, inverse = torch.unique_consecutive(keys, return_inverse=True)
    counts = torch.zeros(uniq.numel(), dtype=torch.int64, device=dev)
    counts.index_add_(0, inverse, weights[order])
    del keys, order, inverse, weights, visited
    # top L a row: by row, then descending count, then id, in one key
    row, col = uniq // n, uniq % n
    id_bits = max(n - 1, 1).bit_length()
    cap = int(R) + plan.width + 1
    count_bits = cap.bit_length()
    if (m - 1).bit_length() + count_bits + id_bits > 63:
        raise ValueError("the walks' sort key needs more than 63 bits")
    rank_key = (row << (count_bits + id_bits)) | ((cap - counts) << id_bits) | col
    rank_key, order = torch.sort(rank_key)
    row, col, counts = row[order], col[order], counts[order]
    keep = _ranks(row, m) < L
    return row[keep] + a, col[keep], counts[keep], n_visits, abandoned


def walks(num_nodes: int, src: torch.Tensor, dst: torch.Tensor, R: int, damping: float,
          seed: int, L: int) -> BlockedWalks:
    """Every source's walks (module doc), a chunk of the plan at a time, on
    the edges' device; each row cut to its top ``L``."""
    n = num_nodes
    dev = src.device
    plan = trace_plan(n, R, damping)
    first, succ, deg = csr(n, src, dst)
    starts = torch.arange(0, n, plan.chunk, dtype=torch.int64, device=dev)
    k0, k1 = fold_in(root_key(seed, dev), starts)
    parts, visits = [], 0
    abandoned = torch.zeros((), dtype=torch.int64, device=dev)
    for c, a in enumerate(range(0, n, plan.chunk)):
        b = min(n, a + plan.chunk)
        row, col, counts, v, ab = _walk_chunk(a, b, first, succ, deg, plan, (k0[c], k1[c]),
                                              R, damping, n, L)
        parts.append((row, col, counts))
        visits += v
        abandoned += ab
    row, col, counts = (torch.cat(p) for p in zip(*parts))
    rows = _rows_of(row, col, counts.to(torch.float64), n)
    return BlockedWalks(rows, visits, int(abandoned))


class Adjacency(NamedTuple):
    """The edges as distinct ``(v, s)`` pairs by ``v`` then ``s``, each with
    its multiplicity; ``start`` / ``length`` index a row's pairs."""

    start: torch.Tensor  # int64[N]
    length: torch.Tensor  # int64[N]
    succ: torch.Tensor  # int64[E'] successors
    mult: torch.Tensor  # float64[E'] parallel edges
    factor: torch.Tensor  # float64[N]: damping / outdeg, 1 without successors


def distinct_edges(num_nodes: int, src: torch.Tensor, dst: torch.Tensor,
                   damping: float) -> Adjacency:
    """The edge arrays as :class:`Adjacency`; the out-degree behind each
    ``factor`` counts parallel edges."""
    n = num_nodes
    pair, mult = torch.unique(src * n + dst, return_counts=True)  # sorted
    v = pair // n
    length = torch.bincount(v, minlength=n)
    deg = torch.bincount(src, minlength=n).to(torch.float64)
    factor = torch.where(deg > 0, damping / deg.clamp(min=1), torch.ones_like(deg))
    return Adjacency(torch.cumsum(length, 0) - length, length, pair % n,
                     mult.to(torch.float64), factor)


def _blocks(cost: torch.Tensor, budget: int):
    """Row ranges ``[a, b)`` whose summed ``cost`` stays within ``budget``
    (a row alone where it exceeds it)."""
    cum = np.cumsum(cost.cpu().numpy())
    n, a, base = cum.size, 0, 0
    while a < n:
        b = int(np.searchsorted(cum, base + budget, side="right"))
        b = max(b, a + 1)
        yield a, b
        base = int(cum[b - 1])
        a = b


def combine_pass(edges: Adjacency, rows: Rows, L: int, dtype=None,
                 block_elems: int = BLOCK_ELEMS, denominator: float = 1.0) -> Rows:
    """One combine pass over every row (module doc) on rows whose values
    are ``denominator`` times their scores (R for the walks' counts);
    ``dtype`` rounds the input scores and the multiplicities to it first."""
    n = edges.start.numel()
    dev = edges.start.device
    values, mult = rows.values, edges.mult
    if dtype is not None:
        values = (values / denominator).to(dtype).to(torch.float64)
        mult = mult.to(dtype).to(torch.float64)
        denominator = 1.0
    ids = rows.ids
    v_of = torch.repeat_interleave(torch.arange(n, device=dev), edges.length)
    per_edge = rows.length[edges.succ]
    cost = torch.zeros(n, dtype=torch.int64, device=dev).index_add_(0, v_of, per_edge) + 1
    out_row, out_ids, out_val = [], [], []
    for a, b in _blocks(cost, block_elems):
        e0 = int(edges.start[a])
        e1 = int(edges.start[b - 1] + edges.length[b - 1])
        s, lens = edges.succ[e0:e1], per_edge[e0:e1]
        offs = torch.cumsum(lens, 0) - lens
        total = int(lens.sum())
        flat = (torch.arange(total, device=dev)
                + torch.repeat_interleave(rows.start[s] - offs, lens, output_size=total))
        c_row = torch.repeat_interleave(v_of[e0:e1] - a, lens, output_size=total)
        c_val = values[flat] * torch.repeat_interleave(mult[e0:e1], lens, output_size=total)
        c_key = c_row * n + ids[flat]
        del flat, c_row
        # every row holds its own id: a zero candidate, 1/factor joins after the sum
        local = torch.arange(b - a, device=dev)
        c_key = torch.cat([c_key, local * n + local + a])
        c_val = torch.cat([c_val, torch.zeros(b - a, dtype=torch.float64, device=dev)])
        c_key, order = torch.sort(c_key, stable=True)
        c_val = c_val[order]
        del order
        uniq, runs = torch.unique_consecutive(c_key, return_counts=True)
        sums = torch.segment_reduce(c_val, "sum", lengths=runs)
        del c_key, c_val, runs
        if denominator != 1.0:
            sums /= denominator
        r = uniq // n
        own = uniq % n == r + a
        sums[own] += 1.0 / edges.factor[a:b]
        # keepTop(L): by row, descending sum, then id; every entry at or
        # above the row's L-th largest stays
        order = torch.sort(sums, descending=True, stable=True).indices
        order = order[torch.sort(r[order], stable=True).indices]
        r, sums, uniq = r[order], sums[order], uniq[order]
        del order, own
        length = torch.bincount(r, minlength=b - a)
        start = torch.cumsum(length, 0) - length
        kth = torch.where(length >= L, sums[(start + L - 1).clamp(max=sums.numel() - 1)],
                          torch.zeros_like(sums[:1]).expand(b - a))
        keep = sums >= kth[r]
        r = r[keep]
        out_row.append(r + a)
        out_ids.append(uniq[keep] % n)
        out_val.append(sums[keep] * edges.factor[r + a])
        del uniq, sums, keep, r
    return _rows_of(torch.cat(out_row), torch.cat(out_ids), torch.cat(out_val), n)


def top_l(rows: Rows, L: int):
    """Each row's first ``L`` entries as int32 ids and float64 scores
    ``[N, L]``, -1 / 0 padded."""
    n = rows.start.numel()
    dev = rows.start.device
    row = torch.repeat_interleave(torch.arange(n, device=dev), rows.length)
    rank = _ranks(row, n)
    keep = rank < L
    ids = torch.full((n, L), SENTINEL, dtype=torch.int32, device=dev)
    scores = torch.zeros((n, L), dtype=torch.float64, device=dev)
    ids[row[keep], rank[keep]] = rows.ids[keep].to(torch.int32)
    scores[row[keep], rank[keep]] = rows.values[keep]
    return ids, scores


def mccompletepathv2(num_nodes: int, src: torch.Tensor, dst: torch.Tensor, L: int, R: int,
                     damping: float, seed: int, passes: int = 2, dtype=None,
                     w: BlockedWalks | None = None,
                     block_elems: int = BLOCK_ELEMS) -> McResult:
    """Plain MCCompletePathV2 in blocks on the edges' device (module doc):
    each node's top ``L`` (``min(L, N)``) after the combine.  ``w``: walks
    already run for these arguments (the control reuses the reference's);
    ``dtype``: each pass's input rounded to it."""
    n = num_nodes
    L = min(L, n)
    w = walks(n, src, dst, R, damping, seed, L) if w is None else w
    edges = distinct_edges(n, src, dst, damping)
    rows, denominator = w.rows, float(R)
    for _ in range(passes):
        rows = combine_pass(edges, rows, L, dtype, block_elems, denominator)
        denominator = 1.0
    ids, scores = top_l(rows, L)
    scores /= denominator
    return McResult(ids, scores, w.walk_steps, w.abandoned_walks)
