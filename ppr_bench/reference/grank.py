"""Plain GRank, the benchmark's reference: all-sources top-K personalized
PageRank by iterative basket merging, in plain PyTorch on any device.

The semantics are the reference library's (``ppr::grank``,
include/grank.h:42-150), written out again from the edge arrays alone:

* the 2-colouring (``findPartitions``, include/internal/pprInternal.h:30-99):
  BFS-level parity over the undirected closure, one BFS per weakly
  connected component, rooted at the component's lowest id, roots in
  partition 0;
* init: ``basket[v] = top_L({v: 1-d} + sum over successors s {s: d/deg(v)})``,
  parallel edges counted each time; a node without successors keeps
  ``{v: 1-d}`` for ever;
* each iteration sweeps one partition (partition 0 first), every row of it
  reading the baskets as they stood before the sweep:
  ``basket[v] = top_L({v: 1-d} + sum over successors s of d/deg(v) * basket[s])``;
* the loop ends after ``iterations`` half-sweeps, or once both
  partitions' last max L1 change (``norm1``) is under ``tolerance``
  (each partition's slot starts at ``tolerance``); a negative tolerance
  never stops early;
* the result is each row's top K.

Nothing here is shared with the program under test: no partition, plan or
basket of it.  Ties at a cut keep the lower id (the library leaves them to
``std::nth_element``).  Each merge is one flat sort of (row, id) keys over
a block of rows.  In float32, the reference, the products and the sums of
duplicate ids are taken in float64 and rounded once to float32.  In a lower
dtype (bfloat16: the control, the step below the float32 the configurations
state) every product and every addition is taken in that dtype, the
additions of a run pairwise in a log-step scan.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

SENTINEL = -1
# Candidate entries a merge block holds; bounds the block's temporaries
# (about 60 bytes an entry).
BLOCK_ENTRIES = 1 << 27


class GrankResult(NamedTuple):
    ids: torch.Tensor  # int32[N, L], rows by descending score, -1 padded
    scores: torch.Tensor  # float32[N, L], 0 in empty slots
    iterations_ran: int


def csr(num_nodes: int, src: torch.Tensor, dst: torch.Tensor):
    """(indptr int64[N+1], successors int64[E], out-degree int64[N]); the
    successors of a row keep the order of the edge arrays."""
    order = torch.argsort(src, stable=True)
    succ = dst[order]
    deg = torch.bincount(src, minlength=num_nodes)
    indptr = torch.zeros(num_nodes + 1, dtype=torch.int64, device=src.device)
    indptr[1:] = torch.cumsum(deg, 0)
    return indptr, succ, deg


def partition(num_nodes: int, src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """uint8[N]: BFS-level parity over the undirected closure from each weak
    component's lowest id (see the module doc)."""
    dev = src.device
    u = torch.cat([src, dst])
    v = torch.cat([dst, src])
    ids = torch.arange(num_nodes, device=dev)
    label = ids.clone()
    while True:  # lowest id of each component: min-label propagation
        new = label.scatter_reduce(0, u, label[v], "amin", include_self=True)
        new = new[new]
        if torch.equal(new, label):
            break
        label = new
    level = torch.full((num_nodes,), -1, dtype=torch.int64, device=dev)
    frontier = label == ids
    level[frontier] = 0
    depth = 0
    while bool(frontier.any()):
        hit = frontier[u] & (level[v] < 0)
        frontier = torch.zeros(num_nodes, dtype=torch.bool, device=dev)
        frontier[v[hit]] = True
        depth += 1
        level[frontier] = depth
    return (level % 2).to(torch.uint8)


def _segment_ends(keys: torch.Tensor) -> torch.Tensor:
    """Positions of the last slot of each run of equal keys (keys sorted)."""
    end = torch.ones_like(keys, dtype=torch.bool)
    end[:-1] = keys[1:] != keys[:-1]
    return torch.nonzero(end).squeeze(1)


def _run_totals(values: torch.Tensor, ends: torch.Tensor) -> torch.Tensor:
    """Sum of each run (ends from _segment_ends), in float64."""
    cs = torch.cumsum(values.to(torch.float64), 0)
    tot = cs[ends]
    tot[1:] -= cs[ends[:-1]]
    return tot


def _scan_run_totals(values: torch.Tensor, keys: torch.Tensor,
                     ends: torch.Tensor) -> torch.Tensor:
    """Sum of each run in the values' own dtype: a log-step segmented scan,
    each addition rounded to the dtype."""
    x = values.clone()
    longest = int(torch.diff(ends, prepend=ends.new_tensor([-1])).max())
    d = 1
    while d < longest:
        x[d:] += torch.where(keys[d:] == keys[:-d], x[:-d], torch.zeros_like(x[:-d]))
        d *= 2
    return x[ends]


def _blocks(width: np.ndarray, budget: int):
    """[a, b) row ranges whose summed widths stay within ``budget`` (a row
    wider than it gets a range of its own)."""
    cum = np.cumsum(width, dtype=np.int64)
    a, n = 0, width.size
    while a < n:
        base = cum[a - 1] if a else 0
        b = int(np.searchsorted(cum, base + budget, side="right"))
        b = max(b, a + 1)
        yield a, b
        a = b


def _top_l(rows, ids, scores, n_rows, L, out_ids, out_scores):
    """Write each row's top L (descending score, ties by ascending id) of
    (rows, ids, scores) entries, sorted by (row, id), into the out rows."""
    bits = scores.to(torch.float32).view(torch.int32).to(torch.int64)
    key = (rows << 32) | (0x7FFFFFFF - bits)  # scores are >= 0
    order = torch.argsort(key, stable=True)
    rows_s = rows[order]
    starts = torch.searchsorted(rows_s, torch.arange(n_rows, device=rows.device))
    rank = torch.arange(rows_s.numel(), device=rows.device) - starts[rows_s]
    keep = rank < L
    r, k = rows_s[keep], rank[keep]
    out_ids[r, k] = ids[order][keep].to(torch.int32)
    out_scores[r, k] = scores[order][keep].to(out_scores.dtype)


def _merge(rows_np, indptr, succ, deg_np, old_ids, old_scores, damping, L,
           dtype, init, budget):
    """New top-L baskets ``[len(rows), L]`` of ``rows`` from the old state
    (``init``: each successor counts as ``{s: 1}``)."""
    dev = succ.device
    n = old_ids.shape[0]
    n_rows = rows_np.size
    out_ids = torch.full((n_rows, L), SENTINEL, dtype=torch.int32, device=dev)
    out_scores = torch.zeros((n_rows, L), dtype=dtype, device=dev)
    width = old_ids.shape[1] if not init else 1
    d_rows = deg_np[rows_np]
    exact = dtype == torch.float32  # float64 arithmetic; else ``dtype``'s
    work = torch.float64 if exact else dtype
    self_score = torch.tensor(1.0 - damping, dtype=dtype).to(work)
    for a, b in _blocks(d_rows * width + 1, budget):
        r = torch.as_tensor(rows_np[a:b], device=dev)
        dr = torch.as_tensor(d_rows[a:b], device=dev)
        m = b - a
        n_edges = int(d_rows[a:b].sum())
        local = torch.arange(m, device=dev)
        e_row = torch.repeat_interleave(local, dr, output_size=n_edges)
        first = torch.cumsum(dr, 0) - dr
        e_pos = (torch.arange(n_edges, device=dev) - first[e_row]) + indptr[r][e_row]
        s = succ[e_pos]
        factor = damping / dr.to(torch.float64)
        if not exact:
            factor = factor.to(dtype)
        if init:
            c_ids = s
            c_rows = e_row
            c_sc = factor[e_row]
        else:
            c_ids = old_ids[s].reshape(-1).to(torch.int64)
            c_rows = e_row.repeat_interleave(width)
            c_sc = (old_scores[s].to(work) * factor[e_row, None]).reshape(-1)
            live = c_ids >= 0
            c_ids, c_rows, c_sc = c_ids[live], c_rows[live], c_sc[live]
        c_ids = torch.cat([c_ids, r])
        c_rows = torch.cat([c_rows, local])
        c_sc = torch.cat([c_sc, self_score.to(dev).expand(m)])
        key = c_rows * n + c_ids
        order = torch.argsort(key, stable=True)
        key = key[order]
        ends = _segment_ends(key)
        if exact:
            tot = _run_totals(c_sc[order], ends).to(dtype)
        else:
            tot = _scan_run_totals(c_sc[order], key, ends)
        u_key = key[ends]
        del key, order, c_ids, c_rows, c_sc
        blk_ids = out_ids[a:b]
        blk_sc = out_scores[a:b]
        _top_l(u_key // n, u_key % n, tot, m, L, blk_ids, blk_sc)
    return out_ids, out_scores


def _l1_change(new_ids, new_scores, old_ids, old_scores, budget) -> float:
    """Max over rows of the L1 distance between two basket sets of the same
    rows (ids absent on one side count as 0 there)."""
    n_rows, L = new_ids.shape
    dev = new_ids.device
    worst = 0.0
    step = max(1, budget // (2 * L))
    for a in range(0, n_rows, step):
        b = min(n_rows, a + step)
        ids = torch.cat([new_ids[a:b], old_ids[a:b]], 1).to(torch.int64)
        sc = torch.cat([new_scores[a:b].to(torch.float64),
                        -old_scores[a:b].to(torch.float64)], 1)
        rows = torch.arange(b - a, device=dev)[:, None].expand(-1, 2 * L)
        live = ids >= 0
        key = rows[live] * (1 << 32) + ids[live]
        order = torch.argsort(key, stable=True)
        key = key[order]
        ends = _segment_ends(key)
        tot = _run_totals(sc[live][order], ends).abs()
        row_of = key[ends] >> 32
        per_row = torch.zeros(b - a, dtype=torch.float64, device=dev)
        rends = _segment_ends(row_of)
        per_row[row_of[rends]] = _run_totals(tot, rends)
        worst = max(worst, float(per_row.max()))
    return worst


def grank(num_nodes: int, src: torch.Tensor, dst: torch.Tensor, K: int, L: int,
          iterations: int, damping: float, tolerance: float,
          dtype: torch.dtype = torch.float32,
          budget: int = BLOCK_ENTRIES) -> GrankResult:
    """GRank over the graph of edges ``src -> dst`` (int64 tensors on the
    device to run on).  Returns the final ``[N, L]`` baskets, rows by
    descending score: the first K columns are the result."""
    dev = src.device
    n = num_nodes
    indptr, succ, deg = csr(n, src, dst)
    part = partition(n, src, dst).cpu().numpy()
    deg_np = deg.cpu().numpy()
    ids = torch.full((n, L), SENTINEL, dtype=torch.int32, device=dev)
    scores = torch.zeros((n, L), dtype=dtype, device=dev)
    dangling = np.nonzero(deg_np == 0)[0]
    if dangling.size:
        d = torch.as_tensor(dangling, device=dev)
        ids[d, 0] = d.to(torch.int32)
        scores[d, 0] = 1.0 - damping
    live_rows = np.nonzero(deg_np > 0)[0]
    sweep_rows = [live_rows[part[live_rows] == p] for p in (0, 1)]
    new_ids, new_sc = _merge(live_rows, indptr, succ, deg_np, ids, scores,
                             damping, L, dtype, True, budget)
    r = torch.as_tensor(live_rows, device=dev)
    ids[r], scores[r] = new_ids, new_sc
    max_diff = [tolerance, tolerance]
    active, i = 0, 0
    while i < iterations and max(max_diff) >= tolerance:
        rows_np = sweep_rows[active]
        if rows_np.size:
            r = torch.as_tensor(rows_np, device=dev)
            new_ids, new_sc = _merge(rows_np, indptr, succ, deg_np, ids, scores,
                                     damping, L, dtype, False, budget)
            diff = _l1_change(new_ids, new_sc, ids[r], scores[r], budget) \
                if tolerance >= 0 else 0.0
            ids[r], scores[r] = new_ids, new_sc
            del new_ids, new_sc
        else:
            diff = 0.0
        max_diff[0] = diff
        active = 1 - active
        max_diff[0], max_diff[1] = max_diff[1], max_diff[0]
        i += 1
    return GrankResult(ids, scores.to(torch.float32), i)
