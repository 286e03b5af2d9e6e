"""Fixed-width basket tensors: the replacement for the reference's
per-node ``unordered_map<Key, double>`` score maps.

A *basket set* over ``R`` rows with width ``W`` is a pair of tensors

* ``ids    : int32[R, W]``  node ids, ``-1`` marking empty slots
* ``scores : float32[R, W]`` scores (0 in empty slots)

The reference's hash-map primitives become row-wise tensor ops:

* ``keepTop`` (include/internal/pprInternal.h:110-137)  -> :func:`keep_top`
* the duplicate-key ``+=`` of grank's hot loop
  (include/grank.h:114-115)                             -> :func:`combine_sorted_runs`
* ``norm1``  (include/internal/pprInternal.h:148-165)   -> :func:`norm1_rows`
* ``jaccard``(include/internal/pprInternal.h:174-186)   -> :func:`jaccard_rows`

``keep_top`` cuts ties as ``jax.lax.top_k`` does in the JAX package: equal
scores go to the lower column, which on rows sorted by id is the smaller id.
(The reference's ``std::nth_element`` leaves ties arbitrary; the port keeps
the JAX package's rule so that both packages keep the same ids.)
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

SENTINEL = -1
NEG_INF = float("-inf")


class Baskets(NamedTuple):
    """A batch of sparse top-score maps in dense-slot form."""

    ids: torch.Tensor  # int32[..., W]
    scores: torch.Tensor  # float32[..., W]

    @property
    def width(self) -> int:
        return self.ids.shape[-1]


def empty_baskets(num_rows: int, width: int, device="cpu") -> Baskets:
    return Baskets(
        ids=torch.full((num_rows, width), SENTINEL, dtype=torch.int32, device=device),
        scores=torch.zeros((num_rows, width), dtype=torch.float32, device=device),
    )


def sort_rows_by_id(
    ids: torch.Tensor, scores: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row-wise stable sort ascending by id, carrying scores (sentinels first)."""
    ids_s, order = torch.sort(ids, dim=-1, stable=True)
    return ids_s, torch.gather(scores, -1, order)


def run_index(ids: torch.Tensor) -> torch.Tensor:
    """Index of each slot's run of equal ids within its (id-sorted) row."""
    is_start = torch.ones_like(ids, dtype=torch.int64)
    is_start[..., 1:] = (ids[..., 1:] != ids[..., :-1]).to(torch.int64)
    return torch.cumsum(is_start, dim=-1) - 1


def run_sums(
    ids: torch.Tensor, scores: torch.Tensor, max_run: int | None = None
) -> torch.Tensor:
    """Inclusive sums of each run of equal ids in id-sorted rows: a slot
    holds the sum of its run's scores up to itself, so a run's last slot
    holds the run's total.

    A log-step segmented scan: pass ``d`` (1, 2, 4, ... below the longest
    run, ``max_run``, which defaults to the row width) adds the value ``d``
    slots back where that slot is in the same run.  Elementwise ops only,
    so the sums take one fixed order on every device (no atomics): a run's
    total depends only on its values in row order, not on where the run
    sits in the row nor on ``max_run`` (a pass past a run's length adds
    nothing to it).  Runs longer than ``max_run`` get partial totals.
    """
    x = scores.to(torch.float32).clone()
    w = ids.shape[-1] if max_run is None else min(max_run, ids.shape[-1])
    d = 1
    while d < w:
        same = ids[..., d:] == ids[..., :-d]
        x[..., d:] += torch.where(same, x[..., :-d], 0.0)
        d *= 2
    return x


def run_ends(ids: torch.Tensor) -> torch.Tensor:
    """Whether each slot of an id-sorted row is the last of its run."""
    is_end = torch.ones_like(ids, dtype=torch.bool)
    is_end[..., :-1] = ids[..., 1:] != ids[..., :-1]
    return is_end


def combine_sorted_runs(
    ids: torch.Tensor, scores: torch.Tensor, max_run: int | None = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sum duplicate ids within each row of an id-sorted candidate list.

    Input rows must be sorted ascending by id.  Each run of equal ids is
    collapsed onto its last slot, which holds the run's score sum
    (:func:`run_sums`; ``max_run`` bounds a live run's length) and keeps
    its id; all other slots become sentinel (-1) with score 0.
    Sentinel-id runs stay sentinel.  (The batched form of the reference's
    ``currentMap[k] += ...``, include/grank.h:114-115.)
    """
    totals = run_sums(ids, scores, max_run)
    live = run_ends(ids) & (ids >= 0)
    out_ids = torch.where(live, ids, torch.full_like(ids, SENTINEL))
    out_scores = torch.where(live, totals, torch.zeros_like(totals))
    return out_ids, out_scores


_DEAD_KEY = torch.iinfo(torch.int64).min


def _top_order_key(scores: torch.Tensor, live: torch.Tensor) -> torch.Tensor:
    """int64 keys, distinct within a row, whose descending order is
    ``jax.lax.top_k``'s: descending score, equal scores by ascending column,
    dead slots last.  The high half maps the f32 bits order-preservingly to
    a signed int; the low half is ~column."""
    bits = scores.contiguous().view(torch.int32).to(torch.int64)
    ordered = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    col = torch.arange(scores.shape[-1], dtype=torch.int64, device=scores.device)
    key = (ordered << 32) | (0xFFFFFFFF - col)
    return torch.where(live, key, torch.full_like(key, _DEAD_KEY))


def keep_top(ids: torch.Tensor, scores: torch.Tensor, k: int) -> Baskets:
    """Row-wise top-k by score over live entries, equal scores by ascending
    column (``jax.lax.top_k``'s rule, deterministic on every device).

    Matches ``keepTop`` (include/internal/pprInternal.h:110-137): a row with
    fewer than ``k`` live entries is padded with sentinels.  Output width is
    exactly ``k``, rows ordered by descending score.
    """
    w = ids.shape[-1]
    key = _top_order_key(scores, ids >= 0)
    kk = min(k, w)
    top_key, top_pos = torch.topk(key, kk, dim=-1, largest=True, sorted=True)
    out_ids = torch.gather(ids, -1, top_pos)
    out_scores = torch.gather(scores, -1, top_pos)
    live = top_key != _DEAD_KEY
    out_ids = torch.where(live, out_ids, torch.full_like(out_ids, SENTINEL))
    out_scores = torch.where(live, out_scores, torch.zeros_like(out_scores))
    if k > w:
        pad = ids.shape[:-1] + (k - w,)
        out_ids = torch.cat(
            [out_ids, torch.full(pad, SENTINEL, dtype=out_ids.dtype, device=ids.device)],
            dim=-1,
        )
        out_scores = torch.cat(
            [out_scores, torch.zeros(pad, dtype=out_scores.dtype, device=ids.device)],
            dim=-1,
        )
    return Baskets(out_ids.to(torch.int32), out_scores.to(torch.float32))


def keep_top_chunked(
    ids: torch.Tensor,
    scores: torch.Tensor,
    k: int,
    elem_budget: int = 1 << 27,
) -> Baskets:
    """:func:`keep_top` over row chunks, bounding the top-k temporaries for
    graph-scale basket sets."""
    rows, w = ids.shape
    chunk = int(max(1, min(rows, elem_budget // max(w, 1))))
    if chunk >= rows:
        return keep_top(ids, scores, k)
    parts = [
        keep_top(ids[s : s + chunk], scores[s : s + chunk], k)
        for s in range(0, rows, chunk)
    ]
    return Baskets(
        torch.cat([p.ids for p in parts], dim=0),
        torch.cat([p.scores for p in parts], dim=0),
    )


def norm1_rows(a: Baskets, b: Baskets) -> torch.Tensor:
    """Row-wise L1 distance treating each row as a sparse vector.

    Mirrors ``norm1`` (include/internal/pprInternal.h:148-165): keys absent
    from one side count with value 0.  An id occurs at most once in a
    basket row, so a live run holds at most two entries: one scan pass.
    """
    ids = torch.cat([a.ids, b.ids], dim=-1)
    scores = torch.cat([a.scores, -b.scores], dim=-1)
    ids, scores = sort_rows_by_id(ids, scores)
    out_ids, diff = combine_sorted_runs(ids, scores, max_run=2)
    return torch.where(out_ids >= 0, diff.abs(), torch.zeros_like(diff)).sum(dim=-1)


def jaccard_rows(a_ids: torch.Tensor, b_ids: torch.Tensor) -> torch.Tensor:
    """Row-wise Jaccard index of the live-id sets.

    Empty-vs-empty rows yield 1.0, like the reference
    (include/internal/pprInternal.h:176-177).  Assumes ids within a row are
    distinct (true for any basket).
    """
    a_live = a_ids >= 0
    b_live = b_ids >= 0
    inter = (
        (a_ids[..., :, None] == b_ids[..., None, :])
        & a_live[..., :, None]
        & b_live[..., None, :]
    ).sum(dim=(-2, -1))
    union = a_live.sum(dim=-1) + b_live.sum(dim=-1) - inter
    return torch.where(
        union == 0,
        torch.ones_like(union, dtype=torch.float32),
        inter.to(torch.float32) / union.clamp(min=1).to(torch.float32),
    )
