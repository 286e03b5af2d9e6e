"""The numbers that decide whether a run's baskets are correct.

A run's result is ``[N, K]`` baskets (int32 ids, -1 padded; float32 scores,
rows by descending score).  Against the reference's ``[N, L]`` baskets
(L >= K, rows by descending score) two gaps are read:

* ``rank_score_gap``: the widest gap between the two sides' k-th score of a
  row, over every row and rank k < K (an empty slot scores 0).  It does not
  care which of two tied ids a side kept, and catches a row whose scores
  are wrong, short or out of order.
* ``id_score_gap``: the widest gap between the score a run gives an id in
  a row and the score the reference's L-wide row gives the same id (0 when
  the id is not in it).  It catches an id that does not belong where the
  run put it.

Both are absolute, in units of score (a row's scores sum to at most 1),
and are read as widest gaps and as means over all N x K slots.  The means
see a lower precision, which moves every score a little; the widest gaps
see a single wrong answer, where the program's own differences from the
reference (ties at the L cut, the hub rows' hierarchical merge) stay
below it.
"""

from __future__ import annotations

from typing import Dict

import torch

SENTINEL = -1


def well_formed(ids: torch.Tensor, scores: torch.Tensor, num_nodes: int, K: int) -> bool:
    """Shapes, dtypes, id range, padding, distinct ids and descending order
    of a result."""
    if ids.shape != (num_nodes, K) or scores.shape != (num_nodes, K):
        return False
    if ids.dtype != torch.int32 or scores.dtype != torch.float32:
        return False
    if num_nodes == 0:
        return True
    live = ids >= 0
    if bool((ids < SENTINEL).any()) or bool((ids >= num_nodes).any()):
        return False
    if bool((~live[:, :-1] & live[:, 1:]).any()):  # padding only at the end
        return False
    if bool((scores[~live] != 0).any()) or not bool(torch.isfinite(scores).all()):
        return False
    s_ids = torch.sort(ids, dim=1).values
    if bool(((s_ids[:, 1:] == s_ids[:, :-1]) & (s_ids[:, 1:] >= 0)).any()):
        return False  # an id twice in a row
    return not bool((scores[:, 1:] > scores[:, :-1]).any())


THRESHOLDS = (1e-6, 1e-5, 1e-4, 1e-3)


def basket_gaps(ids: torch.Tensor, scores: torch.Tensor, ref_ids: torch.Tensor,
                ref_scores: torch.Tensor, block_rows: int = 1 << 18) -> Dict[str, float]:
    """The gaps of a ``[N, K]`` result against the reference's ``[N, L]``
    baskets (see the module doc), read in blocks of rows:
    ``rank_score_gap`` and ``id_score_gap`` (widest), their means over all
    N x K slots (``mean_score_gap``, ``mean_id_gap``; an empty slot adds 0
    to the latter), and the counts of slots whose rank gap exceeds each of
    ``THRESHOLDS`` (``slots_over_<t>``)."""
    n, k = ids.shape
    rank_gap = id_gap = total = id_total = 0.0
    over = [0] * len(THRESHOLDS)
    for a in range(0, n, block_rows):
        b = min(n, a + block_rows)
        r_ids = ref_ids[a:b].to(torch.int64)
        r_sc = ref_scores[a:b].to(torch.float64)
        p_ids = ids[a:b].to(torch.int64)
        p_sc = scores[a:b].to(torch.float64)
        gap = (p_sc - r_sc[:, :k]).abs()
        rank_gap = max(rank_gap, float(gap.max()))
        total += float(gap.sum())
        for i, t in enumerate(THRESHOLDS):
            over[i] += int((gap > t).sum())
        # each port id's score in the reference's row, by a sorted join
        rows = torch.arange(b - a, device=ids.device)[:, None]
        r_key = torch.where(r_ids >= 0, rows * (1 << 32) + r_ids, -1).reshape(-1)
        r_key, order = torch.sort(r_key)
        r_val = r_sc.reshape(-1)[order]
        live = p_ids >= 0
        p_key = (rows * (1 << 32) + p_ids)[live]
        if p_key.numel():
            pos = torch.searchsorted(r_key, p_key).clamp(max=r_key.numel() - 1)
            ref_of = torch.where(r_key[pos] == p_key, r_val[pos], torch.zeros_like(r_val[pos]))
            id_err = (p_sc[live] - ref_of).abs()
            id_gap = max(id_gap, float(id_err.max()))
            id_total += float(id_err.sum())
    out = {"rank_score_gap": rank_gap, "id_score_gap": id_gap,
           "mean_score_gap": total / max(n * k, 1), "mean_id_gap": id_total / max(n * k, 1)}
    for t, c in zip(THRESHOLDS, over):
        out[f"slots_over_{t:g}"] = float(c)
    return out
