"""Batched successor-basket merge: GRank's hot loop on tensors.

Reference semantics (include/grank.h:96-126): for each node ``v`` of the
active partition build ``currentMap = {v: 1-damping}``, then for every
successor ``s`` add ``damping/outdeg(v) * scores[s][k]`` for each of the up
to ``L`` entries ``k`` of ``s``'s basket, truncate to top-L, and record the
L1 change.  The same machinery with other scaling is MCCompletePathV2's
combine step (include/mccompletepathv2.h:211-250) and GRank's
initialisation (include/grank.h:64-83).

Nodes are grouped into degree buckets (graph.merge_plan).  For one bucket
of ``C`` nodes with successor matrix ``succ[C, D]``:

1. gather the successors' baskets -> ``[C, D, L]`` candidate (id, score) pairs
2. scale, flatten to ``[C, D*L]``, append the self entry -> ``[C, W]``
3. per row: sort by id, sum equal-id runs, keep the top L
   (:func:`_merge_rows`: the ``sort`` pipeline, or the fused kernel)
4. optionally the L1 diff against the old basket rows

Rows are processed in chunks of at most ``elem_budget`` candidates.  The
kernel pipeline fuses steps 1-3 of a half-sweep's kernel-width bucket into
the kernel's gather entry (:func:`gather_merge_topl`), which builds no
``[C, W]`` matrix: its chunks are bounded by the diff's ``[C, 2L]``
temporaries instead.  On the CPU the entry runs its plain version, so the
CPU and the card take one path.

``merge_algo`` names the pipeline: ``"sort"`` (stable sort + segment sums
+ top-k, flat merges, quarter-octave bucket caps) or ``"kernel"`` (the
fused merge kernel, width-aligned caps and the hierarchical hub merge).
Either may carry ``":<cap>"``, a lower width cap for the kernel pipeline.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Sequence, Tuple

import torch

from .basket import (
    SENTINEL,
    Baskets,
    combine_sorted_runs,
    keep_top,
    norm1_rows,
    sort_rows_by_id,
)
from .merge_kernel import (
    MAX_KERNEL_WIDTH,
    fused_merge_topl,
    gather_merge_topl,
    gather_successors,
    next_pow2,
    pad_candidates,
)

# Max elements in a candidate matrix chunk.
DEFAULT_ELEM_BUDGET = 1 << 22

# Below this candidate width the sort pipeline is used regardless (the pow2
# padding of the kernel would dominate).
MIN_NETWORK_WIDTH = 256

# Hub (hierarchical) merge: intermediate per-group top-M keeps M =
# HUB_TOP_M_FACTOR * L candidates (see _hub_merge_chunk).  Fixes results,
# so it equals the JAX package's value.
HUB_TOP_M_FACTOR = 2

MERGE_ALGOS = ("sort", "kernel")
# Names the pipeline of a call that names none (``sort`` or
# ``kernel[:cap]``), read at each call.  Its own name: the JAX package's
# PPR_MERGE_ALGO takes other values, and a process may import both.
MERGE_ALGO_ENV = "PPR_TORCH_MERGE_ALGO"


def _split_algo(algo: str) -> Tuple[str, int]:
    name, _, cap_s = algo.partition(":")
    if name not in MERGE_ALGOS:
        raise ValueError(f"unknown merge algo {algo!r}")
    max_w = MAX_KERNEL_WIDTH
    if cap_s:
        max_w = min(max_w, int(cap_s))
    return name, max_w


def resolve_merge_algo(algo: str | None, device: torch.device | None) -> str:
    """None -> $PPR_TORCH_MERGE_ALGO if set, else the fused kernel on CUDA
    and the sort pipeline on the CPU.  On CUDA the variable may only name
    ``kernel``: a call that leaves the kernel says so with ``merge_algo``."""
    if algo is None:
        env = os.environ.get(MERGE_ALGO_ENV)
        cuda = device is not None and device.type == "cuda"
        if env:
            _split_algo(env)
            if cuda and env != "kernel":
                raise ValueError(
                    f"{MERGE_ALGO_ENV}={env!r} would take the card's merges off the "
                    "CUDA kernel; pass merge_algo to choose another pipeline there")
        algo = env or ("kernel" if cuda else "sort")
    _split_algo(algo)
    return algo


def net_max_width(algo: str) -> int | None:
    """Width cap of the kernel pipeline, or None for the sort pipeline
    (which has none)."""
    name, max_w = _split_algo(algo)
    return max_w if name == "kernel" else None


def _takes_kernel(algo: str, w: int) -> bool:
    """Whether a candidate row of width ``w`` goes through the kernel:
    the kernel pipeline, ``w >= MIN_NETWORK_WIDTH`` and its pow2 width
    within the cap."""
    name, max_w = _split_algo(algo)
    return name == "kernel" and w >= MIN_NETWORK_WIDTH and next_pow2(w) <= max_w


def _l_pad(L: int) -> int:
    return next_pow2(max(L, 128))


def _merge_rows(
    ids: torch.Tensor, scores: torch.Tensor, L: int, algo: str,
    lists: int | None = None,
) -> Baskets:
    """Row-wise duplicate-id combine + top-L with the selected pipeline.

    Input: candidate rows [C, W] with SENTINEL (-1) padding; ``lists``, if
    known, is how many lists of distinct ids a row joins (so no id occurs
    more often: the sort pipeline's bound on a run).
    Output: Baskets rows [C, L] with SENTINEL padding, sorted desc by score.
    Kernel-pipeline rows narrower than MIN_NETWORK_WIDTH, or whose pow2
    width exceeds the cap, take the sort pipeline.
    """
    if not _takes_kernel(algo, ids.shape[-1]):
        ids, scores = sort_rows_by_id(ids, scores)
        ids, scores = combine_sorted_runs(ids, scores, max_run=lists)
        return keep_top(ids, scores, L)
    l_pad = _l_pad(L)
    out_ids, out_scores = fused_merge_topl(*pad_candidates(ids, scores, l_pad), l_pad)
    return Baskets(out_ids[:, :L], out_scores[:, :L])


class DeviceBucket(NamedTuple):
    """An ELL bucket (graph.EllBucket) on the device."""

    rows: torch.Tensor  # int64[C] node ids
    succ: torch.Tensor  # int64[C, cap] successor ids, -1 padded


def device_plan(plan, device) -> Tuple[DeviceBucket, ...]:
    """Upload a host MergePlan's buckets."""
    return tuple(
        DeviceBucket(
            rows=torch.as_tensor(b.rows, dtype=torch.int64).to(device),
            succ=torch.as_tensor(b.succ, dtype=torch.int64).to(device),
        )
        for b in plan.buckets
    )


def _scales(
    deg: torch.Tensor, damping: torch.Tensor, mode: str
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-row (candidate scale, self score, post-truncation scale)."""
    factor = damping / deg.clamp(min=1.0)
    if mode == "grank":
        c = deg.shape[0]
        return factor, (1.0 - damping).expand(c), torch.ones_like(factor)
    if mode == "mc_combine":
        return torch.ones_like(factor), 1.0 / factor, factor
    raise ValueError(f"unknown merge mode {mode!r}")


def _bucket_candidates(
    basket: Baskets | None,
    rows: torch.Tensor,
    succ: torch.Tensor,
    damping: torch.Tensor,
    mode: str,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Build the [C, W] candidate (ids, scores) matrix plus per-row post-scale.

    ``mode``:
      * ``"grank"``: candidates are successor basket entries scaled by
        damping/outdeg, self entry ``1-damping`` (include/grank.h:100-116).
        ``basket=None`` means *init*: each successor contributes a
        singleton ``{s: 1}`` instead of its basket (include/grank.h:64-83).
      * ``"mc_combine"``: candidates are successor baskets unscaled, self
        entry ``1/factor`` with ``factor = damping/outdeg``, and the whole
        result is scaled by ``factor`` after truncation
        (include/mccompletepathv2.h:213-249).
    """
    valid = succ >= 0
    deg = valid.sum(dim=-1).to(torch.float32)
    scale, self_scores, post_scale = _scales(deg, damping, mode)
    if basket is None:
        cand_ids = torch.where(valid, succ, torch.full_like(succ, SENTINEL))
        cand_ids = cand_ids.to(torch.int32)
        cand_scores = valid.to(torch.float32)
    else:
        cand_ids, cand_scores = gather_successors(basket.ids, basket.scores, succ)
    cand_scores = cand_scores * scale[:, None]
    ids = torch.cat([cand_ids, rows[:, None].to(torch.int32)], dim=-1)
    scores = torch.cat([cand_scores, self_scores[:, None]], dim=-1)
    return ids, scores, post_scale


def _hub_merge_chunk(
    basket: Baskets,
    rows: torch.Tensor,  # int64[C]
    succ: torch.Tensor,  # int64[C, cap]
    damping: torch.Tensor,
    L: int,
    mode: str,
    algo: str,
    sub: int,
) -> Baskets:
    """Hierarchical merge for hub rows (out-degree > ``sub``).

    The row's successors are split into groups of ``sub`` (a group's
    candidates fill one kernel-width row), each group merges to an
    intermediate top-M (M = HUB_TOP_M_FACTOR * L), and the per-group lists
    are tree-reduced with the same merge until one final merge (with the
    self entry) yields the top-L.  Every row the merge ever sorts is at
    most the kernel width.

    Divergence from the flat merge (include/grank.h:96-126 accumulates then
    truncates once): an id outside every group's top-M but inside the exact
    top-L can be lost.  The flat path is merge_algo="sort".
    """
    c, cap = succ.shape
    g = -(-cap // sub)
    if g * sub > cap:
        succ = torch.nn.functional.pad(succ, (0, g * sub - cap), value=SENTINEL)
    deg = (succ >= 0).sum(dim=-1).to(torch.float32)
    scale, self_scores, post_scale = _scales(deg, damping, mode)
    # the per-successor scale commutes with the merge tree; the self entry
    # joins at the final level only
    group_succ = succ.reshape(c * g, sub)
    group_scale = torch.repeat_interleave(scale, g)
    m = min(max(HUB_TOP_M_FACTOR, 1) * L, sub * basket.width)
    if _takes_kernel(algo, sub * basket.width):
        part = gather_merge_topl(basket.ids, basket.scores, group_succ, None,
                                 group_scale, None, None, m, _l_pad(m))
    else:
        cand_ids, cand_scores = gather_successors(basket.ids, basket.scores, group_succ)
        part = _merge_rows(cand_ids, cand_scores * group_scale[:, None], m, algo,
                           lists=sub)
    pids = part.ids.reshape(c, g * m)
    pscs = part.scores.reshape(c, g * m)
    # tree-reduce partial top-M lists until one final row fits
    while g * m > sub * L:
        gg = max(2, (sub * L) // m)
        g2 = -(-g // gg)
        pad_cols = g2 * gg * m - g * m
        if pad_cols:
            pids = torch.nn.functional.pad(pids, (0, pad_cols), value=SENTINEL)
            pscs = torch.nn.functional.pad(pscs, (0, pad_cols))
        part = _merge_rows(
            pids.reshape(c * g2, gg * m), pscs.reshape(c * g2, gg * m), m, algo,
            lists=gg,
        )
        g = g2
        pids = part.ids.reshape(c, g * m)
        pscs = part.scores.reshape(c, g * m)
    ids_f = torch.cat([pids, rows[:, None].to(torch.int32)], dim=-1)
    scs_f = torch.cat([pscs, self_scores[:, None]], dim=-1)
    out = _merge_rows(ids_f, scs_f, L, algo, lists=g + 1)
    return Baskets(out.ids, out.scores * post_scale[:, None])


def merge_bucket(
    basket: Baskets | None,
    rows: torch.Tensor,
    succ: torch.Tensor,
    damping: torch.Tensor,
    L: int,
    algo: str,
    mode: str = "grank",
    compute_diff: bool = False,
    elem_budget: int = DEFAULT_ELEM_BUDGET,
    hub_sub: int | None = None,
) -> Tuple[Baskets, torch.Tensor]:
    """Merged top-L baskets for one degree bucket, plus per-row L1 diff
    against the bucket's rows of ``basket`` (zeros unless ``compute_diff``).

    ``hub_sub`` routes buckets with cap > hub_sub through the hierarchical
    hub merge (:func:`_hub_merge_chunk`); the last chunk is ragged.  Other
    kernel-width rows of a half-sweep take the kernel's gather entry, in
    chunks of ``elem_budget // (2L)`` rows.
    """
    c, d = succ.shape
    hub = hub_sub is not None and d > hub_sub and basket is not None
    width = 1 + (d if basket is None else d * basket.width)
    gather = not hub and basket is not None and _takes_kernel(algo, width)
    per_row = 2 * L if gather else width
    chunk = int(max(1, min(c, elem_budget // max(per_row, 1))))
    parts_i, parts_s, parts_d = [], [], []
    for s0 in range(0, c, chunk):
        rows_c = rows[s0 : s0 + chunk]
        succ_c = succ[s0 : s0 + chunk]
        if hub:
            new = _hub_merge_chunk(
                basket, rows_c, succ_c, damping, L, mode, algo, hub_sub
            )
        elif gather:
            deg = (succ_c >= 0).sum(dim=-1).to(torch.float32)
            scale, self_scores, post = _scales(deg, damping, mode)
            new = gather_merge_topl(basket.ids, basket.scores, succ_c, rows_c,
                                    scale, self_scores, post, L, _l_pad(L))
        else:
            ids, scores, post = _bucket_candidates(
                basket, rows_c, succ_c, damping, mode
            )
            new = _merge_rows(ids, scores, L, algo, lists=d + 1)
            new = Baskets(new.ids, new.scores * post[:, None])
        if compute_diff and basket is not None:
            old_c = Baskets(basket.ids[rows_c], basket.scores[rows_c])
            parts_d.append(norm1_rows(new, old_c))
        parts_i.append(new.ids)
        parts_s.append(new.scores)
    if parts_d:
        diff = torch.cat(parts_d, dim=0)
    else:
        diff = torch.zeros(c, dtype=torch.float32, device=rows.device)
    return Baskets(torch.cat(parts_i, dim=0), torch.cat(parts_s, dim=0)), diff


def merge_sweep(
    basket: Baskets | None,
    buckets: Sequence[DeviceBucket],
    damping: torch.Tensor,
    L: int,
    algo: str,
    mode: str = "grank",
    compute_diff: bool = False,
    out_basket: Baskets | None = None,
    elem_budget: int = DEFAULT_ELEM_BUDGET,
    hub_sub: int | None = None,
) -> Tuple[Baskets, torch.Tensor]:
    """One merge sweep over a bucket list (one partition, or all nodes).

    Every bucket reads the old ``basket``; results are written in place into
    ``out_basket``, which defaults to a copy of ``basket``.  (Writing into
    ``basket`` itself would let later buckets read rows updated earlier in
    the same sweep: the 2-colouring is approximate, so a row's successors
    can sit in its own partition.)  Returns the updated basket set and the
    max per-row L1 diff as a 0-d tensor (0 if not requested).
    """
    if out_basket is None:
        out_basket = Baskets(basket.ids.clone(), basket.scores.clone())
    ids, scores = out_basket
    max_diff = torch.zeros((), dtype=torch.float32, device=ids.device)
    for b in buckets:
        new, diff = merge_bucket(
            basket, b.rows, b.succ, damping, L, algo, mode=mode,
            compute_diff=compute_diff and basket is not None,
            elem_budget=elem_budget, hub_sub=hub_sub,
        )
        ids.index_copy_(0, b.rows, new.ids)
        scores.index_copy_(0, b.rows, new.scores)
        if compute_diff:
            max_diff = torch.maximum(max_diff, diff.max())
    return out_basket, max_diff
