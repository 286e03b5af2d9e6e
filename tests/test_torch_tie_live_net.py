"""Step 4d of the merge kernel (``csrc/merge_topl.cu``): the TPU kernel's
prune network run on the live slots alone.

The kernel runs ``bitonic_prune_topk`` only on rows whose totals tie at or
above the cut.  It keeps the live totals, those at or above the cut's
threshold, at their run-end positions p in the id-sorted row of W slots,
and moves each of them through the network's stages by itself: a stage
reads the partner's slot in a map of the W slots, and a key beside a dead
slot goes where the stage's direction sends the larger key, a key beside
a live one by the strict compare of the two totals (equal totals never
swap).  The prune rounds keep the first block's key unless the second's
total is larger; the winner takes the first block's slot.

``live_network`` below is that algorithm in plain PyTorch, with the
kernel's stage sequence, slot layout and map updates.  It is held bitwise
(ids, totals and order) against the port's dense version of the network,
``ops/merge_kernel.py::bitonic_prune_topk``, run on every run total of the
row (below the cut too), at every (W, l_pad) the kernel takes.  No JAX,
no card.
"""

import numpy as np
import pytest
import torch

from approximated_personalized_pagerank_tpu_torch.ops import merge_kernel as tk
from approximated_personalized_pagerank_tpu_torch.ops.basket import (
    run_ends, run_sums, sort_rows_by_id,
)

TIE_VALUES = np.array([0.25, 0.5, 1.0], dtype=np.float32)
ROWS = 6


def ordered(x: torch.Tensor) -> torch.Tensor:
    """The kernel's order-preserving map of f32 bits to uint32 (as int64):
    every non-NaN total maps to >= 1."""
    u = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return torch.where(u >= 0x80000000, 0xFFFFFFFF - u, u | 0x80000000)


def unordered(code: torch.Tensor) -> torch.Tensor:
    u = torch.where(code >= 0x80000000, code & 0x7FFFFFFF, 0xFFFFFFFF - code)
    return u.to(torch.int32).view(torch.float32)


def live_keys(ids: torch.Tensor, scores: torch.Tensor, l_pad: int):
    """The kernel's input to step 4d, by row: the live totals at or above
    the threshold (the l_pad-th largest live total; all of them when no
    more than l_pad are live), as (run-end position, code, id), -1 / 0 in
    the unused columns; and the dense network's input, every live total at
    its run end and -inf elsewhere."""
    ids = torch.where(ids < 0, torch.full_like(ids, tk.PAD_ID), ids)
    ids_s, sc_s = sort_rows_by_id(ids, scores)
    live = run_ends(ids_s) & (ids_s != tk.PAD_ID)
    totals = run_sums(ids_s, sc_s) + 0.0
    keys = torch.where(live, totals, torch.full_like(totals, float("-inf")))
    c, w = ids.shape
    pos = torch.full((c, w), -1, dtype=torch.int64)
    codes = torch.zeros((c, w), dtype=torch.int64)
    kid = torch.zeros((c, w), dtype=torch.int64)
    for r in range(c):
        tot = keys[r][live[r]]
        thr = torch.sort(tot, descending=True).values[l_pad - 1] if tot.numel() > l_pad \
            else torch.tensor(float("-inf"))
        keep = live[r] & (keys[r] >= thr)
        p = torch.nonzero(keep).flatten()
        pos[r, :p.numel()] = p
        codes[r, :p.numel()] = ordered(keys[r][p])
        kid[r, :p.numel()] = ids_s[r][p].to(torch.int64)
    return pos, codes, kid, (ids_s, keys)


def live_network(pos: torch.Tensor, codes: torch.Tensor, w: int, k: int) -> torch.Tensor:
    """Step 4d on [C, M] live keys (position -1: no key): the map of each
    row's W slots after ``bitonic_prune_topk``'s stages, key index or -1,
    first k slots.  Slot layout: logical slot q of the network's current
    row lies at (q // k) * span + q % k, span = k until the first prune
    round and doubling in each, so the first block of a pair keeps its
    slots; partners at distance j < k are slot ^ j, prune partners slot ^
    span.  A stage reads every key's partner, then moves the keys: a key
    whose partner holds an equal code stays, any other goes to the pair's
    lower slot if it is the larger and the pair sorts descending, or the
    smaller and it sorts ascending (a dead slot is the smaller); a key that
    moves writes its new slot, and clears its old one beside a dead
    partner (no other key touches the pair).  A prune round's winner
    writes the first block's slot; the loser's slot is overwritten or left
    out of the halved row."""
    c, m = pos.shape
    rows = torch.arange(c)[:, None].expand(c, m)
    key_idx = torch.arange(m)[None, :].expand(c, m)
    dump = w  # a column for the writes of absent keys
    slot = torch.full((c, w + 1), -1, dtype=torch.int64)
    pos = pos.clone()
    valid = pos >= 0
    slot[rows[valid], pos[valid]] = key_idx[valid]

    def partner_code(p):
        other = slot.gather(1, p)
        return torch.where(other >= 0, codes.gather(1, other.clamp(min=0)),
                           torch.zeros_like(other))

    def stage(j, dbit, fm):
        """Descending where (slot & dbit) ^ fm is set."""
        nonlocal pos
        p = pos.clamp(min=0)
        co = partner_code(p ^ j)
        desc = ((p & dbit) ^ fm) != 0
        to = torch.where(desc == (codes > co), p & ~j, p | j)
        moved = (pos >= 0) & (co != codes) & (to != p)
        slot.scatter_(1, torch.where(moved & (co == 0), p, dump), -1)
        slot.scatter_(1, torch.where(moved, to, dump), key_idx)
        pos = torch.where(moved, to, pos)

    def prune(span):
        nonlocal pos
        p = pos.clamp(min=0)
        co = partner_code(p ^ span)
        first = (p & span) == 0
        win = (pos >= 0) & torch.where(first, ~(co > codes), codes > co)
        to = p & ~span
        slot.scatter_(1, torch.where(win & (to != p), to, dump), key_idx)
        pos = torch.where(win, to, torch.full_like(pos, -1))

    if k == w:  # a full sort, descending where the size bit is clear
        size = 2
        while size <= w:
            j = size // 2
            while j >= 1:
                stage(j, size, size)
                j //= 2
            size *= 2
        return slot[:, :k]
    size = 2
    while size <= k:
        j = size // 2
        while j >= 1:
            stage(j, size, 0)
            j //= 2
        size *= 2
    span, wc = k, w
    while wc > k:
        prune(span)
        span *= 2
        j = k // 2
        while j >= 1:
            stage(j, 0, 1) if wc == 2 * k else stage(j, span, 0)
            j //= 2
        wc //= 2
    return slot[:, :k]


def tie_rows(rng: np.random.Generator, w: int, l_pad: int):
    """[ROWS, w] candidate rows of dyadic scores (exact sums), one of each
    kind: repeat only (the survivors fill l_pad exactly and repeat totals),
    split with every live total equal (m = W at full width), all live
    (fewer runs than l_pad) with -1 tails, a random mix of runs, split
    with a few totals above the cut, and no live slot."""
    ids = np.full((ROWS, w), -1, dtype=np.int32)
    sc = np.zeros((ROWS, w), dtype=np.float32)
    # repeat only: l_pad runs of totals 1 or 2 (ties among survivors), the
    # rest 0.25 (below the cut)
    n_hi = min(l_pad, w // 2)
    runs = rng.permutation(w)[: w // 2]
    ids[0, : w // 2] = runs
    sc[0, : w // 2] = 0.25
    sc[0, :n_hi] = rng.choice([1.0, 2.0], n_hi)
    # split, all equal: every slot a distinct id of total 1
    ids[1] = rng.permutation(w)
    sc[1] = 1.0
    # all live: fewer runs than l_pad, runs of one or two slots, -1 tail
    n_live = max(1, min(w, l_pad) * 3 // 4)
    ids[2, :n_live] = rng.integers(0, max(1, n_live // 2), n_live)
    sc[2, :n_live] = rng.choice(TIE_VALUES, n_live)
    # a random mix: runs of about three over a live share of the row
    live = int(rng.integers(max(1, w // 8), w + 1))
    ids[3, :live] = rng.integers(0, max(2, live // 3), live)
    sc[3, :live] = rng.choice(TIE_VALUES, live)
    # split with a few totals above the cut, the cut inside a run of 0.5s
    ids[4] = rng.permutation(w)
    sc[4] = 0.5
    sc[4, : max(1, l_pad // 3)] = 1.0
    sc[4, w // 2:] = 0.25
    # row 5: no live slot
    for r in range(ROWS - 1):
        perm = rng.permutation(w)
        ids[r], sc[r] = ids[r, perm], sc[r, perm]
    return ids, sc


SHAPES = [(w, lp) for w in (256, 512, 1024, 2048, 4096, 8192) for lp in (128, 256, 512)
          if lp <= w] + [(2, 2), (64, 8), (8192, 1024), (1024, 1024)]


@pytest.mark.parametrize("w,l_pad", SHAPES)
def test_live_network_is_the_prune_network(w, l_pad):
    ids, sc = tie_rows(np.random.default_rng(w * 31 + l_pad), w, l_pad)
    pos, codes, kid, (ids_s, keys) = live_keys(torch.as_tensor(ids), torch.as_tensor(sc), l_pad)
    m = int((pos >= 0).sum(dim=1).max())
    slot = live_network(pos[:, :max(m, 1)], codes[:, :max(m, 1)], w, l_pad)
    got_live = slot >= 0
    idx = slot.clamp(min=0)
    got_ids = torch.where(got_live, kid.gather(1, idx), torch.full_like(idx, -1))
    got_codes = torch.where(got_live, codes.gather(1, idx), torch.zeros_like(idx))

    want_ids, want_keys = tk.bitonic_prune_topk(ids_s, keys, l_pad)
    want_live = want_keys > float("-inf")
    np.testing.assert_array_equal(got_live.numpy(), want_live.numpy())
    np.testing.assert_array_equal(
        got_ids.numpy(), torch.where(want_live, want_ids.to(torch.int64), -1).numpy())
    np.testing.assert_array_equal(
        got_codes.numpy(), torch.where(want_live, ordered(want_keys), 0).numpy())
    # the scores the kernel writes back, bit for bit the network's
    got_scores = torch.where(got_live, unordered(got_codes), torch.zeros(()))
    np.testing.assert_array_equal(
        got_scores.view(torch.int32).numpy(),
        torch.where(want_live, want_keys, torch.zeros(())).view(torch.int32).numpy())
    assert not bool((pos[5] >= 0).any()), "the last row has a live slot"
    if w > l_pad:  # a split row with every slot live: m = W
        assert int((pos[1] >= 0).sum()) == w
