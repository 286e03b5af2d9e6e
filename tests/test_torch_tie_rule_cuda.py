"""The merge kernel's rule for tied totals on the card: every
instantiation of both entries held bitwise against its plain version.

The plain versions compute the TPU kernel's function (held against the JAX
package in ``test_torch_tie_rule.py`` and ``test_torch_tie_rule_paths.py``,
which take their rows from here).  Every row has dyadic scores from three
values, so every run sum is exact and totals tie at the cut and among the
survivors; the comparisons are bitwise in ids, scores and order.

This file imports neither JAX nor the JAX package, so it runs on a card's
machine without them, and without the suite's ``conftest.py`` (which
imports JAX)::

    python -m pytest --noconftest -o addopts= -m gpu tests/test_torch_tie_rule_cuda.py
"""

import re

import numpy as np
import pytest
import torch

from approximated_personalized_pagerank_tpu_torch.ops import merge as tm
from approximated_personalized_pagerank_tpu_torch.ops import merge_kernel as tk

TIE_VALUES = np.array([0.25, 0.5, 1.0], dtype=np.float32)


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _assert_bitwise(got_ids, got_scores, want_ids, want_scores):
    np.testing.assert_array_equal(np.asarray(got_ids), np.asarray(want_ids))
    np.testing.assert_array_equal(np.asarray(got_scores, dtype=np.float32).view(np.int32),
                                  np.asarray(want_scores, dtype=np.float32).view(np.int32))


def tied_rows(rng, rows, w, pad=tk.PAD_ID):
    """[rows, w] rows of dyadic scores: a live share from 1/8 of the row to
    all of it, ids from a third of the live count (runs of about three),
    so totals tie within rows; row 1 is all dead."""
    ids = np.full((rows, w), pad, dtype=np.int32)
    scores = np.zeros((rows, w), dtype=np.float32)
    for r in range(rows):
        if r == 1:
            continue
        live = int(rng.integers(max(1, w // 8), w + 1))
        ids[r, :live] = rng.integers(0, max(2, live // 3), live)
        scores[r, :live] = rng.choice(TIE_VALUES, live)
        perm = rng.permutation(w)
        ids[r], scores[r] = ids[r, perm], scores[r, perm]
    return ids, scores


def tied_baskets(seed, n, lb, c, d, grank_layout):
    """Baskets [n, lb] of distinct ids and dyadic scores (GRank's layout:
    score-sorted rows with -1 tails; else a quarter of the slots dead), c
    rows whose degrees are powers of two up to d (row 0 the largest, row 1
    none), so that GRank's 0.5/deg keeps every product and sum exact, and
    c distinct row ids."""
    rng = np.random.default_rng(seed)
    ids = np.stack([rng.permutation(n)[:lb] for _ in range(n)]).astype(np.int32)
    sc = rng.choice(TIE_VALUES / 16, (n, lb)).astype(np.float32)
    if grank_layout:
        sc = -np.sort(-sc, axis=1)
        ids[np.arange(lb)[None, :] >= rng.integers(1, lb + 1, n)[:, None]] = -1
    else:
        ids[rng.random((n, lb)) < 0.25] = -1
    sc = np.where(ids >= 0, sc, 0).astype(np.float32)
    succ = rng.integers(0, n, (c, d)).astype(np.int64)
    deg = 1 << rng.integers(0, d.bit_length(), c)
    deg[0], deg[1] = 1 << (d.bit_length() - 1), 0
    succ[np.arange(d)[None, :] >= deg[:, None]] = -1
    rows = rng.choice(n, c, replace=False).astype(np.int64)
    return ids, sc, succ, rows


def dyadic_scales(succ, mode):
    """(scale, self score, post-scale) as ``_scales`` gives them, with a
    damping of 0.5 and degrees that are powers of two, so products and
    sums stay exact: GRank's 0.5/deg on the candidates, MC's combine its
    self entry deg/0.5 and post-scale 0.5/deg."""
    deg = (succ >= 0).sum(axis=1).astype(np.float32)
    return tm._scales(torch.as_tensor(deg), torch.tensor(0.5), mode)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


# ------------------------------------------------------------ matrix entry
@pytest.mark.gpu
@pytest.mark.parametrize("w,l_pad", [(w, lp) for w in (256, 512, 1024, 2048, 4096, 8192)
                                     for lp in (128, 256, 512) if lp <= w]
                         + [(2, 2), (64, 8), (512, 512), (8192, 1024), (8192, 8192)])
def test_cuda_matrix_entry_is_its_plain_version_on_tied_rows(cuda, w, l_pad):
    """Every instantiation of the matrix entry (the network at 256-2048 and
    at 4096-8192, l_pad 2-8192): ids, scores and order equal to the plain
    version's."""
    ids, scores = tied_rows(np.random.default_rng(w * 7 + l_pad), 64, w)
    ids_d, sc_d = _t(ids).to(cuda), _t(scores).to(cuda)
    k_ids, k_sc = tk.fused_merge_topl(ids_d, sc_d, l_pad)
    p_ids, p_sc = tk.merge_topl_plain(ids_d, sc_d, l_pad)
    torch.cuda.synchronize()
    _assert_bitwise(k_ids.cpu(), k_sc.cpu(), p_ids.cpu(), p_sc.cpu())


# ------------------------------------------------------------ gather entry
# (Lb, D, L, l_pad, mode, self entry, GRank's layout): the network at 512
# and 4096, the run merge at 8192 (GRank, the MC combine, a hub group), a
# row as wide as l_pad, and runs over 512 (the network at 8192)
CUDA_GATHER = {
    "network_512": (30, 16, 30, 128, "grank", True, False),
    "network_4096": (100, 40, 100, 128, "grank", True, True),
    "run_merge_grank": (100, 81, 100, 128, "grank", True, True),
    "run_merge_mc_combine": (200, 40, 200, 256, "mc_combine", True, False),
    "run_merge_hub_group": (200, 40, 400, 512, "grank", False, False),
    "as_wide_as_l_pad": (20, 20, 300, 512, "grank", True, False),
    "run_over_512": (520, 15, 100, 128, "grank", True, False),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(CUDA_GATHER))
def test_cuda_gather_entry_is_its_plain_version_on_tied_rows(cuda, case):
    lb, d, L, l_pad, mode, self_entry, grank_layout = CUDA_GATHER[case]
    ids, sc, succ, rows = tied_baskets(21, 3000, lb, 64, d, grank_layout)
    scale, self_sc, post = (x.to(cuda) for x in dyadic_scales(succ, mode))
    if not self_entry:
        self_sc, post = None, None
    args = [_t(x).to(cuda) for x in (ids, sc, succ, rows)]
    k = tk.gather_merge_topl(*args, scale, self_sc, post, L, l_pad)
    p = tk.gather_merge_topl_plain(*args, scale, self_sc, post, L, l_pad)
    torch.cuda.synchronize()
    _assert_bitwise(k.ids.cpu(), k.scores.cpu(), p.ids.cpu(), p.scores.cpu())


def _tie_causes(ids, scores, l_pad):
    """[split, repeat only]: rows whose top-``l_pad`` cut splits a run of
    equal totals, and the other rows whose survivors repeat a total."""
    split = repeat = 0
    for r_ids, r_sc in zip(ids, scores):
        live = r_ids != tk.PAD_ID
        _, inv = np.unique(r_ids[live], return_inverse=True)
        tot = -np.sort(-np.bincount(inv, weights=r_sc[live].astype(np.float64)))
        if tot.size > l_pad and np.sum(tot == tot[l_pad - 1]) > np.sum(tot[:l_pad] == tot[l_pad - 1]):
            split += 1
        elif np.any(tot[:l_pad][1:] == tot[:l_pad][:-1]):
            repeat += 1
    return [split, repeat]


@pytest.mark.gpu
@pytest.mark.parametrize("w,l_pad", [(1024, 128), (8192, 256)])
def test_cuda_tied_row_counts_by_cause(cuda, w, l_pad):
    """The kernel's tied-row counters: every launched row, and the rows
    that took the prune network by cause, as the rows' own totals say."""
    ids, scores = tied_rows(np.random.default_rng(w + l_pad), 64, w)
    tk.count_tied_rows(True)
    try:
        tk.fused_merge_topl(_t(ids).to(cuda), _t(scores).to(cuda), l_pad)
        counts = tk.tied_row_counts()["fused_merge_topl"]
    finally:
        tk.count_tied_rows(False)
    assert counts["rows"] == 64
    assert [counts["split"], counts["repeat_only"]] == _tie_causes(ids, scores, l_pad)


# ------------------------------------------------ step 4d's two forms, by m
def kernel_constants():
    """(the most keys a lane of step 4d's live form holds, the share of the
    row's sort width up to which it runs), as the kernel's source states
    them."""
    with open(tk.KERNEL_SOURCE) as f:
        src = f.read()
    return tuple(int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
                 for name in ("kLiveKeysPerLane", "kLiveShare"))


def live_branch(w, m):
    """The form step 4d takes for m live keys in a row of padded width w:
    one warp, several warps, or the dense network over the row."""
    per_lane, share = kernel_constants()
    n = max(w, 256)
    nt = n // (16 if n >= 4096 else 8)
    if m > min(n // share, per_lane * nt):
        return "dense"
    per = 1 if m <= nt else 2 if m <= 2 * nt else 4
    return "warp" if m <= 32 * per else "warps"


def live_counts(ids, scores, l_pad, pad=tk.PAD_ID):
    """Each row's live count m: its totals at or above the l_pad-th largest
    (all of them, when no more than l_pad)."""
    out = []
    for r_ids, r_sc in zip(ids, scores):
        live = (r_ids != pad) & (r_ids >= 0)
        _, inv = np.unique(r_ids[live], return_inverse=True)
        tot = np.bincount(inv, weights=r_sc[live].astype(np.float64))
        thr = -np.sort(-tot)[l_pad - 1] if tot.size > l_pad else -np.inf
        out.append(int(np.sum(tot >= thr)))
    return np.array(out)


def live_count_rows(rng, rows, w, l_pad, m):
    """[rows, w] rows whose live count is m: m ids of total 1 or 2 (fewer
    than l_pad of 2), a quarter of them a run of two halves, and when m >=
    l_pad ids of total 0.25 (below the cut) in the free slots; every row
    ties (the cut splits the 1s, or the survivors repeat them)."""
    ids = np.full((rows, w), tk.PAD_ID, dtype=np.int32)
    sc = np.zeros((rows, w), dtype=np.float32)
    for r in range(rows):
        uid = rng.permutation(w)
        tot = np.ones(m, dtype=np.float32)
        tot[: min(l_pad, m) // 2] = 2.0
        doubles = min(m // 4, w - m)
        slot_ids = np.concatenate([uid[:m], uid[:doubles]])
        slot_sc = np.concatenate([tot, np.zeros(doubles, dtype=np.float32)])
        slot_sc[:doubles] /= 2
        slot_sc[m:] = slot_sc[:doubles]
        if m >= l_pad:
            free = w - slot_ids.size
            slot_ids = np.concatenate([slot_ids, uid[m:m + free]])
            slot_sc = np.concatenate([slot_sc, np.full(free, 0.25, dtype=np.float32)])
        perm = rng.permutation(w)[: slot_ids.size]
        ids[r, perm], sc[r, perm] = slot_ids, slot_sc
    return ids, sc


# (w, l_pad, m, form): one warp, several warps and the dense network at
# both sort widths' thread counts (E=8: 256-2048, E=16: 4096-8192), and
# the ends of each form
LIVE_MATRIX = [(256, 128, 30, "warp"), (256, 128, 64, "warp"), (256, 128, 65, "dense"),
               (512, 128, 30, "warp"), (512, 128, 100, "warps"), (512, 128, 200, "dense"),
               (1024, 256, 30, "warp"), (1024, 256, 200, "warps"), (1024, 256, 400, "dense"),
               (2048, 128, 30, "warp"), (2048, 128, 500, "warps"), (2048, 128, 600, "dense"),
               (4096, 128, 32, "warp"), (4096, 128, 700, "warps"), (4096, 128, 1024, "warps"),
               (4096, 128, 1025, "dense"), (8192, 128, 32, "warp"), (8192, 128, 33, "warps"),
               (8192, 256, 700, "warps"), (8192, 128, 2048, "warps"), (8192, 128, 2049, "dense"),
               (8192, 512, 5000, "dense"), (8192, 128, 8192, "dense")]


@pytest.mark.gpu
@pytest.mark.parametrize("w,l_pad,m,form", LIVE_MATRIX)
def test_cuda_matrix_entry_step_4d_forms(cuda, w, l_pad, m, form):
    """The matrix entry on tied rows of m live keys, on either side of
    step 4d's branches: bitwise its plain version, and every row counted
    in the m histogram where its m belongs."""
    ids, sc = live_count_rows(np.random.default_rng(w + l_pad + m), 32, w, l_pad, m)
    assert (live_counts(ids, sc, l_pad) == m).all()
    assert live_branch(w, m) == form
    ids_d, sc_d = _t(ids).to(cuda), _t(sc).to(cuda)
    tk.count_tied_rows(True)
    try:
        k_ids, k_sc = tk.fused_merge_topl(ids_d, sc_d, l_pad)
        counts = tk.tied_row_counts()["fused_merge_topl"]
    finally:
        tk.count_tied_rows(False)
    p_ids, p_sc = tk.merge_topl_plain(ids_d, sc_d, l_pad)
    torch.cuda.synchronize()
    _assert_bitwise(k_ids.cpu(), k_sc.cpu(), p_ids.cpu(), p_sc.cpu())
    bucket = tk.LIVE_BUCKETS[np.searchsorted([128, 512, 2048], m)]
    assert counts["live_hist"] == {b: 32 if b == bucket else 0 for b in tk.LIVE_BUCKETS}


def live_count_baskets(seed, n, lb, c, d, d_live, lv, self_entry):
    """The gather entry's inputs with exact sums whose rows have about
    d_live * lv live keys: baskets [n, lb] of lv live slots with ids of
    their own (1/16, the first 1/8), c rows of d_live distinct successors
    padded with -1 to d, scales that are powers of two, a dyadic self
    entry and a post-scale."""
    rng = np.random.default_rng(seed)
    ids = np.full((n, lb), -1, dtype=np.int32)
    ids[:, :lv] = np.arange(n)[:, None] * lb + np.arange(lv)[None, :]
    sc = np.where(ids >= 0, 1 / 16, 0).astype(np.float32)
    sc[:, 0] = 1 / 8
    succ = np.stack([rng.permutation(n)[:d] for _ in range(c)]).astype(np.int64)
    succ[:, d_live:] = -1
    rows = rng.integers(0, n, c).astype(np.int64)
    scale = (2.0 ** -rng.integers(0, 4, c)).astype(np.float32)
    self_sc = rng.choice(TIE_VALUES, c).astype(np.float32) if self_entry else None
    post = rng.random(c).astype(np.float32) if self_entry else None
    return ids, sc, succ, rows, scale, self_sc, post


# (Lb, D, valid successors, live slots a basket, l_pad, self entry): the
# run merge at 8192 (GRank, the MC combine, a hub group), the network at
# 4096 (E=16) and at 1024 (E=8), each with m in one warp, several warps
# and the dense network
LIVE_GATHER = {
    f"{name}_{form}": (lb, d, d_live, lv, l_pad, self_entry)
    for name, lb, d, l_pad, self_entry, forms in (
        ("run_merge_grank", 100, 81, 128, True, ((30, 1), (81, 8), (81, 40))),
        ("run_merge_mc_combine", 200, 40, 256, True, ((30, 1), (40, 10), (40, 100))),
        ("run_merge_hub_group", 200, 40, 512, False, ((32, 1), (40, 10), (40, 100))),
        ("network_4096", 100, 40, 128, True, ((30, 1), (40, 10), (40, 40))),
        ("network_1024", 100, 10, 128, True, ((10, 3), (10, 20), (10, 80))),
    )
    for form, (d_live, lv) in zip(("warp", "warps", "dense"), forms)
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(LIVE_GATHER))
def test_cuda_gather_entry_step_4d_forms(cuda, case):
    lb, d, d_live, lv, l_pad, self_entry = LIVE_GATHER[case]
    inputs = live_count_baskets(5, 3000, lb, 64, d, d_live, lv, self_entry)
    ids, sc, succ, rows, scale, self_sc, post = (
        None if x is None else _t(x).to(cuda) for x in inputs)
    cand_ids, cand_sc = tk.gather_successors(ids.cpu(), sc.cpu(), succ.cpu())
    cand_sc = cand_sc * scale.cpu()[:, None]
    if self_entry:
        cand_ids = torch.cat([cand_ids, rows.cpu()[:, None].to(torch.int32)], dim=-1)
        cand_sc = torch.cat([cand_sc, self_sc.cpu()[:, None]], dim=-1)
    m = live_counts(cand_ids.numpy(), cand_sc.numpy(), l_pad)
    w = tk.next_pow2(d * lb + int(self_entry))
    assert {live_branch(w, x) for x in m} == {case.rsplit("_", 1)[1]}
    k = tk.gather_merge_topl(ids, sc, succ, rows, scale, self_sc, post, l_pad, l_pad)
    p = tk.gather_merge_topl_plain(ids, sc, succ, rows, scale, self_sc, post, l_pad, l_pad)
    torch.cuda.synchronize()
    _assert_bitwise(k.ids.cpu(), k.scores.cpu(), p.ids.cpu(), p.scores.cpu())
