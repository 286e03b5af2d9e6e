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
