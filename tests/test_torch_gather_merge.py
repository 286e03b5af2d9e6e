"""The merge kernel's gather entry against the JAX package.

``gather_merge_topl`` builds each row's candidates from the successors'
baskets and merges them in one kernel.  Its plain PyTorch version, which the
CPU runs, is held here against the JAX package's ``_bucket_candidates``
followed by ``_merge_rows`` (the XLA bitonic pipeline, and once the Pallas
kernel in interpret mode) and the post-scale, in GRank mode, in the MC
combine mode (post-scale != 1) and in the hub group form (no self entry).
The row layouts the kernel's run merge must take (``RUN_CASES``) are held
the same way.  Tolerances: ids equal up to equal scores at the cut, scores
within 1e-6, the float error of summing a run of equal ids in another order
when rows hold at most unit mass.  The ``gpu`` tests hold both CUDA entries against
their plain versions and check that the kernel's output is bitwise
deterministic and does not depend on the order of a row's candidates.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from approximated_personalized_pagerank_tpu.ops import basket as jb
from approximated_personalized_pagerank_tpu.ops import merge as jm

from approximated_personalized_pagerank_tpu_torch.ops import merge as tm
from approximated_personalized_pagerank_tpu_torch.ops import merge_kernel as tk
from approximated_personalized_pagerank_tpu_torch.utils.compare import topl_max_error

ATOL = 1e-6
DAMPING = 0.85


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _inputs(seed, n, lb, c, d):
    """Baskets [n, lb] (distinct ids per row, a quarter of the slots dead,
    rows of at most unit mass), c rows with successors [c, d] of ragged
    degree (-1 padded; row 1 has none), and c distinct row ids."""
    rng = np.random.default_rng(seed)
    ids = np.stack([rng.permutation(n)[:lb] for _ in range(n)]).astype(np.int32)
    ids[rng.random((n, lb)) < 0.25] = -1
    sc = np.where(ids >= 0, rng.random((n, lb)) / lb, 0).astype(np.float32)
    succ = rng.integers(0, n, (c, d)).astype(np.int64)
    deg = rng.integers(1, d + 1, c)
    deg[0], deg[1] = d, 0
    succ[np.arange(d)[None, :] >= deg[:, None]] = -1
    rows = rng.choice(n, c, replace=False).astype(np.int64)
    return ids, sc, succ, rows


def _port_args(succ, mode):
    deg = (_t(succ) >= 0).sum(dim=-1).to(torch.float32)
    return tm._scales(deg, torch.tensor(DAMPING, dtype=torch.float32), mode)


def _jax_reference(ids, sc, succ, rows, mode, L, algo, self_entry):
    cand_ids, cand_sc, post = jm._bucket_candidates(
        jb.Baskets(jnp.asarray(ids), jnp.asarray(sc)),
        jnp.asarray(rows, dtype=jnp.int32), jnp.asarray(succ, dtype=jnp.int32),
        jnp.float32(DAMPING), mode,
    )
    if not self_entry:  # the hub group level: the successors' entries only
        cand_ids, cand_sc = cand_ids[:, :-1], cand_sc[:, :-1]
    merge = jax.jit(functools.partial(jm._merge_rows, L=L, algo=algo))
    out = merge(cand_ids, cand_sc)
    return np.asarray(out.ids), np.asarray(out.scores * post[:, None])


# (mode, Lb, D, L, self entry): candidate widths 481, 321 and 320, which the
# kernel pipeline pads to 512
CASES = {
    "grank": ("grank", 40, 12, 40, True),
    "mc_combine": ("mc_combine", 32, 10, 32, True),
    "hub_group": ("grank", 20, 16, 40, False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_gather_plain_matches_jax_bitonic(case):
    mode, lb, d, L, self_entry = CASES[case]
    ids, sc, succ, rows = _inputs(3, 300, lb, 24, d)
    j_ids, j_sc = _jax_reference(ids, sc, succ, rows, mode, L, "bitonic", self_entry)
    scale, self_scores, post = _port_args(succ, mode)
    if not self_entry:
        self_scores, post = None, None
    tk.gather_merge_topl.launches.clear()
    out = tk.gather_merge_topl(_t(ids), _t(sc), _t(succ), _t(rows), scale,
                               self_scores, post, L, 128)
    assert out.ids.shape == (24, L) and out.ids.dtype == torch.int32
    assert not bool((out.ids[1] >= 0).any()) or self_entry  # no successors
    topl_max_error(j_ids, j_sc, out.ids, out.scores, ATOL)
    assert tk.gather_merge_topl.launches == {}  # the CPU path launches nothing


# Row layouts the kernel's run merge must take, each D*Lb (+1) wide enough
# to pad to 8192, the width the kernel merges runs at (Lb, D, L, l_pad,
# mode, self entry, layout): GRank's state (distinct ids sorted by score, -1
# tails), a run of 200 in the MC combine, runs that are no multiple of a
# warp, rows whose successors are nearly all absent, one id in every
# successor, a wide top list, the hub group level (no self entry), and runs
# over 512 (the kernel's block-network fallback).
RUN_CASES = {
    "grank_state": (100, 81, 100, 128, "grank", True, "grank"),
    "lb200_mc_combine": (200, 40, 200, 256, "mc_combine", True, "random"),
    "lb37": (37, 221, 37, 128, "grank", True, "random"),
    "sparse_successors": (64, 127, 64, 128, "grank", True, "sparse"),
    "one_id_everywhere": (50, 163, 50, 128, "grank", True, "common"),
    "l_pad_512": (20, 409, 300, 512, "grank", True, "random"),
    "hub_group": (200, 40, 400, 512, "grank", False, "random"),
    "run_over_512": (520, 15, 100, 128, "grank", True, "random"),
}


def _run_case(case, n=3000, c=8, seed=13):
    """Inputs of a RUN_CASES layout: baskets [n, Lb] of distinct ids a row,
    c rows of ragged degree (row 1 has no successor), c distinct row ids."""
    lb, d, L, l_pad, mode, self_entry, layout = RUN_CASES[case]
    rng = np.random.default_rng(seed)
    ids = np.stack([rng.permutation(n)[:lb] for _ in range(n)]).astype(np.int32)
    sc = (rng.random((n, lb)) / lb).astype(np.float32)
    if layout == "grank":  # score-sorted rows with -1 tails
        sc = -np.sort(-sc, axis=1)
        ids[np.arange(lb)[None, :] >= rng.integers(1, lb + 1, n)[:, None]] = -1
    else:
        ids[rng.random((n, lb)) < 0.25] = -1
    if layout == "common":  # id 7 in every basket, once
        ids[ids == 7] = -1
        ids[np.arange(n), rng.integers(0, lb, n)] = 7
    sc = np.where(ids >= 0, sc, 0).astype(np.float32)
    succ = rng.integers(0, n, (c, d)).astype(np.int64)
    deg = rng.integers(1, 3, c) if layout == "sparse" else rng.integers(1, d + 1, c)
    deg[0], deg[1] = (2 if layout == "sparse" else d), 0
    succ[np.arange(d)[None, :] >= deg[:, None]] = -1
    rows = rng.choice(n, c, replace=False).astype(np.int64)
    return ids, sc, succ, rows, mode, L, l_pad, self_entry


@pytest.mark.parametrize("case", sorted(RUN_CASES))
def test_gather_plain_matches_jax_on_run_layouts(case):
    ids, sc, succ, rows, mode, L, l_pad, self_entry = _run_case(case)
    j_ids, j_sc = _jax_reference(ids, sc, succ, rows, mode, L, "bitonic", self_entry)
    scale, self_scores, post = _port_args(succ, mode)
    if not self_entry:
        self_scores, post = None, None
    out = tk.gather_merge_topl(_t(ids), _t(sc), _t(succ), _t(rows), scale,
                               self_scores, post, L, l_pad)
    assert out.ids.shape == (succ.shape[0], L)
    topl_max_error(j_ids, j_sc, out.ids, out.scores, ATOL)


def test_gather_plain_matches_jax_pallas_interpret():
    # D*Lb + 1 = 256: the JAX package takes its Pallas kernel at W=256
    ids, sc, succ, rows = _inputs(4, 200, 15, 16, 17)
    j_ids, j_sc = _jax_reference(ids, sc, succ, rows, "grank", 15, "pallas", True)
    scale, self_scores, post = _port_args(succ, "grank")
    out = tk.gather_merge_topl(_t(ids), _t(sc), _t(succ), _t(rows), scale,
                               self_scores, post, 15, 128)
    topl_max_error(j_ids, j_sc, out.ids, out.scores, ATOL)


@pytest.mark.parametrize("mode", ["grank", "mc_combine"])
def test_gather_plain_equals_the_matrix_pipeline(mode):
    # the composition it stands for: _bucket_candidates, _merge_rows through
    # the matrix entry, the post-scale; same ops, so equal to the bit
    ids, sc, succ, rows = _inputs(5, 250, 30, 20, 12)
    basket = tk.Baskets(_t(ids), _t(sc))
    damping = torch.tensor(DAMPING, dtype=torch.float32)
    c_ids, c_sc, post = tm._bucket_candidates(basket, _t(rows), _t(succ), damping, mode)
    want = tm._merge_rows(c_ids, c_sc, 30, "kernel")
    scale, self_scores, post2 = _port_args(succ, mode)
    got = tk.gather_merge_topl(_t(ids), _t(sc), _t(succ), _t(rows), scale,
                               self_scores, post2, 30, 128)
    assert torch.equal(got.ids, want.ids)
    assert torch.equal(got.scores, want.scores * post[:, None])


def test_merge_bucket_takes_the_gather_entry_in_ragged_chunks(monkeypatch):
    # a kernel-width bucket of a half-sweep goes through the gather entry on
    # every device, in chunks of elem_budget // (2L) rows; rows are
    # independent, so the chunking leaves the output as it was
    ids, sc, succ, rows = _inputs(11, 250, 30, 50, 12)  # width 361
    basket = tk.Baskets(_t(ids), _t(sc))
    damping = torch.tensor(DAMPING, dtype=torch.float32)
    chunks = []
    real = tm.gather_merge_topl

    def counted(*args):
        chunks.append(args[2].shape[0])
        return real(*args)

    monkeypatch.setattr(tm, "gather_merge_topl", counted)
    whole, d_whole = tm.merge_bucket(basket, _t(rows), _t(succ), damping, 30,
                                     "kernel", compute_diff=True)
    assert chunks == [50]
    chunks.clear()
    part, d_part = tm.merge_bucket(basket, _t(rows), _t(succ), damping, 30,
                                   "kernel", compute_diff=True, elem_budget=1000)
    assert chunks == [16, 16, 16, 2]  # 1000 // 60 rows a chunk, the last ragged
    assert torch.equal(part.ids, whole.ids) and torch.equal(part.scores, whole.scores)
    assert torch.equal(d_part, d_whole)
    c_ids, c_sc, _ = tm._bucket_candidates(basket, _t(rows), _t(succ), damping, "grank")
    want = tm._merge_rows(c_ids, c_sc, 30, "kernel")
    assert torch.equal(whole.ids, want.ids) and torch.equal(whole.scores, want.scores)


def test_gather_wrapper_rejects_bad_input():
    ids, sc, succ, rows = _inputs(6, 50, 10, 4, 3)
    b_ids, b_sc, s, r = _t(ids), _t(sc), _t(succ), _t(rows)
    scale, self_scores, post = _port_args(succ, "grank")
    ok = (b_ids, b_sc, s, r, scale, self_scores, post, 10, 128)
    tk.gather_merge_topl(*ok)
    with pytest.raises(TypeError, match="int32"):
        tk.gather_merge_topl(b_ids.long(), *ok[1:])
    with pytest.raises(ValueError, match="one shape"):
        tk.gather_merge_topl(b_ids, b_sc[:, :5], *ok[2:])
    with pytest.raises(TypeError, match="succ must be int64"):
        tk.gather_merge_topl(b_ids, b_sc, s.int(), *ok[3:])
    with pytest.raises(TypeError, match="scale must be"):
        tk.gather_merge_topl(b_ids, b_sc, s, r, scale[:2], *ok[5:])
    with pytest.raises(ValueError, match="needs rows"):
        tk.gather_merge_topl(b_ids, b_sc, s, None, *ok[4:])
    with pytest.raises(ValueError, match="L must lie"):
        tk.gather_merge_topl(*ok[:7], 200, 128)
    with pytest.raises(ValueError, match="l_pad"):
        tk.gather_merge_topl(*ok[:7], 10, 96)
    wide = torch.zeros((4, 900), dtype=torch.int64)  # 900 * 10 + 1 > 8192
    with pytest.raises(ValueError, match="candidate width"):
        tk.gather_merge_topl(b_ids, b_sc, wide, *ok[3:])


# ------------------------------------------------------------ on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _rows_with_duplicates(rng, rows, w):
    ids = rng.integers(0, max(2, w // 8), (rows, w)).astype(np.int32)
    ids[rng.random((rows, w)) < 0.2] = tk.PAD_ID
    sc = (rng.random((rows, w)) / w).astype(np.float32)
    return ids, sc


def _gather_case(w):
    """(Lb, D) with D*Lb + 1 of pow2 width w."""
    return {256: (50, 5), 1024: (100, 10), 8192: (100, 81)}[w]


@pytest.mark.gpu
@pytest.mark.parametrize("w", [256, 1024, 8192])
def test_cuda_gather_matches_plain(cuda, w):
    lb, d = _gather_case(w)
    ids, sc, succ, rows = _inputs(7, 2000, lb, 64, d)
    args = [_t(x).to(cuda) for x in (ids, sc, succ, rows)]
    for mode, self_entry, L, l_pad in (("grank", True, 100, 128),
                                       ("mc_combine", True, 100, 128),
                                       ("grank", False, 200, 256)):
        scale, self_scores, post = (x.to(cuda) for x in _port_args(succ, mode))
        if not self_entry:
            self_scores, post = None, None
        before = tk.gather_merge_topl.launches[(max(w, l_pad), l_pad)]
        k = tk.gather_merge_topl(*args, scale, self_scores, post, L, l_pad)
        p = tk.gather_merge_topl_plain(*args, scale, self_scores, post, L, l_pad)
        torch.cuda.synchronize()
        assert tk.gather_merge_topl.launches[(max(w, l_pad), l_pad)] == before + 1
        topl_max_error(k.ids.cpu(), k.scores.cpu(), p.ids.cpu(), p.scores.cpu(), ATOL)


def _bits(t):
    return t.view(torch.int32).cpu()


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(RUN_CASES))
def test_cuda_gather_run_layouts(cuda, case):
    """The kernel on each run layout: against the plain version, and
    bitwise equal over two launches and with the successors permuted."""
    ids, sc, succ, rows, mode, L, l_pad, self_entry = _run_case(case)
    scale, self_scores, post = (x.to(cuda) for x in _port_args(succ, mode))
    if not self_entry:
        self_scores, post = None, None
    perm = succ[:, np.random.default_rng(14).permutation(succ.shape[1])]
    base = [_t(x).to(cuda) for x in (ids, sc)]
    rest = (_t(rows).to(cuda), scale, self_scores, post, L, l_pad)
    w = succ.shape[1] * ids.shape[1] + int(self_entry)
    counter = (max(tk.next_pow2(w), l_pad), l_pad)
    before = tk.gather_merge_topl.launches[counter]
    runs = [tk.gather_merge_topl(*base, _t(s).to(cuda), *rest) for s in (succ, succ, perm)]
    p = tk.gather_merge_topl_plain(*base, _t(succ).to(cuda), *rest)
    torch.cuda.synchronize()
    assert tk.gather_merge_topl.launches[counter] == before + 3
    topl_max_error(runs[0].ids.cpu(), runs[0].scores.cpu(), p.ids.cpu(), p.scores.cpu(), ATOL)
    for x in runs[1:]:
        assert torch.equal(x.ids.cpu(), runs[0].ids.cpu())
        assert torch.equal(_bits(x.scores), _bits(runs[0].scores))


@pytest.mark.gpu
@pytest.mark.parametrize("w", [256, 1024, 8192])
def test_cuda_kernel_is_deterministic_and_order_free(cuda, w):
    rng = np.random.default_rng(8)
    ids, sc = _rows_with_duplicates(rng, 48, w)
    perm = rng.permutation(w)
    a = tk.fused_merge_topl(_t(ids).to(cuda), _t(sc).to(cuda), 128)
    b = tk.fused_merge_topl(_t(ids).to(cuda), _t(sc).to(cuda), 128)
    c = tk.fused_merge_topl(_t(ids[:, perm]).to(cuda), _t(sc[:, perm]).to(cuda), 128)
    for x in (b, c):
        assert torch.equal(x[0].cpu(), a[0].cpu())
        assert torch.equal(_bits(x[1]), _bits(a[1]))
    # the gather entry: two launches, and the successors in another order
    lb, d = _gather_case(w)
    g_ids, g_sc, succ, rows = _inputs(9, 2000, lb, 48, d)
    succ_perm = succ[:, rng.permutation(d)]
    scale, self_scores, post = (x.to(cuda) for x in _port_args(succ, "grank"))
    base = [_t(x).to(cuda) for x in (g_ids, g_sc)]
    runs = [
        tk.gather_merge_topl(*base, _t(s).to(cuda), _t(rows).to(cuda), scale,
                             self_scores, post, 100, 128)
        for s in (succ, succ, succ_perm)
    ]
    for x in runs[1:]:
        assert torch.equal(x.ids.cpu(), runs[0].ids.cpu())
        assert torch.equal(_bits(x.scores), _bits(runs[0].scores))


@pytest.mark.gpu
@pytest.mark.parametrize("w,l_pad", [(2, 2), (64, 8), (512, 512), (8192, 1024)])
def test_cuda_kernel_matches_plain_at_contract_edges(cuda, w, l_pad):
    # a row below the sort width, l_pad below a warp, the block-wide final sort
    rng = np.random.default_rng(10)
    ids, sc = _rows_with_duplicates(rng, 40, w)
    ids_d, sc_d = _t(ids).to(cuda), _t(sc).to(cuda)
    k = tk.fused_merge_topl(ids_d, sc_d, l_pad)
    p = tk.merge_topl_plain(ids_d, sc_d, l_pad)
    torch.cuda.synchronize()
    topl_max_error(k[0].cpu(), k[1].cpu(), p[0].cpu(), p[1].cpu(), ATOL)
