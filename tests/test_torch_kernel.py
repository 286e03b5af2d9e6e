"""The port's basket ops and fused merge against the JAX package.

On the CPU the merge wrapper runs the kernel's plain PyTorch version; it is
held against the JAX package's Pallas kernel (interpret mode) and its XLA
bitonic pipeline.  Tolerances: ids must agree up to equal scores at the
truncation boundary, and scores within 1e-6, the float error of summing a
run of equal ids in another order when rows hold at most unit mass.  The
CUDA kernel itself is held against the plain version in the ``gpu`` tests.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from approximated_personalized_pagerank_tpu.ops import basket as jb
from approximated_personalized_pagerank_tpu.ops import merge as jm
from approximated_personalized_pagerank_tpu.ops.pallas.merge_kernel import (
    fused_merge_topl as j_fused,
)

from approximated_personalized_pagerank_tpu_torch.ops import basket as tb
from approximated_personalized_pagerank_tpu_torch.ops import merge as tm
from approximated_personalized_pagerank_tpu_torch.ops import merge_kernel as tk
from approximated_personalized_pagerank_tpu_torch.utils.compare import (
    ToplMismatch,
    topl_max_error,
)

ATOL = 1e-6


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _candidates(rng, rows, w, pad=-1, hi=None):
    """[rows, w] candidate rows of five kinds with at most unit mass per
    row: heavy duplicates, all-dead rows, few live entries, all-zero live
    scores (damping 1), and sparse duplicates."""
    ids = np.full((rows, w), pad, dtype=np.int32)
    scores = np.zeros((rows, w), dtype=np.float32)
    for r in range(rows):
        kind = r % 5
        if kind == 1:
            continue
        live = {0: w, 2: int(rng.integers(1, 60)), 3: w // 3, 4: w - w // 7}[kind]
        top = {0: max(2, w // 16), 2: 500, 3: 40, 4: hi or 4 * w}[kind]
        ids[r, :live] = rng.integers(0, top, live)
        s = rng.random(live).astype(np.float32)
        scores[r, :live] = 0.0 if kind == 3 else s / s.sum()
        perm = rng.permutation(w)
        ids[r], scores[r] = ids[r, perm], scores[r, perm]
    return ids, scores


# ------------------------------------------------------------- basket ops
def test_sort_rows_by_id_matches(rng):
    ids = rng.integers(-1, 20, (16, 64)).astype(np.int32)
    scores = rng.random((16, 64)).astype(np.float32)
    ji, js = jb.sort_rows_by_id(jnp.asarray(ids), jnp.asarray(scores))
    ti, ts = tb.sort_rows_by_id(_t(ids), _t(scores))
    # both sorts are stable, so payloads line up exactly
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    assert np.array_equal(ts.numpy(), np.asarray(js))


def test_combine_sorted_runs_matches(rng):
    ids = np.sort(rng.integers(-1, 12, (16, 64)).astype(np.int32), axis=1)
    scores = (rng.random((16, 64)) / 64).astype(np.float32)
    ji, js = jb.combine_sorted_runs(jnp.asarray(ids), jnp.asarray(scores))
    ti, ts = tb.combine_sorted_runs(_t(ids), _t(scores))
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    # JAX sums by prefix-sum differences, the port by segment sums
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=ATOL, rtol=0)


@pytest.mark.parametrize("k", [1, 5, 32, 48])
def test_keep_top_matches(rng, k):
    ids = np.stack([rng.permutation(500)[:32] for _ in range(16)]).astype(np.int32)
    ids[rng.random((16, 32)) < 0.3] = -1
    scores = rng.random((16, 32)).astype(np.float32)
    scores[::4] = 0.0  # zero scores on live ids still beat dead slots
    j = jb.keep_top(jnp.asarray(ids), jnp.asarray(scores), k)
    t = tb.keep_top(_t(ids), _t(scores), k)
    assert t.ids.shape == (16, k)
    topl_max_error(np.asarray(j.ids), np.asarray(j.scores), t.ids, t.scores, 0.0)
    c = tb.keep_top_chunked(_t(ids), _t(scores), k, elem_budget=100)
    assert torch.equal(c.ids, t.ids) and torch.equal(c.scores, t.scores)


@pytest.mark.parametrize("k", [1, 7, 20, 40])
def test_keep_top_cuts_ties_as_jax(rng, k):
    """Scores from three values, so most of a row ties: ids, order and
    scores equal JAX's keep_top to the bit (jax.lax.top_k puts equal scores
    in ascending column order; its sort branch, k >= W, too)."""
    ids = np.stack([rng.permutation(500)[:32] for _ in range(16)]).astype(np.int32)
    ids[rng.random((16, 32)) < 0.3] = -1
    scores = rng.choice(np.array([0.25, 0.5, 1.0], np.float32), (16, 32))
    scores[ids < 0] = 0.0
    j = jb.keep_top(jnp.asarray(ids), jnp.asarray(scores), k)
    t = tb.keep_top(_t(ids), _t(scores), k)
    np.testing.assert_array_equal(t.ids.numpy(), np.asarray(j.ids))
    np.testing.assert_array_equal(t.scores.numpy(), np.asarray(j.scores))


def test_norm1_and_jaccard_match(rng):
    a_ids = np.stack([rng.permutation(40)[:10] for _ in range(12)]).astype(np.int32)
    b_ids = np.stack([rng.permutation(40)[:10] for _ in range(12)]).astype(np.int32)
    a_ids[3, 5:] = -1
    b_ids[3] = -1
    a_sc = (rng.random((12, 10)) / 10).astype(np.float32)
    b_sc = (rng.random((12, 10)) / 10).astype(np.float32)
    jn = jb.norm1_rows(jb.Baskets(jnp.asarray(a_ids), jnp.asarray(a_sc)),
                       jb.Baskets(jnp.asarray(b_ids), jnp.asarray(b_sc)))
    tn = tb.norm1_rows(tb.Baskets(_t(a_ids), _t(a_sc)), tb.Baskets(_t(b_ids), _t(b_sc)))
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), atol=ATOL, rtol=0)
    jj = jb.jaccard_rows(jnp.asarray(a_ids), jnp.asarray(b_ids))
    tj = tb.jaccard_rows(_t(a_ids), _t(b_ids))
    assert np.array_equal(tj.numpy(), np.asarray(jj))
    empty = torch.full((1, 4), -1, dtype=torch.int32)
    assert tb.jaccard_rows(empty, empty).item() == 1.0


# ---------------------------------------------------------- fused merge
@pytest.mark.parametrize("w,l_pad", [(256, 128), (512, 128), (512, 256)])
def test_plain_merge_matches_pallas_kernel(rng, w, l_pad):
    ids, scores = _candidates(rng, 40, w, pad=tk.PAD_ID)
    j_ids, j_sc = j_fused(jnp.asarray(ids), jnp.asarray(scores), l_pad, interpret=True)
    t_ids, t_sc = tk.fused_merge_topl(_t(ids), _t(scores), l_pad)
    assert t_ids.shape == (40, l_pad) and t_ids.dtype == torch.int32
    assert not bool((t_ids[1::5] >= 0).any())  # all-PAD rows stay empty
    topl_max_error(np.asarray(j_ids), np.asarray(j_sc), t_ids, t_sc, ATOL)
    assert tk.fused_merge_topl.launches == {}  # the CPU path launches nothing


@pytest.mark.parametrize("algo_t,algo_j", [("kernel", "bitonic"), ("sort", "sort")])
def test_merge_rows_matches_jax_pipeline(rng, algo_t, algo_j):
    # W=1000 pads to 1024 on the network paths; L=100 -> l_pad=128
    ids, scores = _candidates(rng, 30, 1000, pad=-1, hi=3000)
    merge = jax.jit(functools.partial(jm._merge_rows, L=100, algo=algo_j))
    j = merge(jnp.asarray(ids), jnp.asarray(scores))
    t = tm._merge_rows(_t(ids), _t(scores), 100, algo_t)
    assert t.ids.shape == (30, 100)
    topl_max_error(np.asarray(j.ids), np.asarray(j.scores), t.ids, t.scores, ATOL)


def test_plain_merge_damping_one_zero_scores():
    # a live self entry of score 0 must beat every dead slot
    ids = np.full((2, 256), tk.PAD_ID, dtype=np.int32)
    scores = np.zeros((2, 256), dtype=np.float32)
    ids[0, 7] = 42
    ids[1, :3] = [5, 5, 9]
    t_ids, t_sc = tk.fused_merge_topl(_t(ids), _t(scores), 128)
    assert t_ids[0, 0].item() == 42 and (t_ids[0, 1:] == -1).all()
    assert sorted(t_ids[1, :2].tolist()) == [5, 9] and (t_ids[1, 2:] == -1).all()
    assert float(t_sc.abs().sum()) == 0.0


def test_wrapper_rejects_bad_input():
    ids = torch.zeros((2, 256), dtype=torch.int32)
    sc = torch.zeros((2, 256))
    with pytest.raises(ValueError, match="power of two"):
        tk.fused_merge_topl(ids[:, :200], sc[:, :200], 128)
    with pytest.raises(ValueError, match="l_pad"):
        tk.fused_merge_topl(ids, sc, 512)
    with pytest.raises(TypeError, match="int32"):
        tk.fused_merge_topl(ids.long(), sc, 128)
    with pytest.raises(ValueError, match="one shape"):
        tk.fused_merge_topl(ids, sc[:1], 128)


def test_comparator_rejects_real_differences():
    a_ids = np.array([[1, 2, 3]])
    a_sc = np.array([[0.5, 0.3, 0.1]])
    # a boundary tie may swap ids ...
    topl_max_error(a_ids, a_sc, np.array([[1, 2, 4]]), a_sc, ATOL)
    # ... a different id above the boundary may not
    with pytest.raises(ToplMismatch):
        topl_max_error(a_ids, a_sc, np.array([[1, 5, 3]]), a_sc, ATOL)
    with pytest.raises(ToplMismatch):
        topl_max_error(a_ids, a_sc, a_ids, a_sc + 1e-3, ATOL)


# ------------------------------------------------------------ on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("w", [256, 1024, 8192])
def test_cuda_kernel_matches_plain(rng, cuda, w):
    ids, scores = _candidates(rng, 60, w, pad=tk.PAD_ID)
    ids_d, sc_d = _t(ids).to(cuda), _t(scores).to(cuda)
    before = tk.fused_merge_topl.launches[(w, 128)]
    k_ids, k_sc = tk.fused_merge_topl(ids_d, sc_d, 128)
    p_ids, p_sc = tk.merge_topl_plain(ids_d, sc_d, 128)
    torch.cuda.synchronize()
    assert tk.fused_merge_topl.launches[(w, 128)] == before + 1
    topl_max_error(k_ids.cpu(), k_sc.cpu(), p_ids.cpu(), p_sc.cpu(), ATOL)
