"""Whole GRank runs, the exact oracle and the quality harness of the port
against the JAX package, plus the port's own reference-semantics tiers.

Whole runs compare with sweeps that do not truncate (L = |V|): a truncating
sweep breaks GRank's many exact score ties, and once two runs keep
different tied ids every later sweep reads different baskets.  The
truncating sweeps are held one at a time, from shared state, in
test_torch_merge.py.  Final baskets are compared up to ties at the K cut,
with scores within 1e-5 (float summation order over 20 sweeps).
"""

import importlib

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import approximated_personalized_pagerank_tpu as pj
from approximated_personalized_pagerank_tpu.ops.kendall import kendall_tau_b as j_kendall
from approximated_personalized_pagerank_tpu.models import benchmark as j_bench

import approximated_personalized_pagerank_tpu_torch as pt
from approximated_personalized_pagerank_tpu_torch.models import benchmark as t_bench
from approximated_personalized_pagerank_tpu_torch.ops.kendall import kendall_tau_b as t_kendall
from approximated_personalized_pagerank_tpu_torch.utils.compare import topl_max_error

j_oracle = importlib.import_module(
    "approximated_personalized_pagerank_tpu.models.ppr_single_source"
)


def _random_graph(seed, n=60):
    rng = np.random.default_rng(seed)
    deg = rng.integers(3, 13, n)
    deg[:4] = 0  # dangling nodes
    src = np.repeat(np.arange(n), deg)
    return src, rng.integers(0, n, src.size), n


# ------------------------------------------------------ whole runs vs JAX
@pytest.mark.parametrize("algo_t,algo_j", [("sort", "sort"), ("kernel", "bitonic")])
def test_whole_run_matches_jax(algo_t, algo_j):
    src, dst, n = _random_graph(11)
    gj = pj.Graph.from_edges(src, dst, num_nodes=n)
    gt = pt.Graph.from_edges(src, dst, num_nodes=n)
    K, L = 20, n
    j = pj.grank_baskets(gj, K, L, 20, 0.85, 1e-6, merge_algo=algo_j,
                         engine="sparse", host_loop=True)
    t, info = pt.grank_baskets(gt, K, L, 20, 0.85, 1e-6, merge_algo=algo_t,
                               device="cpu", return_info=True)
    assert t.ids.shape == (n, K) and t.ids.dtype == torch.int32
    assert 1 < info["iterations_ran"] <= 20
    topl_max_error(np.asarray(j.ids), np.asarray(j.scores), t.ids, t.scores, 1e-5)


# ------------------------------------------- the port's reference tiers
def _exact_rows(g, srcs):
    return pt.ppr_single_source_batch(g, srcs, 100, 0.85, 1e-9, device="cpu").numpy()


@pytest.mark.parametrize("algo", ["sort", "kernel", "kernel:512"])
def test_untruncated_same_as_pagerank(rng, algo):
    # with L=|V| nothing is truncated, so GRank equals exact PPR (the
    # reference's sameAsPagerank tier, to 1e-4); "kernel:512" routes the
    # degree-80 node through the hierarchical hub merge (sub = 511//60 = 8)
    n = 60
    src = np.concatenate([np.zeros(80, np.int64), rng.integers(1, n, 200)])
    g = pt.Graph.from_edges(src, rng.integers(0, n, 280), num_nodes=n)
    full = pt.grank_baskets(g, n, n, 100, 0.85, -1.0, merge_algo=algo, device="cpu")
    exact = _exact_rows(g, np.arange(12))
    for r in range(12):
        vec = np.zeros(n)
        live = full.ids[r] >= 0
        vec[full.ids[r][live].numpy()] = full.scores[r][live].numpy()
        assert np.abs(vec - exact[r]).max() < 1e-4


def test_hand_computed_cases():
    # 5-cycle closed form: score(0) = 0.15 / (1 - 0.85**5)
    g = pt.Graph.from_dict({i: [(i + 1) % 5] for i in range(5)})
    res = pt.grank(g, 3, 5, 400, 0.85, 1e-9, device="cpu")
    assert res[0][0] == pytest.approx(0.15 / (1 - 0.85**5), abs=1e-6)
    # star: leaves are dangling, baskets exactly {leaf: 0.15}
    g = pt.Graph.from_dict({0: [1, 2, 3, 4], 1: [], 2: [], 3: [], 4: []})
    res = pt.grank(g, 5, 5, 50, 0.85, 1e-6, merge_algo="kernel", device="cpu")
    assert res[0][0] == pytest.approx(0.15, abs=1e-6)
    for leaf in range(1, 5):
        assert res[0][leaf] == pytest.approx(0.85 / 4 * 0.15, abs=1e-6)
        assert res[leaf] == pytest.approx({leaf: 0.15})
    assert pt.grank(pt.Graph.from_dict({}), 3, 5, 10, 0.85, 1e-4, device="cpu") == {}


def test_tolerance_semantics():
    g = pt.Graph.from_dict({i: [(i + 1) % 6] for i in range(6)})
    _, info = pt.grank_baskets(g, 6, 6, 40, 0.85, -1.0, device="cpu", return_info=True)
    assert info["iterations_ran"] == 40  # negative tolerance never stops
    # an L1 diff never exceeds 2, so a tolerance of 10 stops the loop as
    # soon as each partition has swept once (both maxDiff slots start at
    # the tolerance)
    _, info = pt.grank_baskets(g, 6, 6, 40, 0.85, 10.0, device="cpu", return_info=True)
    assert info["iterations_ran"] == 2


def test_validation_and_device_contract():
    g = pt.Graph.from_dict({0: [1], 1: []})
    for args, msg in [((0, 3, 42, 0.5), "K must be positive"),
                      ((1, 0, 42, 0.5), "L must be positive"),
                      ((5, 3, 42, 0.5), "K must be <= L"),
                      ((3, 3, 0, 0.5), "iterations must be positive"),
                      ((3, 3, 42, 1.5), r"damping must be \[0,1\]")]:
        with pytest.raises(ValueError, match=msg):
            pt.grank(g, *args, 1e-4, device="cpu")
    with pytest.raises(NotImplementedError, match="dense engine"):
        pt.grank_baskets(g, 1, 2, 5, 0.85, 1e-4, engine="dense", device="cpu")
    if not torch.cuda.is_available():
        # device=None means CUDA: without a card it raises, never runs on the CPU
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            pt.grank_baskets(g, 1, 2, 5, 0.85, 1e-4)


# ------------------------------------------ oracle, kendall, harness
def test_oracle_matches_jax():
    src, dst, n = _random_graph(4, n=80)
    gj = pj.Graph.from_edges(src, dst, num_nodes=n)
    gt = pt.Graph.from_edges(src, dst, num_nodes=n)
    srcs = np.array([0, 5, 17, 40, 79], dtype=np.int32)
    j = np.asarray(j_oracle.ppr_single_source_batch(gj, srcs, 100, 0.85, 1e-4))
    t = pt.ppr_single_source_batch(gt, srcs, 100, 0.85, 1e-4, device="cpu").numpy()
    # same pushes, sums over predecessors in another order: float32 noise
    np.testing.assert_allclose(t, j, atol=1e-6, rtol=0)
    d = pt.ppr_single_source(gt, 100, 0.85, 1e-4, 5, device="cpu")
    assert d == pytest.approx(pj.ppr_single_source(gj, 100, 0.85, 1e-4, 5), abs=1e-6)
    with pytest.raises(ValueError, match="source node not part of the graph"):
        pt.ppr_single_source(gt, 100, 0.85, 1e-4, 999, device="cpu")


def test_kendall_matches_jax(rng):
    x = rng.integers(0, 5, (20, 12)).astype(np.float32)  # many ties
    y = (x + rng.integers(-2, 3, x.shape)).astype(np.float32)
    valid = rng.random(x.shape) < 0.8
    j = np.asarray(j_kendall(jnp.asarray(x), jnp.asarray(y), jnp.asarray(valid)))
    t = t_kendall(torch.as_tensor(x), torch.as_tensor(y), torch.as_tensor(valid)).numpy()
    np.testing.assert_allclose(t, j, atol=1e-6, rtol=0)


def test_benchmark_sampled_matches_jax(rng):
    src, dst, n = _random_graph(8, n=80)
    gj = pj.Graph.from_edges(src, dst, num_nodes=n)
    gt = pt.Graph.from_edges(src, dst, num_nodes=n)
    ids = np.stack([rng.permutation(n)[:10] for _ in range(n)]).astype(np.int32)
    ids[rng.random((n, 10)) < 0.2] = -1
    sc = np.where(ids >= 0, rng.random((n, 10)), 0).astype(np.float32)
    sj = j_bench.sample_result(pj.Baskets(jnp.asarray(ids), jnp.asarray(sc)), gj, 30, True, seed=3)
    st = t_bench.sample_result(pt.Baskets(torch.as_tensor(ids), torch.as_tensor(sc)), gt, 30, True, seed=3)
    assert np.array_equal(st.sources, sj.sources)  # same sampled sources
    assert np.array_equal(st.ids, sj.ids)
    (stat_j,) = j_bench.benchmark_sampled([sj], gj, batch_size=8)
    (stat_t,) = t_bench.benchmark_sampled([st], gt, batch_size=8, device="cpu")
    assert set(stat_t) == set(stat_j)
    for k in stat_j:
        assert stat_t[k] == pytest.approx(stat_j[k], abs=1e-5), k
    # node 0 is dangling, so a strict sample of {0: ...} is empty: all -1
    empty = t_bench.benchmark_algorithm({0: {}}, gt, 5, True, device="cpu")
    assert set(empty.values()) == {-1.0}
