"""The port's dense engine (ops/dense.py) against the JAX package's, on the
CPU in float32, on the same numpy-seeded inputs.

Whole GRank runs compare on the JAX package's five small topologies
(tests/test_dense.py), through both truncation modes; the products sum in
another order in the two packages, so ids are compared up to equal scores
at a cut and scores within 1e-6.  A truncating half-sweep is held from one
shared state (the JAX package's ``_dense_init`` output) on a tie-rich
graph, where the initial truncation itself must match bit for bit.  Dense
MC compares at L >= |V|, where nothing is cut: ids equal, scores within
1e-6, walk counters equal.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import approximated_personalized_pagerank_tpu as pj

import approximated_personalized_pagerank_tpu_torch as pt
from approximated_personalized_pagerank_tpu_torch.ops import dense as td
from approximated_personalized_pagerank_tpu_torch.utils.compare import topl_max_error
from approximated_personalized_pagerank_tpu_torch.utils.convert import (
    dense_state_from_numpy,
    graph_from_arrays,
)

jd = importlib.import_module("approximated_personalized_pagerank_tpu.ops.dense")

ATOL = 1e-6
DAMPING = 0.85


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite's parallel workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _topology(name):
    if name == "cycle":
        return {i: [(i + 1) % 8] for i in range(8)}
    if name == "star":
        return {0: list(range(1, 7)), **{i: [0] for i in range(1, 7)}}
    if name == "complete":
        return {i: [j for j in range(9) if j != i] for i in range(9)}
    if name == "dangling":
        return {0: [1, 2], 1: [2], 2: [], 3: []}
    return {0: [0, 1, 1], 1: [0], 2: [0, 0, 0]}  # parallel edges + self loop


def _both(adj):
    return pj.Graph.from_dict(adj), pt.Graph.from_dict(adj)


def _dicts(b):
    ids, sc = np.asarray(b.ids), np.asarray(b.scores)
    return [dict(zip(i[i >= 0].tolist(), s[i >= 0].tolist())) for i, s in zip(ids, sc)]


# ------------------------------------------------------------ engine choice
def test_engine_resolution_matches_jax():
    assert (td.DENSE_MAX_NODES, td.MC_DENSE_MAX_NODES) == (
        jd.DENSE_MAX_NODES, jd.MC_DENSE_MAX_NODES)
    for n in (0, 1, 100, 16_384, 16_385, 32_768, 32_769, 10**7):
        for engine in ("auto", "sparse", "dense"):
            for cap in (None, td.MC_DENSE_MAX_NODES):
                assert td.use_dense_engine(n, engine, cap) == jd.use_dense_engine(
                    n, engine, None, cap), (n, engine, cap)
    assert td.use_dense_engine(16_384, "auto") and not td.use_dense_engine(16_385, "auto")
    assert td.use_dense_engine(32_768, "auto", td.MC_DENSE_MAX_NODES)
    assert not td.use_dense_engine(32_769, "auto", td.MC_DENSE_MAX_NODES)
    with pytest.raises(ValueError, match="unknown engine 'mxu'"):
        td.use_dense_engine(100, "mxu")
    assert td.default_matmul_dtype("cpu") == torch.float32
    assert td.default_matmul_dtype("cuda") == torch.bfloat16


# ----------------------------------------------------- whole GRank runs vs JAX
@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("topology", ["cycle", "star", "complete", "dangling", "parallel"])
def test_dense_grank_matches_jax(topology, exact):
    gj, gt = _both(_topology(topology))
    configs = [(5, 10, 25, 1e-4)]
    if topology in ("cycle", "dangling", "parallel"):
        configs.append((3, 3, 7, -1.0))
    for K, L, iters, tol in configs:
        j, ji = pj.grank_baskets(gj, K, L, iters, DAMPING, tol, engine="dense",
                                 matmul_dtype=np.float32, exact_trunc=exact,
                                 return_info=True)
        t, ti = pt.grank_baskets(gt, K, L, iters, DAMPING, tol, engine="dense",
                                 exact_trunc=exact, return_info=True, device="cpu")
        assert ti == ji
        assert t.ids.shape == (gt.num_nodes, K) and t.ids.dtype == torch.int32
        topl_max_error(np.asarray(j.ids), np.asarray(j.scores), t.ids, t.scores, ATOL)


def test_return_info_flops_match_jax():
    # a tolerance stop after an odd number of half-sweeps, unequal partitions
    rng = np.random.default_rng(3)
    src, dst = rng.integers(0, 70, 400), rng.integers(0, 70, 400)
    gj = pj.Graph.from_edges(src, dst, num_nodes=70)
    gt = pt.Graph.from_edges(src, dst, num_nodes=70)
    for tol in (1e-3, -1.0):
        _, ji = pj.grank_baskets(gj, 5, 10, 9, DAMPING, tol, engine="dense",
                                 matmul_dtype=np.float32, return_info=True)
        _, ti = pt.grank_baskets(gt, 5, 10, 9, DAMPING, tol, engine="dense",
                                 return_info=True, device="cpu")
        assert ti == ji and ti["flops"] > 0


# ------------------------------------------- one half-sweep from shared state
@pytest.mark.parametrize("exact", [True, False])
def test_truncating_half_sweep_from_shared_state(exact):
    """300 nodes of out-degree 12 at L=8: every init row ties at its cut
    (all successors score damping/12), so the initial truncations must
    agree bit for bit; then one half-sweep from the JAX package's state."""
    rng = np.random.default_rng(17)
    n, L = 300, 8
    src = np.repeat(np.arange(n), 12)
    gj = pj.Graph.from_edges(src, rng.integers(0, n, src.size), num_nodes=n)
    gt = graph_from_arrays(gj.indptr, gj.indices)
    plan = jd.build_dense_plan(gj, DAMPING)
    tplan = td.build_dense_plan(gt, DAMPING)
    assert plan[:4] == tplan[:4]  # n, n0, n1, n_pad
    for a, b in zip((plan.perm,) + plan.edges0 + plan.edges1,
                    (tplan.perm,) + tplan.edges0 + tplan.edges1):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    kw = dict(n=plan.n, n0=plan.n0, n1=plan.n1)
    state = jd._dense_init(
        *(jnp.asarray(x) for x in plan.edges0 + plan.edges1), jnp.float32(DAMPING),
        n_pad=plan.n_pad, L=L, mm_dtype=jnp.dtype(jnp.float32),
        recall=jd.DENSE_TRUNC_RECALL, exact_trunc=exact, **kw)
    A0, A1, S = dense_state_from_numpy(*(np.asarray(x) for x in state), "cpu")
    # the port's own init: the same matrices, bit for bit
    for mine, theirs in zip(td._dense_init(tplan, DAMPING, L, torch.float32, exact, "cpu"),
                            (A0, A1, S)):
        assert torch.equal(mine, theirs)
    kept = (S[:n] > 0).sum(dim=1)  # the cut fell inside ties: ties kept or not
    assert bool((kept == L).all()) if exact else bool((kept > L).all())

    j, jh = jd._dense_run(*state, jnp.asarray(plan.perm), jnp.float32(DAMPING),
                          jnp.float32(1e-4), jnp.int32(1), L=L, K=L, compute_diff=True,
                          recall=jd.DENSE_TRUNC_RECALL, exact_trunc=exact, **kw)
    perm = torch.as_tensor(plan.perm).long()
    t, th = td._dense_run(A0, A1, S, perm, DAMPING, 1e-4, 1, plan.n, plan.n0,
                          plan.n1, L, L, True, exact)
    assert th == int(jh) == 1
    topl_max_error(np.asarray(j.ids), np.asarray(j.scores), t.ids, t.scores, ATOL)


# ------------------------------------------------------------ dense MC vs JAX
@pytest.mark.parametrize("choice,passes", [("uniform", 2), ("stratified", 1)])
def test_dense_mc_matches_jax(choice, passes):
    rng = np.random.default_rng(5)
    n = 40
    deg = rng.integers(0, 8, n)
    deg[:3] = 0  # dangling nodes
    src = np.repeat(np.arange(n), deg)
    dst = rng.integers(0, n, src.size)
    gj = pj.Graph.from_edges(src, dst, num_nodes=n)
    gt = pt.Graph.from_edges(src, dst, num_nodes=n)
    kw = dict(seed=3, return_info=True, successor_choice=choice,
              combine_passes=passes, engine="dense")
    j, ji = pj.mccompletepathv2_baskets(gj, n, n, 200, DAMPING,
                                        matmul_dtype=np.float32, **kw)
    t, ti = pt.mccompletepathv2_baskets(gt, n, n, 200, DAMPING, device="cpu", **kw)
    assert ti == ji
    assert set(ti) == {"walk_steps", "abandoned_walks", "total_walks"}
    assert t.ids.shape == (n, n) and t.ids.dtype == torch.int32
    for v, (a, b) in enumerate(zip(_dicts(j), _dicts(t))):
        assert set(a) == set(b), v
        assert max(abs(a[k] - b[k]) for k in a) <= ATOL, v
    assert (torch.diff(t.scores, dim=1) <= 0).all()


def test_mc_auto_takes_dense_up_to_its_cutoff():
    g = pt.Graph.from_dict({0: [1, 2], 1: [2], 2: [0], 3: [0]})
    auto = pt.mccompletepathv2_baskets(g, 3, 4, 300, DAMPING, seed=9, device="cpu")
    dense = pt.mccompletepathv2_baskets(g, 3, 4, 300, DAMPING, seed=9, engine="dense",
                                        device="cpu")
    assert torch.equal(auto.ids, dense.ids) and torch.equal(auto.scores, dense.scores)


# --------------------------------------------------------------- edge cases
def test_dense_edgeless_graph():
    # every node in partition 0; partition 1 is empty
    g = pt.Graph.from_dict({i: [] for i in range(5)})
    res = pt.grank(g, 3, 5, 10, DAMPING, 1e-4, engine="dense", device="cpu")
    for i in range(5):
        assert res[i] == pytest.approx({i: 0.15})
    mc = pt.mccompletepathv2(g, 3, 5, 100, DAMPING, seed=1, engine="dense", device="cpu")
    for i in range(5):
        assert mc[i] == pytest.approx({i: 1.0})


def test_dense_single_node_self_loop():
    g = pt.Graph.from_dict({0: [0]})
    res = pt.grank(g, 1, 1, 100, DAMPING, 1e-8, engine="dense", device="cpu")
    # s = 0.15 + 0.85 s  =>  s = 1
    assert res[0][0] == pytest.approx(1.0, abs=1e-4)


def test_dense_same_as_pagerank():
    # untruncated dense GRank converges to exact PPR (the sameAsPagerank tier)
    rng = np.random.default_rng(12345)
    n = 30
    g = pt.Graph.from_edges(rng.integers(0, n, 400), rng.integers(0, n, 400),
                            num_nodes=n)
    res = pt.grank(g, n, n, 100, DAMPING, -1.0, engine="dense", device="cpu")
    for src in range(0, n, 5):
        exact = pt.ppr_single_source(g, 100, DAMPING, -1.0, src, device="cpu")
        for k in set(res[src]) | set(exact):
            assert res[src].get(k, 0.0) == pytest.approx(exact.get(k, 0.0), abs=1e-4)
