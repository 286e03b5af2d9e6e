"""The port's source-sharded walks, sharded MCCompletePathV2, sharded
oracle and sharded quality harness, against their unsharded runs and the
JAX package's sharded runs (its mesh on the 8 virtual CPU devices of
tests/conftest.py; the port's shards are ``[cpu] * D``).

MC runs compare at L >= |V|: nothing is cut, so ids must agree exactly,
and scores within 1e-6 (not tests/test_sharding.py's rounding to five
decimals).
"""

import numpy as np
import pytest
import torch

import approximated_personalized_pagerank_tpu as pj
from approximated_personalized_pagerank_tpu.ops.walk import walk_baskets as j_walk_baskets
from approximated_personalized_pagerank_tpu.parallel.mesh import make_mesh as j_make_mesh

import approximated_personalized_pagerank_tpu_torch as pt
from approximated_personalized_pagerank_tpu_torch.ops import walk as tw

CPU = torch.device("cpu")
DAMPING = 0.85


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: many tiny tensor ops, on cores the suite's
    parallel workers share."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def cpu_mesh(d):
    return pt.make_mesh(d, [CPU] * d)


def _edges(seed, n):
    rng = np.random.default_rng(seed)
    deg = rng.integers(0, 6, n)
    deg[:2] = 0  # dangling nodes
    src = np.repeat(np.arange(n), deg)
    return src, rng.integers(0, n, src.size), n


def _dicts(b):
    ids, sc = np.asarray(b.ids), np.asarray(b.scores)
    return [dict(zip(i[i >= 0].tolist(), s[i >= 0].tolist())) for i, s in zip(ids, sc)]


def _assert_same_rows(a, b, atol):
    for v, (x, y) in enumerate(zip(_dicts(a), _dicts(b))):
        assert set(x) == set(y), v
        assert max((abs(x[k] - y[k]) for k in x), default=0.0) <= atol, v


# ------------------------------------------------------------------ walks
@pytest.mark.parametrize("n,d,chunk", [(50, 4, 20), (48, 4, None), (37, 3, 12)])
def test_sharded_walks_bitwise_equal_unsharded(n, d, chunk):
    g = pt.Graph.from_edges(*_edges(1, n)[:2], num_nodes=n)
    kw = dict(seed=5, return_info=True, source_chunk=chunk)
    if chunk is not None:  # both plans take it as it is
        assert tw._sharded_trace_chunks(n, 300, DAMPING, chunk, None, 32, d)[0] == chunk
        assert tw._trace_chunks(n, 300, DAMPING, chunk, None, 32)[0] == chunk
    a, ai = pt.walk_baskets(g, 20, 300, DAMPING, device="cpu", **kw)
    b, bi = pt.walk_baskets(g, 20, 300, DAMPING, mesh=cpu_mesh(d), **kw)
    assert ai == bi
    assert torch.equal(a.ids, b.ids) and torch.equal(a.scores, b.scores)


def test_sharded_walk_plan_rounds_after_the_clamp():
    # the JAX mesh branch: clamp to the row count, then round up to D
    # (its ops/walk.py:510-516), and no MAX_MAP_CHUNKS clamp
    assert tw._sharded_trace_chunks(50, 300, DAMPING, None, None, 32, 4)[0] == 52
    assert tw._trace_chunks(50, 300, DAMPING, None, None, 32)[0] == 50
    assert tw._sharded_trace_chunks(10**6, 1000, DAMPING, None, None, 32, 4)[0] == 9364
    assert tw._trace_chunks(10**6, 1000, DAMPING, None, None, 32)[0] == 9344


def test_sharded_walks_equal_jax_mesh_walks():
    n = 30  # not a multiple of 4: the chunk is padded to 32 on both sides
    src, dst, _ = _edges(2, n)
    gj = pj.Graph.from_edges(src, dst, num_nodes=n)
    gt = pt.Graph.from_edges(src, dst, num_nodes=n)
    j, ji = j_walk_baskets(gj, n, 300, DAMPING, seed=9, return_info=True,
                           mesh=j_make_mesh(4))
    t, ti = pt.walk_baskets(gt, n, 300, DAMPING, seed=9, return_info=True,
                            mesh=cpu_mesh(4))
    assert ti == ji
    # L = |V|: equal counts, so equal rows; equal counts may sit in
    # another order (a tie), so rows compare as maps
    _assert_same_rows(j, t, 0.0)


# --------------------------------------------------------------------- MC
@pytest.mark.parametrize("graph", ["two_succ", "random30"])
def test_mc_multi_matches_jax(graph):
    if graph == "two_succ":  # tests/test_sharding.py:111-117's graph
        n = 24
        adj = {i: [(i + 1) % n, (i + 5) % n] for i in range(n)}
        gj, gt = pj.Graph.from_dict(adj), pt.Graph.from_dict(adj)
    else:
        src, dst, n = _edges(3, 30)
        gj = pj.Graph.from_edges(src, dst, num_nodes=n)
        gt = pt.Graph.from_edges(src, dst, num_nodes=n)
    j = pj.mccompletepathv2_multi_baskets(gj, n, n, 300, DAMPING, 4, seed=7)
    t = pt.mccompletepathv2_multi_baskets(gt, n, n, 300, DAMPING, 4, seed=7, device="cpu")
    assert t.ids.shape == (n, n) and t.ids.dtype == torch.int32
    _assert_same_rows(j, t, 1e-6)


def test_mc_multi_equals_unsharded():
    n = 24  # a multiple of the shard count: both walk plans take one 24-row chunk
    g = pt.Graph.from_dict({i: [(i + 1) % n, (i + 5) % n, (i + 7) % n] for i in range(n)})
    kw = dict(seed=7, return_info=True)
    a, ai = pt.mccompletepathv2_baskets(g, 5, 10, 300, DAMPING, engine="sparse",
                                        device="cpu", **kw)
    b, bi = pt.mccompletepathv2_baskets(g, 5, 10, 300, DAMPING, mesh=cpu_mesh(4), **kw)
    assert ai == bi
    assert torch.equal(a.ids, b.ids) and torch.equal(a.scores, b.scores)
    as_dict = pt.mccompletepathv2_multi(g, 5, 10, 300, DAMPING, 4, seed=7, device="cpu")
    assert as_dict == pt.baskets_to_dict(b, g)


def test_mc_dangling_keep_their_walk_basket():
    g = pt.Graph.from_dict({0: [1, 2], 1: [2], 2: [], 3: []})
    b = pt.mccompletepathv2_multi_baskets(g, 2, 4, 200, DAMPING, 2, seed=1, device="cpu")
    for v in (2, 3):
        assert b.ids[v, 0] == v and float(b.scores[v, 0]) == 1.0


# ------------------------------------------------------------ the oracle
def test_sharded_oracle_equals_unsharded():
    n = 30
    rng = np.random.default_rng(12345)
    g = pt.Graph.from_edges(rng.integers(0, n, 150), rng.integers(0, n, 150), num_nodes=n)
    sources = [0, 3, 7, 11, 19]  # 5 sources over 4 shards: exercises the padding
    a = pt.ppr_single_source_batch(g, sources, 50, DAMPING, 1e-6, device="cpu")
    b = pt.ppr_single_source_batch(g, sources, 50, DAMPING, 1e-6, mesh=cpu_mesh(4))
    assert b.shape == (5, n)
    assert float((a - b).abs().max()) <= 1e-6


def test_benchmark_sampled_with_a_mesh_equals_unsharded():
    n = 60
    rng = np.random.default_rng(4)
    g = pt.Graph.from_edges(rng.integers(0, n, 400), rng.integers(0, n, 400), num_nodes=n)
    baskets = pt.grank_baskets(g, 5, 20, 10, DAMPING, 1e-4, engine="sparse", device="cpu")
    sample = pt.sample_result(baskets, g, 10, True, seed=0)
    (plain,) = pt.benchmark_sampled([sample], g, device="cpu", batch_size=4)
    (sharded,) = pt.benchmark_sampled([sample], g, mesh=cpu_mesh(3))
    assert plain.keys() == sharded.keys()
    for k in plain:
        assert sharded[k] == pytest.approx(plain[k], abs=1e-6), k
    whole = pt.benchmark_algorithm(baskets, g, 10, True, seed=0, mesh=cpu_mesh(2))
    for k in plain:
        assert whole[k] == pytest.approx(plain[k], abs=1e-6), k
