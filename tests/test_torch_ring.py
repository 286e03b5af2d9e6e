"""The port's ring-sharded GRank (parallel/ring.py, parallel/mesh.py)
against the JAX package's ring, and the port's own shard-count invariance
(tests/test_sharding.py's oracle, the analogue of grankMultiThreadTest.cc's
parallel == serial tests).

The JAX ring runs on the 8 virtual CPU devices tests/conftest.py provides;
the port's shards are ``[cpu] * D``.  The port's ``sort`` pipeline is held
against JAX ``sort``, its ``kernel`` pipeline (the kernel's plain version
on the CPU) against JAX ``bitonic``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import approximated_personalized_pagerank_tpu as pj
from approximated_personalized_pagerank_tpu.ops.basket import Baskets as JBaskets
from approximated_personalized_pagerank_tpu.parallel import ring as jring
from approximated_personalized_pagerank_tpu.parallel.mesh import (
    make_mesh as j_make_mesh,
    put_sharded as j_put,
)
from approximated_personalized_pagerank_tpu.utils.synthetic import powerlaw_graph

import approximated_personalized_pagerank_tpu_torch as pt
from approximated_personalized_pagerank_tpu_torch.ops.dense import use_dense_engine
from approximated_personalized_pagerank_tpu_torch.parallel import ring as tring
from approximated_personalized_pagerank_tpu_torch.utils.compare import topl_max_error
from approximated_personalized_pagerank_tpu_torch.utils.convert import graph_from_arrays

CPU = torch.device("cpu")
DAMPING = 0.85
ALGOS = [("sort", "sort"), ("kernel", "bitonic")]


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


def _random_graph(seed, n, lo=3, hi=16):
    rng = np.random.default_rng(seed)
    deg = rng.integers(lo, hi, n)
    deg[:3] = 0  # dangling nodes
    src = np.repeat(np.arange(n), deg)
    return src, rng.integers(0, n, src.size), n


def _graph_pair(src, dst, n):
    return pj.Graph.from_edges(src, dst, num_nodes=n), pt.Graph.from_edges(src, dst, num_nodes=n)


# --------------------------------------------------------------- the plan
@pytest.fixture(scope="module")
def plan_graphs():
    gj = powerlaw_graph(3000, 30000, seed=3)
    return gj, graph_from_arrays(gj.indptr, gj.indices)


PLAN_CASES = (
    [(part, d, algos, jring.DEFAULT_RING_ELEM_BUDGET)
     for d in (1, 2, 4, 8) for part in (0, 1, None) for algos in ALGOS]
    + [(part, 4, ("sort", "sort"), 64) for part in (0, 1, None)]
)


@pytest.mark.parametrize("part,d,algos,budget", PLAN_CASES)
def test_ring_plan_byte_equal_to_jax(plan_graphs, part, d, algos, budget):
    gj, gt = plan_graphs
    L = 20
    j = jring.build_ring_plan(gj, part, d, L, budget, algo=algos[1])
    t = tring.build_ring_plan(gt, part, d, L, budget, algo=algos[0])
    assert t.dangling_rows.dtype == j.dangling_rows.dtype
    np.testing.assert_array_equal(t.dangling_rows, j.dangling_rows)
    assert [[b.cap for b in r] for r in t.rounds] == [[b.cap for b in r] for r in j.rounds]
    for rt, rj in zip(t.rounds, j.rounds):
        for bt, bj in zip(rt, rj):
            assert bt.rows.dtype == bj.rows.dtype and bt.succ.dtype == bj.succ.dtype
            np.testing.assert_array_equal(bt.rows, bj.rows)
            np.testing.assert_array_equal(bt.succ, bj.succ)
    if budget == 64:
        assert len(t.rounds) > 1, "the budget did not split the plan into rounds"


# ------------------------------------------------- one half-sweep vs JAX
def _state(n_pad, n, L, seed):
    """A basket state [n_pad, L]: distinct ids a row, descending scores of
    at most unit mass, some dead slots."""
    rng = np.random.default_rng(seed)
    ids = np.full((n_pad, L), -1, np.int32)
    scores = np.zeros((n_pad, L), np.float32)
    for r in range(n):
        live = int(rng.integers(1, L + 1))
        ids[r, :live] = rng.choice(n, live, replace=False)
        s = np.sort(rng.random(live).astype(np.float32))[::-1]
        scores[r, :live] = s / (2 * s.sum())
    return ids, scores


def _jax_half_sweep(gj, ids0, scores0, L, algo, d):
    mesh = j_make_mesh(d)
    s = jring._shard_size(gj.num_nodes, d)
    plan = jring.build_ring_plan(gj, 0, d, L, algo=algo)
    row_sh = NamedSharding(mesh, P("nodes"))
    plan_d = tuple(tuple((j_put(b.rows, row_sh), j_put(b.succ, row_sh)) for b in rnd)
                   for rnd in plan.rounds)
    spec = tuple(tuple((P("nodes"), P("nodes")) for _ in rnd) for rnd in plan.rounds)

    def per_device(ids, scores, rounds):
        my = jax.lax.axis_index("nodes")
        out, diff = jring._sweep_local(JBaskets(ids, scores), rounds, jnp.float32(DAMPING),
                                       my, d, s, L, algo, True)
        return out.ids, out.scores, diff[None]

    fn = jax.jit(jax.shard_map(per_device, mesh=mesh, in_specs=(P("nodes"), P("nodes"), spec),
                               out_specs=(P("nodes"),) * 3, check_vma=False))
    ids, scores, diff = fn(j_put(ids0, row_sh), j_put(scores0, row_sh), plan_d)
    return np.asarray(ids), np.asarray(scores), float(np.asarray(diff).max())


@pytest.mark.parametrize("algo_t,algo_j", ALGOS)
def test_half_sweep_matches_jax(algo_t, algo_j):
    d, L = 4, 32
    gj, gt = _graph_pair(*_random_graph(5, 61))  # 61 rows: the last shard is padded
    n = gt.num_nodes
    s = tring.shard_size(n, d)
    ids0, scores0 = _state(s * d, n, L, 6)
    j_ids, j_scores, j_diff = _jax_half_sweep(gj, ids0, scores0, L, algo_j, d)

    mesh = cpu_mesh(d)
    plan = tring.build_ring_plan(gt, 0, d, L, algo=algo_t)
    if algo_t == "kernel":  # some rows are wide enough for the kernel
        assert max(b.cap for r in plan.rounds for b in r) * L + 1 >= 256
    rounds = [tring._shard_rounds(plan, p, CPU, s, s * d) for p, _ in mesh.shards]
    baskets = [pt.Baskets(torch.as_tensor(ids0[p * s:(p + 1) * s]),
                          torch.as_tensor(scores0[p * s:(p + 1) * s])) for p in range(d)]
    outs, diff = tring._sweep(mesh, baskets, rounds, {CPU: torch.tensor(DAMPING)}, s, L,
                              algo_t, True)
    t_ids = torch.cat([o.ids for o in outs]).numpy()[:n]
    t_scores = torch.cat([o.scores for o in outs]).numpy()[:n]
    topl_max_error(j_ids[:n], j_scores[:n], t_ids, t_scores, 1e-6)
    assert abs(float(diff) - j_diff) <= 1e-6


# ------------------------------------------------------ whole runs vs JAX
@pytest.mark.parametrize("algo_t,algo_j,d", [("sort", "sort", 4), ("kernel", "bitonic", 2)])
def test_whole_run_matches_jax_ring(algo_t, algo_j, d):
    # L = |V|: no sweep truncates, so ties cannot propagate (ROADMAP queue C)
    gj, gt = _graph_pair(*_random_graph(11, 30))
    n, K = gt.num_nodes, 10
    j, j_info = jring.ring_grank_baskets(gj, K, n, 12, DAMPING, 1e-6, n_shards=d,
                                         merge_algo=algo_j, return_info=True)
    t, t_info = tring.ring_grank_baskets(gt, K, n, 12, DAMPING, 1e-6, mesh=cpu_mesh(d),
                                         merge_algo=algo_t, return_info=True)
    assert t_info["iterations_ran"] == j_info["iterations_ran"]
    assert t.ids.shape == (n, K) and t.ids.dtype == torch.int32
    topl_max_error(np.asarray(j.ids), np.asarray(j.scores), t.ids, t.scores, 1e-5)


# ------------------------------------------------- shard-count invariance
def _sharding_graphs(name):
    """tests/test_sharding.py's four graphs."""
    n = 24
    if name == "cycle":
        return pt.Graph.from_dict({i: [(i + 1) % n] for i in range(n)})
    if name == "star":
        return pt.Graph.from_dict({0: list(range(1, 8)), **{i: [0] for i in range(1, 8)}})
    if name == "random":
        rng = np.random.default_rng(12345)
        return pt.Graph.from_edges(rng.integers(0, n, 200), rng.integers(0, n, 200),
                                   num_nodes=n)
    return pt.Graph.from_dict({i: [j for j in range(8) if j != i] for i in range(8)})


@pytest.mark.parametrize("name", ["cycle", "star", "random", "complete"])
@pytest.mark.parametrize("algo", ["sort", "kernel"])
def test_shard_count_invariance(name, algo):
    """D in {1, 2, 4} give equal baskets, and D=1 equals the sparse engine
    (these graphs have no hub rows)."""
    g = _sharding_graphs(name)
    runs = [pt.grank_baskets(g, 5, 10, 30, DAMPING, 1e-4, merge_algo=algo, mesh=cpu_mesh(d),
                             return_info=True) for d in (1, 2, 4)]
    runs.append(pt.grank_baskets(g, 5, 10, 30, DAMPING, 1e-4, merge_algo=algo,
                                 engine="sparse", device="cpu", return_info=True))
    (ref, ref_info), others = runs[0], runs[1:]
    for out, info in others:
        assert info["iterations_ran"] == ref_info["iterations_ran"]
        assert torch.equal(out.ids, ref.ids)
        assert float((out.scores - ref.scores).abs().max()) <= 1e-6


def test_multi_round_equals_single_round():
    n = 48
    rng = np.random.default_rng(12345)
    g = pt.Graph.from_edges(rng.integers(0, n, 400), rng.integers(0, n, 400), num_nodes=n)
    assert len(tring.build_ring_plan(g, 0, 4, 10, elem_budget=64).rounds) > 1
    big = tring.ring_grank_baskets(g, 5, 10, 20, DAMPING, 1e-4, mesh=cpu_mesh(4))
    small = tring.ring_grank_baskets(g, 5, 10, 20, DAMPING, 1e-4, mesh=cpu_mesh(4),
                                     elem_budget=64)
    assert torch.equal(big.ids, small.ids)
    assert float((big.scores - small.scores).abs().max()) <= 1e-6


def test_multi_entry_points_and_mesh_dispatch():
    g = _sharding_graphs("cycle")
    # auto is dense on so small a graph, but a mesh makes it sparse
    assert use_dense_engine(24, "auto") and not use_dense_engine(24, "auto", mesh=cpu_mesh(2))
    multi = pt.grank_multi_baskets(g, 4, 8, 10, DAMPING, 1e-4, 4, device="cpu")
    direct = tring.ring_grank_baskets(g, 4, 8, 10, DAMPING, 1e-4, mesh=cpu_mesh(4))
    assert torch.equal(multi.ids, direct.ids) and torch.equal(multi.scores, direct.scores)
    assert int((multi.ids >= 0).sum()) == 24 * 4
    as_dict = pt.grank_multi(g, 4, 8, 10, DAMPING, 1e-4, 2, device="cpu")
    assert as_dict == pt.baskets_to_dict(direct, g)
    empty, info = pt.grank_baskets(pt.Graph.from_dict({}), 2, 4, 5, DAMPING, 1e-4,
                                   mesh=cpu_mesh(2), return_info=True)
    assert empty.ids.shape == (0, 2) and info == {"iterations_ran": 0}


def test_validation_messages():
    g = pt.Graph.from_dict({0: [1], 1: []})
    with pytest.raises(ValueError, match="n_shards must be positive"):
        pt.grank_multi(g, 1, 2, 5, DAMPING, 1e-4, 0, device="cpu")
    with pytest.raises(ValueError, match="n_shards must be positive"):
        pt.mccompletepathv2_multi(g, 1, 2, 5, DAMPING, 0, device="cpu")
    with pytest.raises(ValueError, match=r"n_shards=10000 exceeds available devices \(8\)"):
        pt.make_mesh(10_000, devices=[CPU] * 8)
    with pytest.raises(ValueError, match="K must be <= L"):
        pt.grank_multi(g, 3, 2, 5, DAMPING, 1e-4, 2, device="cpu")
    with pytest.raises(ValueError, match="needs an index"):
        pt.make_mesh(1, devices=["cuda"])
    mesh = cpu_mesh(3)
    assert mesh.n_shards == 3 and mesh.devices == (CPU,) * 3 and mesh.group is None
    assert mesh.row_range(7) == (0, 7)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            pt.grank_multi_baskets(g, 1, 2, 5, DAMPING, 1e-4, 2)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            pt.make_mesh(1)


def test_ring_shard_memory_accounting():
    """tests/test_sharding.py:175-182's size (20k nodes, 200k edges, L=32,
    8 shards, 2 half-sweeps).  A shard holds 3/8 of the full basket in its
    basket buffers, and the largest round's candidates on top: with rounds
    of 2^16 elements a shard stays below the full basket and below half of
    what one shard holds at D=1."""
    rng = np.random.default_rng(12345)
    n, e, L = 20_000, 200_000, 32
    g = pt.Graph.from_edges(rng.integers(0, n, e), rng.integers(0, n, e), num_nodes=n)
    budget = 1 << 16
    out, info = tring.ring_grank_baskets(g, 16, L, 2, DAMPING, -1.0, mesh=cpu_mesh(8),
                                         elem_budget=budget, analyze_memory=True)
    assert bool((out.ids[:, 0] >= 0).all()) and info["iterations_ran"] == 2
    mem = info["memory"]
    full = n * L * 8
    assert mem["full_basket_bytes"] == full and mem["device_peak_bytes"] == {}
    plans = [tring.build_ring_plan(g, p, 1, L, budget) for p in (0, 1)]
    one_shard = tring.ring_shard_bytes(plans, n, 1, L, "sort")
    assert mem["shard_bytes"] < full and mem["shard_bytes"] < 0.5 * one_shard, (
        mem["shard_bytes"], full, one_shard)
