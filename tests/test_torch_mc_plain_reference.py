"""The benchmark's plain MC reference (``ppr_bench/reference/mc.py``) against
``jax.random`` and the port, on the CPU at small sizes.

The reference writes threefry-2x32, the walk plan, the cohort walks and the
dense combine out again without importing the port.  Here its stream is
held bit for bit to ``jax.random``, its plan to ``ops/walk.py``'s, its walk
counters exactly to the port's ``return_info`` under both engines, and the
port's baskets to the ``eat-mc`` cell's limits of it; the float8 control
the cell's limits are set against must fail one of them.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

import approximated_personalized_pagerank_tpu_torch as pt
from approximated_personalized_pagerank_tpu_torch.ops import walk as tw
from ppr_bench.algorithms import mc as adapter
from ppr_bench.reference import compare
from ppr_bench.reference import mc as ref

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DAMPING = 0.85


def _words(key):
    return tuple(int(w) for w in key)


def _jax_words(key):
    return tuple(int(w) for w in np.asarray(key))


@pytest.mark.parametrize("seed", [0, 1, 2**31 - 1, 2**31 + 11])
def test_stream_is_jax_random(seed):
    root = ref.root_key(seed)
    jroot = jax.random.PRNGKey(seed & 0xFFFFFFFF)
    assert _words(root) == _jax_words(jroot)
    for data in (0, 512, 23040, 2**32 - 1):
        key = ref.fold_in(root, data)
        jkey = jax.random.fold_in(jroot, data)
        assert _words(key) == _jax_words(jkey)
        for got, want in zip(ref.split(key), jax.random.split(jkey)):
            assert _words(got) == _jax_words(want)
    # fold_in over a vector of data, as the walks key their chunks
    many = ref.fold_in(root, torch.tensor([0, 512, 1024]))
    for i, data in enumerate((0, 512, 1024)):
        assert (int(many[0][i]), int(many[1][i])) == _jax_words(jax.random.fold_in(jroot, data))
    key = ref.fold_in(root, 7)
    shape = (4, 5, 3)
    got = ref.uniform_from_bits(ref.random_bits(key, torch.arange(60).reshape(shape)))
    want = np.asarray(jax.random.uniform(jax.random.fold_in(jroot, 7), shape))
    np.testing.assert_array_equal(got.numpy().view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("n,R", [(23132, 1000), (300, 200), (1_000_000, 200), (40, 10)])
def test_plan_is_the_ports(n, R):
    plan = ref.trace_plan(n, R, DAMPING)
    chunk, _, slots, total, macro, width = tw._trace_chunks(n, R, DAMPING, None, None, 32)
    assert plan == (chunk, slots, total, macro, width)
    assert plan[1:] == tw._trace_plan(R, DAMPING, None, None, 32, num_nodes=n)[1:]
    if n == 23132:
        assert plan == (512, 16, 850, 14, 7168)


def _graph_edges(seed: int, n: int, e: int):
    """Random edges with self-loops, parallel edges and dangling nodes."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n, e)
    src = np.concatenate([src, [1, 1, 2, 2, 2]])
    dst = np.concatenate([dst, [1, 1, 5, 5, 5]])  # a doubled self-loop, a tripled edge
    keep = src % 5 != 3  # every node = 3 mod 5 has no successors
    return src[keep].astype(np.int64), dst[keep].astype(np.int64)


GRAPHS = [(1, 60, 300, 40), (2, 150, 500, 100), (2**31 + 7, 90, 700, 200)]


@pytest.mark.parametrize("seed,n,e,R", GRAPHS)
def test_walk_counters_are_the_ports(seed, n, e, R):
    src, dst = _graph_edges(seed, n, e)
    g = pt.Graph.from_edges(src, dst, num_nodes=n)
    assert (g.out_degree == 0).sum() > 0
    w = ref.walks(n, torch.from_numpy(src), torch.from_numpy(dst), R, DAMPING, seed)
    # R at every source, one a visit
    assert int(w.counts.sum()) == n * R + w.walk_steps
    for engine in ("dense", "sparse"):
        _, info = pt.mccompletepathv2_baskets(g, 5, 20, R, DAMPING, seed=seed, engine=engine,
                                              return_info=True, device="cpu")
        assert (info["walk_steps"], info["abandoned_walks"]) == (w.walk_steps, w.abandoned_walks)
    # the full counts are the port's uncut walk rows, ids and all
    b = tw.walk_baskets(g, n, R, DAMPING, seed=seed, device="cpu")
    ids, counts = ref.top_rows(w.counts, n)
    assert torch.equal(ids, b.ids)
    np.testing.assert_allclose((counts / R).numpy(), b.scores.numpy(), rtol=2e-7)
    dangling = torch.from_numpy(g.out_degree == 0)
    assert torch.equal(ids[dangling, 0], torch.arange(n, dtype=torch.int32)[dangling])
    assert bool((ids[dangling, 1:] == -1).all())


@pytest.fixture(scope="module")
def cell():
    """The ``eat-mc`` cell's job and limits on a 400-node graph drawn like
    the tests' graphs, the reference's result and the port's."""
    with open(os.path.join(ROOT, "ppr_bench", "workloads", "eat-mc.json")) as f:
        wl = json.load(f)
    job, limits = wl["job"], wl["limits"]
    seed, n = 5, 400
    src, dst = _graph_edges(seed, n, 4000)
    s_t, d_t = torch.from_numpy(src), torch.from_numpy(dst)
    w = ref.walks(n, s_t, d_t, job["R"], job["damping"], seed)
    r = ref.mccompletepathv2(n, s_t, d_t, job["L"], job["R"], job["damping"], seed,
                             passes=job["combine_passes"], w=w)
    g = pt.Graph.from_edges(src, dst, num_nodes=n)
    out, info = pt.mccompletepathv2_baskets(g, job["K"], job["L"], job["R"], job["damping"],
                                            seed=seed, combine_passes=job["combine_passes"],
                                            engine=job["engine"], return_info=True,
                                            device="cpu")
    return dict(job=job, limits=limits, n=n, src=s_t, dst=d_t, seed=seed, w=w, r=r,
                out=out, info=info)


def test_the_ports_baskets_are_within_the_cells_limits(cell):
    out, job = cell["out"], cell["job"]
    checks = adapter.gaps(out.ids, out.scores, cell["info"], cell["r"], cell["n"], job["K"],
                          cell["limits"])
    assert set(cell["limits"]) < set(checks)
    assert all(v <= lim for v, lim in checks.values()), checks


def test_the_float8_control_fails_a_limit(cell):
    job = cell["job"]
    c = ref.mccompletepathv2(cell["n"], cell["src"], cell["dst"], job["L"], job["R"],
                             job["damping"], cell["seed"], passes=job["combine_passes"],
                             dtype=torch.float8_e4m3fn, w=cell["w"])
    k = job["K"]
    ids, scores = c.ids[:, :k].contiguous(), c.scores[:, :k].float().contiguous()
    counters = {"walk_steps": c.walk_steps, "abandoned_walks": c.abandoned_walks}
    checks = adapter.gaps(ids, scores, counters, cell["r"], cell["n"], k, cell["limits"])
    # well formed, with the reference's own walks: it fails on the gaps alone
    assert checks["malformed"][0] == checks["walk_steps_gap"][0] == 0.0
    assert any(v > lim for name, (v, lim) in checks.items() if name in cell["limits"]), checks


def test_dangling_nodes_keep_themselves_through_the_combine(cell):
    r, n = cell["r"], cell["n"]
    for v in range(3, n, 5):
        assert r.ids[v, 0] == v and r.scores[v, 0] == 1.0 and bool((r.ids[v, 1:] == -1).all())
    g = compare.basket_gaps(cell["out"].ids, cell["out"].scores, r.ids, r.scores)
    assert g["mean_score_gap"] <= g["rank_score_gap"]
