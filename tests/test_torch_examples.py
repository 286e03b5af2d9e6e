"""The port's example drivers (examples/*_torch.py) at a tiny size on the
CPU.  The north-star driver is held against direct calls of the JAX
package's functions at the same config, untruncated (K, L >= |V|), so
ids must agree as sets and scores within 1e-6 (GRank) and 2e-6 (MC, see
the test); its quality numbers within 1e-4 of the JAX harness's, and its
keys equal run_scale.py's."""

import importlib.util
import json
import os
import re

import numpy as np
import pytest
import torch

import approximated_personalized_pagerank_tpu as pj
from approximated_personalized_pagerank_tpu.models import benchmark as j_bench
from approximated_personalized_pagerank_tpu.utils import synthetic as j_synth

import approximated_personalized_pagerank_tpu_torch as pt
from approximated_personalized_pagerank_tpu_torch.utils import io as tio

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples")
# run_scale's stages at a size where nothing is truncated: K, L, mc_l >= nodes
TINY = dict(nodes=48, edges=300, locality=0.8, K=64, L=64, iterations=8, damping=0.85,
            tolerance=1e-4, test_nodes=8, mc_r=200, mc_l=64, seed=7)


def _load(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(EXAMPLES, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: tiny tensor ops, parallel test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rows(ids, scores):
    ids, scores = np.asarray(ids), np.asarray(scores)
    return [dict(zip(i[i >= 0].tolist(), s[i >= 0].tolist())) for i, s in zip(ids, scores)]


def _assert_same_baskets(j, t, atol=1e-6):
    for v, (a, b) in enumerate(zip(_rows(j.ids, j.scores), _rows(t.ids, t.scores))):
        assert set(a) == set(b), v
        assert max((abs(a[k] - b[k]) for k in a), default=0.0) <= atol, v


@pytest.fixture(scope="module")
def scale_run():
    """One tiny run of run_scale_torch.run_scale, its stage lines, and the
    baskets its GRank and MC calls returned."""
    mod = _load("run_scale_torch")
    seen = {}

    def spy(name, fn):
        def call(*args, **kw):
            out = fn(*args, **kw)
            if name == "mc" or args[3] == TINY["iterations"]:  # not the warm-up
                seen[name] = out
            return out
        return call

    mp = pytest.MonkeyPatch()
    mp.setattr(mod, "grank_baskets", spy("grank", mod.grank_baskets))
    mp.setattr(mod, "mccompletepathv2_baskets", spy("mc", mod.mccompletepathv2_baskets))
    lines = []
    try:
        out = mod.run_scale(**TINY, log=lines.append, device="cpu")
    finally:
        mp.undo()
    return out, [json.loads(x) for x in lines], seen


def test_run_scale_keys_equal_run_scale_py(scale_run):
    out, lines, _ = scale_run
    with open(os.path.join(EXAMPLES, "run_scale.py")) as f:
        jax_keys = set(re.findall(r'"(scale_full_\w+)"', f.read()))
    assert set(out) == jax_keys
    assert [x["stage"] for x in lines] == ["build", "prep", "grank_warmup", "grank", "mc", "eval"]
    for x in lines:
        assert x["device"] == "cpu" and x["peak_allocated_bytes"] is None
        assert x["stage_wall_s"] >= 0
    assert all(x["native_partition"] for x in lines[1:]) == tio.native_available()
    assert out["scale_full_iterations"] == lines[3]["scale_full_iterations"]
    assert 0 <= out["scale_full_mc_abandoned_frac"] <= 1


def test_run_scale_matches_the_jax_package(scale_run):
    out, _, seen = scale_run
    c = TINY
    gj = j_synth.powerlaw_graph(c["nodes"], c["edges"], seed=c["seed"], locality=c["locality"])
    args = (c["K"], c["L"], c["iterations"], c["damping"], c["tolerance"])
    jg, jg_info = pj.grank_baskets(gj, *args, engine="sparse", merge_algo="sort",
                                   return_info=True)
    tg, tg_info = seen["grank"]
    assert tg_info["iterations_ran"] == jg_info["iterations_ran"] == out["scale_full_iterations"]
    _assert_same_baskets(jg, tg)

    jm, jm_info = pj.mccompletepathv2_baskets(gj, c["K"], c["mc_l"], c["mc_r"], c["damping"],
                                              seed=1, engine="sparse", merge_algo="sort",
                                              return_info=True)
    tm, tm_info = seen["mc"]
    assert tm_info == jm_info
    assert out["scale_full_mc_walk_steps"] == jm_info["walk_steps"]
    # JAX's sort combine sums a row's runs by prefix-sum differences over
    # pre-scale values of ~(1 + 1/damping) * deg, so after the post-scale its
    # scores sit ~10 ulps of 1 from an ordered sum (1.07e-6 on this graph's
    # degree-37 hub, with the port's old scatter_add_ sums as with the scan)
    _assert_same_baskets(jm, tm, atol=2e-6)

    samples = [j_bench.sample_result(b, gj, c["test_nodes"], True, seed=0) for b in (jg, jm)]
    gs, ms = j_bench.benchmark_sampled(samples, gj)
    for key, ref in (("jaccard", gs["jaccard average"]), ("jaccard_min", gs["jaccard min"]),
                     ("kendall", gs["kendall average"]), ("recall", gs["recall average"]),
                     ("mc_jaccard", ms["jaccard average"]), ("mc_recall", ms["recall average"])):
        assert abs(out[f"scale_full_{key}"] - ref) <= 1e-4, key


def test_run_scale_options_reach_the_runs():
    mod = _load("run_scale_torch")
    small = dict(nodes=300, edges=2000, test_nodes=4, mc_r=20, iterations=2, device="cpu")
    runs = {}
    for kw in ({}, {"mc_seed": 2, "merge_algo": "kernel"}):
        lines = []
        out = mod.run_scale(**small, **kw, log=lines.append)
        runs[kw.get("mc_seed", 1)] = out, {x["stage"]: x for x in map(json.loads, lines)}
    (one, one_st), (two, two_st) = runs[1], runs[2]
    assert one_st["prep"]["merge_algo"] == "sort" and two_st["prep"]["merge_algo"] == "kernel"
    assert one_st["mc"]["mc_seed"] == 1 and two_st["mc"]["mc_seed"] == 2
    assert one["scale_full_mc_walk_steps"] != two["scale_full_mc_walk_steps"]


def test_run_eat_prints_the_reference_statistics(tmp_path):
    mod = _load("run_eat_torch")
    rng = np.random.default_rng(3)
    src, dst = rng.integers(0, 40, 240), rng.integers(0, 40, 240)
    path = tmp_path / "g.csv"
    path.write_text("".join(f"{a},{b}\n" for a, b in zip(src, dst)))
    printed = []
    res = mod.run_eat(str(path), device="cpu", test_nodes=10, iterations=6, mc_r=30,
                      out=printed.append)
    assert tio.paths_ran()["parse_edge_csv"] == ("native" if tio.native_available() else "numpy")
    g = pt.load_csv_graph(str(path))
    grank = pt.grank_baskets(g, 50, 100, 6, 0.85, 1e-4, device="cpu")
    mc = pt.mccompletepathv2_baskets(g, 50, 200, 30, 0.85, seed=0, device="cpu")
    for name, b in (("grank", grank), ("mccompletepathv2", mc)):
        stats = pt.benchmark_algorithm(b, g, 10, True, seed=0, device="cpu")
        got = dict(res[name])
        assert got.pop("run_time_ms") > 0
        assert got == stats
        assert any(line.startswith(f"{name} run-time = ") for line in printed)
    assert printed[0] == f"nodes: {g.num_nodes} edges: {g.num_edges}"
    assert sum(line == "-------" for line in printed) == 4


def test_run_synthetic_counters():
    mod = _load("run_synthetic_torch")
    res = mod.run_synthetic(300, 1500, 2, device="cpu", out=lambda *_: None)
    rng = np.random.default_rng(0)
    g = pt.Graph.from_edges(rng.integers(0, 300, 1500), rng.integers(0, 300, 1500),
                            num_nodes=300)
    _, winfo = pt.walk_baskets(g, 100, 200, 0.85, seed=1, return_info=True, device="cpu")
    assert res["half_sweeps"] == 2 and res["merges_per_s"] > 0
    assert res["walk_steps"] == winfo["walk_steps"] and res["walk_steps_per_s"] > 0
    assert res["abandoned_walks"] == winfo["abandoned_walks"]


def test_run_sharded_and_bench_ring():
    mod = _load("run_sharded_torch")
    res = mod.run_sharded(2, 300, 1500, device="cpu", out=lambda *_: None)
    rng = np.random.default_rng(0)
    g = pt.Graph.from_edges(rng.integers(0, 300, 1500), rng.integers(0, 300, 1500),
                            num_nodes=300)
    one = pt.grank_baskets(g, 50, 100, 10, 0.85, 1e-4, mesh=pt.make_mesh(1, ["cpu"]))
    assert torch.equal(res["baskets"].ids, one.ids)
    assert torch.equal(res["baskets"].scores, one.scores)
    mem = res["memory"]
    assert mem["full_basket_bytes"] == 300 * 100 * 8 and mem["device_peak_bytes"] == {}
    assert 0 < mem["shard_bytes"] and res["mc"].ids.shape == (300, 50)

    bench = _load("bench_ring_torch")
    printed = []
    rows = bench.bench_ring(400, 2000, 2, 20, 10, (1, 2), device="cpu", out=printed.append)
    assert [r["shards"] for r in rows] == [1, 2]
    for r in rows:
        s = -(-400 // r["shards"])
        assert r["ring_bytes_total"] == r["rounds_per_sweep"] * (r["shards"] - 1) * s * 20 * 8 * 2
        assert r["iterations_ran"] == 2 and r["shard_bytes_planned"] > 0
    assert "a rotation moves nothing" in json.loads(printed[-1])["note"]
