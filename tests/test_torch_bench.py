"""bench_torch.py, the port's counterpart of bench.py, at a tiny size on the
CPU.  Its blocks run where nothing truncates (K, L >= |V|) and are held
against the JAX package's functions that bench.py's blocks call, on the
same graph at the same config: half-sweep counts, walk steps and
abandoned walks exactly, the ring's id check as JAX computes it, and the
quality numbers within 1e-4.  Its keys are held against bench.py's, read
from bench.py's source (bench.py is not imported: it sets a persistent
compilation cache)."""

import ast
import importlib.util
import os

import numpy as np
import pytest
import torch

import approximated_personalized_pagerank_tpu as pj
from approximated_personalized_pagerank_tpu.models import benchmark as j_bench
from approximated_personalized_pagerank_tpu.ops import walk as j_walk
from approximated_personalized_pagerank_tpu.parallel.mesh import make_mesh as j_make_mesh
from approximated_personalized_pagerank_tpu.parallel.ring import (
    ring_grank_baskets as j_ring_grank_baskets,
)

import approximated_personalized_pagerank_tpu_torch as pt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the Eat blocks' config at a size where nothing truncates: K, L >= nodes
NODES, EDGES = 40, 240
CFG = dict(K=48, L=48, iters=30, damping=0.85, tol=1e-4)
MC = dict(mc_k=48, mc_l=48, mc_r=64)
TEST_NODES = 8
SCALE = dict(nodes=50, edges=300, K=56, L=56, sweeps=4, walks=32, damping=0.85)
# bench.py's keys bench_torch.py leaves out (timings of another host) and
# renames, its keys that appear only when a block fails, and the keys it adds
DROPPED = {"vs_baseline", "vs_grank_multi_4t", "mc_vs_reference"}
RENAMED = {"ring_tpu_wall_s": "ring_wall_s"}
ERRORS = {"ring_error", "scale_error", "scale_full_error"}
ADDED = {"kernel_build_s", "grank_runs_s", "mc_runs_s", "dense_runs_s", "ring_runs_s",
         "scale_grank_runs_s", "scale_walk_runs_s", "scale_peak_allocated_bytes"}


def _load_bench_torch():
    spec = importlib.util.spec_from_file_location("bench_torch", os.path.join(ROOT, "bench_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _bench_py_keys():
    """String keys of bench.py's dict literals and subscript assignments."""
    with open(os.path.join(ROOT, "bench.py")) as f:
        tree = ast.parse(f.read())
    keys = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict):
            keys |= {k.value for k in node.keys if isinstance(k, ast.Constant)}
        elif isinstance(node, ast.Assign):
            keys |= {t.slice.value for t in node.targets
                     if isinstance(t, ast.Subscript) and isinstance(t.slice, ast.Constant)}
    return keys


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: tiny tensor ops, parallel test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _edges():
    rng = np.random.default_rng(3)
    return rng.integers(0, NODES, EDGES), rng.integers(0, NODES, EDGES)


@pytest.fixture(scope="module")
def runs():
    """One tiny run of every quick block on the CPU, and the baskets kept."""
    torch.set_num_threads(1)
    bt = _load_bench_torch()
    graph = pt.Graph.from_edges(*_edges(), num_nodes=NODES)
    keep = {}
    elapsed, extra = bt.bench_eat(graph, "tiny", "cpu", **CFG, **MC, test_nodes=TEST_NODES,
                                  keep=keep)
    extra.update(bt.kernel_build("cpu"))
    extra.update(bt.bench_dense_eat(graph, "cpu", **CFG, test_nodes=TEST_NODES))
    extra.update(bt.bench_ring(graph, sparse_wall_s=elapsed, device="cpu", **CFG, keep=keep))
    extra.update(bt.bench_scale("cpu", **SCALE))
    return bt, bt.result_json(elapsed, extra), keep


def test_bench_torch_imports_no_jax():
    with open(os.path.join(ROOT, "bench_torch.py")) as f:
        tree = ast.parse(f.read())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module or "" for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
    assert names and not [m for m in names if m.split(".")[0] in (
        "jax", "jaxlib", "approximated_personalized_pagerank_tpu", "bench")]


def test_keys_equal_bench_py(runs):
    bt, result, _ = runs
    jax_keys = _bench_py_keys()
    assert {"jaccard_min", "ring_tpu_wall_s", "dense_mfu", "scale_walk_steps"} <= jax_keys
    want = {RENAMED.get(k, k) for k in jax_keys - DROPPED - ERRORS} | ADDED
    got = set(result) | set(result["extra"])
    assert got == want
    assert bt.expected_keys() == want
    assert result["metric"] == "grank_eat_wall_time" and result["unit"] == "s"
    assert result["value"] > 0 and result["value"] == float(np.median(result["extra"]["grank_runs_s"]))
    assert len(result["extra"]["grank_runs_s"]) == 3
    assert result["extra"]["kernel_build_s"] is None and result["extra"]["dense_mfu"] is None
    assert result["extra"]["scale_peak_allocated_bytes"] is None


@pytest.fixture(scope="module")
def jax_eat():
    """bench.py's bench_eat / bench_dense_eat / bench_ring calls in the JAX
    package on the same graph."""
    g = pj.Graph.from_edges(*_edges(), num_nodes=NODES)
    args = (CFG["K"], CFG["L"], CFG["iters"], CFG["damping"], CFG["tol"])
    gb, g_info = pj.grank_baskets(g, *args, return_info=True)
    mc, mc_info = pj.mccompletepathv2_baskets(g, MC["mc_k"], MC["mc_l"], MC["mc_r"],
                                              CFG["damping"], seed=1, return_info=True)
    samples = [j_bench.sample_result(b, g, TEST_NODES, True, seed=0) for b in (gb, mc)]
    stats, mc_stats = j_bench.benchmark_sampled(samples, g)
    db, d_info = pj.grank_baskets(g, *args, engine="dense", return_info=True)
    d_stats = pj.benchmark_algorithm(db, g, TEST_NODES, True, seed=0)
    rb, r_info = j_ring_grank_baskets(g, *args, mesh=j_make_mesh(1), return_info=True)
    sb = pj.grank_baskets(g, *args, engine="sparse")
    return dict(g_info=g_info, mc_info=mc_info, stats=stats, mc_stats=mc_stats, d_info=d_info,
                d_stats=d_stats, r_info=r_info,
                ring_identical=bool(np.array_equal(np.asarray(rb.ids), np.asarray(sb.ids))))


QUALITY = [("jaccard_average", "stats", "jaccard average"),
           ("jaccard_min", "stats", "jaccard min"),
           ("kendall_average", "stats", "kendall average"),
           ("recall_average", "stats", "recall average"),
           ("average_map_size", "stats", "average map size"),
           ("mc_jaccard_average", "mc_stats", "jaccard average"),
           ("mc_kendall_average", "mc_stats", "kendall average"),
           ("dense_jaccard_average", "d_stats", "jaccard average"),
           ("dense_recall_average", "d_stats", "recall average")]


@pytest.mark.parametrize("key,stats,name", QUALITY, ids=[q[0] for q in QUALITY])
def test_quality_matches_the_jax_package(runs, jax_eat, key, stats, name):
    assert abs(runs[1]["extra"][key] - jax_eat[stats][name]) <= 1e-4


def test_counts_match_the_jax_package(runs, jax_eat):
    extra = runs[1]["extra"]
    assert extra["iterations_ran"] == jax_eat["g_info"]["iterations_ran"]
    assert extra["dense_iterations_ran"] == jax_eat["d_info"]["iterations_ran"]
    assert extra["ring_iterations_ran"] == jax_eat["r_info"]["iterations_ran"]
    mc_info = jax_eat["mc_info"]
    assert extra["mc_walk_steps"] == mc_info["walk_steps"]
    assert extra["mc_abandoned_frac"] == mc_info["abandoned_walks"] / max(mc_info["total_walks"], 1)
    assert extra["ring_ids_identical_to_sparse"] is jax_eat["ring_identical"] is True
    assert extra["ring_vs_sparse"] == extra["ring_wall_s"] / runs[1]["value"]


def test_kept_baskets_are_the_blocks_runs(runs):
    keep = runs[2]
    graph = pt.Graph.from_edges(*_edges(), num_nodes=NODES)
    args = (CFG["K"], CFG["L"], CFG["iters"], CFG["damping"], CFG["tol"])
    g = pt.grank_baskets(graph, *args, device="cpu")
    assert torch.equal(keep["grank"].ids, g.ids) and torch.equal(keep["grank"].scores, g.scores)
    s = pt.grank_baskets(graph, *args, engine="sparse", device="cpu")
    assert torch.equal(keep["ring"].ids, s.ids)
    assert tuple(keep["mc"].ids.shape) == (NODES, MC["mc_k"])


def test_scale_block_matches_the_jax_package(runs):
    extra = runs[1]["extra"]
    rng = np.random.default_rng(1)
    g = pj.Graph.from_edges(rng.integers(0, SCALE["nodes"], size=SCALE["edges"]),
                            rng.integers(0, SCALE["nodes"], size=SCALE["edges"]),
                            num_nodes=SCALE["nodes"])
    _, info = pj.grank_baskets(g, SCALE["K"], SCALE["L"], SCALE["sweeps"], SCALE["damping"],
                               -1.0, engine="sparse", return_info=True)
    _, w_info = j_walk.walk_baskets(g, SCALE["L"], SCALE["walks"], SCALE["damping"], seed=0,
                                    return_info=True)
    assert (extra["scale_nodes"], extra["scale_edges"]) == (SCALE["nodes"], SCALE["edges"])
    assert extra["scale_grank_half_sweeps"] == info["iterations_ran"] == SCALE["sweeps"]
    assert extra["scale_walk_steps"] == w_info["walk_steps"]
    assert extra["scale_grank_merges_per_s"] > 0 and extra["scale_walk_steps_per_s"] > 0


def test_main_without_a_card_exits_non_zero(capsys):
    bt = _load_bench_torch()
    assert not torch.cuda.is_available()
    assert bt.main([]) != 0
    assert capsys.readouterr().out == ""
