#!/usr/bin/env python
"""Headline benchmark of the PyTorch/CUDA port: bench.py's blocks on one card.

    python3 bench_torch.py                    # every block on the card
    PPR_BENCH_SCALE=0 python3 bench_torch.py --device cpu   # Eat blocks on the CPU

The counterpart of ``bench.py``, with its blocks, names and JSON shape:
``{"metric": "grank_eat_wall_time", "value": ..., "unit": "s", "extra":
{...}}``, printed after every block so a run cut short keeps what it
measured.  The blocks:

* ``bench_eat``: GRank on Eat (K=50, L=100, 30 half-sweeps, damping 0.85,
  tol 1e-4) through ``engine="auto"`` (sparse at 23,132 nodes), then
  MCCompletePathV2 (K=50, L=200, R=1000) through auto (dense there), both
  scored in one oracle pass on 200 strict sources;
* ``bench_dense_eat``: the same GRank on the dense engine, its TFLOP/s and
  its share of the H100's 989 TFLOP/s dense bf16 peak;
* ``bench_ring``: the ring path on a mesh of one shard, its ids against the
  sparse engine's;
* ``bench_scale``: 4 sparse half-sweeps and the walks (R=200) on a uniform
  graph of 1M nodes and 10M edges;
* ``bench_scale_full``: the north star, ``examples/run_scale_torch.py``
  (on by default on the card, off on the CPU; ``PPR_BENCH_SCALE_FULL``).

Every timed section ends with ``torch.cuda.synchronize()``.  Warm-ups
(``*_compile_s``) and the kernel's build (``kernel_build_s``) are timed
apart; a timed figure is the median of ``repeats`` runs, the runs beside it
(``*_runs_s``).  ``device`` holds the card's name and its ``nvidia-smi``
name and power limit.

Keys against bench.py's: ``vs_baseline``, ``vs_grank_multi_4t`` and
``mc_vs_reference`` are left out (their C++ timings were taken on another
host); ``ring_tpu_wall_s`` is ``ring_wall_s``; ``kernel_build_s``, the
``*_runs_s`` lists and ``scale_peak_allocated_bytes`` are added.  A block
that fails leaves its ``*_error`` key, as in bench.py, and the run exits
non-zero.  Without a card the run exits non-zero unless ``--device cpu``
is given.  ``--graph PATH`` reads the Eat edge list from a CSV file instead
of the bundled copy.
"""

from __future__ import annotations

import argparse
import ast
import importlib.util
import json
import os
import sys
import time
import traceback

import numpy as np
import torch

from approximated_personalized_pagerank_tpu_torch import (
    Graph,
    benchmark_algorithm,
    benchmark_sampled,
    grank_baskets,
    load_csv_graph,
    load_eat_graph,
    make_mesh,
    mccompletepathv2_baskets,
    sample_result,
)
from approximated_personalized_pagerank_tpu_torch.ops.dense import use_dense_engine
from approximated_personalized_pagerank_tpu_torch.utils.device import (
    card_line,
    resolve_device,
    synchronize,
)

HERE = os.path.dirname(os.path.abspath(__file__))

K, L, ITERS, DAMPING, TOL = 50, 100, 30, 0.85, 1e-4
# MCCompletePathV2 as the reference driver runs it (src/main.cc:64)
MC_K, MC_L, MC_R = 50, 200, 1000
TEST_NODES = 200  # strict sources scored against the exact oracle
REPEATS = 3  # timed runs behind each median

# H100 SXM dense bf16 peak (NVIDIA data sheet), for dense_mfu
BF16_PEAK_FLOPS = 989e12

# Scale benchmark: sparse engine + walk engine at 1M nodes / 10M edges
SCALE_N, SCALE_E = 1_000_000, 10_000_000
SCALE_SWEEPS = 4  # measured half-sweeps for throughput (not a full run)
SCALE_WALKS = 200  # R for the walk-engine throughput measurement

# bench.py's keys this script leaves out, renames and adds
DROPPED = {"vs_baseline", "vs_grank_multi_4t", "mc_vs_reference"}
RENAMED = {"ring_tpu_wall_s": "ring_wall_s"}
ADDED = {"kernel_build_s", "grank_runs_s", "mc_runs_s", "dense_runs_s", "ring_runs_s",
         "scale_grank_runs_s", "scale_walk_runs_s", "scale_peak_allocated_bytes"}
ERROR_KEYS = {"ring_error", "scale_error", "scale_full_error"}


def bench_py_keys(path: str = os.path.join(HERE, "bench.py")) -> set:
    """Every key bench.py puts in its JSON (top level and ``extra``), read
    from its source: dict literals' string keys and string-subscript
    assignments.  bench.py is not imported (it imports jax)."""
    with open(path) as f:
        tree = ast.parse(f.read())
    keys = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict):
            keys |= {k.value for k in node.keys
                     if isinstance(k, ast.Constant) and isinstance(k.value, str)}
        elif isinstance(node, ast.Assign):
            keys |= {t.slice.value for t in node.targets
                     if isinstance(t, ast.Subscript) and isinstance(t.slice, ast.Constant)
                     and isinstance(t.slice.value, str)}
    return keys


def expected_keys(path: str = os.path.join(HERE, "bench.py")) -> set:
    """The keys a full run of this script prints without a failure: bench.py's
    under the mapping above, its ``*_error`` keys aside."""
    keys = bench_py_keys(path) - DROPPED - ERROR_KEYS
    return {RENAMED.get(k, k) for k in keys} | ADDED


def _timed(fn, dev):
    """(result, seconds) of one call, ended by a synchronize."""
    synchronize(dev)
    t0 = time.perf_counter()
    out = fn()
    synchronize(dev)
    return out, time.perf_counter() - t0


def _median_runs(fn, dev, repeats: int):
    """The first run's result, the median wall of ``repeats`` runs, and the
    runs' walls."""
    out, first = _timed(fn, dev)
    walls = [first] + [_timed(fn, dev)[1] for _ in range(repeats - 1)]
    return out, float(np.median(walls)), walls


def device_label(dev) -> str:
    """The card's name and its ``nvidia-smi`` name and power limit."""
    if dev.type != "cuda":
        return str(dev)
    return f"{torch.cuda.get_device_name(dev)}; nvidia-smi: {card_line()}"


def load_graph(path: str | None = None):
    """The Eat graph: from ``path`` (a CSV edge list) when given, else the
    repository's bundled copy."""
    if path is not None:
        return load_csv_graph(path), "eat"
    return load_eat_graph(), "eat"


def measured_merges(graph, L, half_sweeps):
    """Basket-merge slot updates actually performed: for each executed
    half-sweep, every edge out of the active partition contributes one
    basket of L slots (partition 0 sweeps first)."""
    part = graph.partition
    deg = graph.out_degree.astype(np.int64)
    e0 = int(deg[part == 0].sum())
    e1 = int(deg[part == 1].sum())
    s0 = (half_sweeps + 1) // 2
    s1 = half_sweeps // 2
    return (s0 * e0 + s1 * e1) * L


def kernel_build(device="cuda") -> dict:
    """The merge kernel's build and load, timed before any warm-up (None
    on the CPU, where no kernel runs)."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return {"kernel_build_s": None}
    from approximated_personalized_pagerank_tpu_torch.ops import merge_kernel

    t0 = time.perf_counter()
    merge_kernel.load_library()
    return {"kernel_build_s": time.perf_counter() - t0}


def bench_eat(graph, dataset, device="cuda", K=K, L=L, iters=ITERS, damping=DAMPING,
              tol=TOL, mc_k=MC_K, mc_l=MC_L, mc_r=MC_R, test_nodes=TEST_NODES,
              repeats=REPEATS, mc_repeats=REPEATS, keep=None):
    """Canonical GRank + MCCompletePathV2 on Eat with the auto engine.
    Returns the GRank wall (the median) and the block's keys; ``keep``, a
    dict, receives the GRank and MC baskets (``"grank"``, ``"mc"``)."""
    dev = resolve_device(device)
    # warm up the program measured below, return_info included
    _, compile_s = _timed(
        lambda: grank_baskets(graph, K, L, 2, damping, tol, return_info=True, device=dev), dev)
    (baskets, info), elapsed, runs = _median_runs(
        lambda: grank_baskets(graph, K, L, iters, damping, tol, return_info=True, device=dev),
        dev, repeats)
    iters_ran = info["iterations_ran"]
    g_sample = sample_result(baskets, graph, test_nodes, True, seed=0)

    # MCCompletePathV2 with the reference driver's config: a seed-0
    # warm-up, then seed 1 timed
    mc_run = lambda seed: mccompletepathv2_baskets(  # noqa: E731
        graph, mc_k, mc_l, mc_r, damping, seed=seed, return_info=True, device=dev)
    _, mc_compile_s = _timed(lambda: mc_run(0), dev)
    (mc, mc_info), mc_elapsed, mc_runs = _median_runs(lambda: mc_run(1), dev, mc_repeats)
    mc_sample = sample_result(mc, graph, test_nodes, True, seed=0)

    # ONE shared oracle pass evaluates both results (same sampled sources)
    stats, mc_stats = benchmark_sampled([g_sample, mc_sample], graph, device=dev)
    if keep is not None:
        keep.update(grank=baskets, mc=mc)

    extra = {
        "dataset": dataset,
        "device": device_label(dev),
        "engine": "dense" if use_dense_engine(graph.num_nodes, "auto") else "sparse",
        "grank_compile_s": compile_s,
        "grank_runs_s": runs,
        "iterations_ran": iters_ran,
        "basket_merges_per_s": measured_merges(graph, L, iters_ran) / elapsed,
        "jaccard_average": stats["jaccard average"],
        "jaccard_min": stats["jaccard min"],
        "kendall_average": stats["kendall average"],
        "recall_average": stats["recall average"],
        "average_map_size": stats["average map size"],
        "mc_compile_s": mc_compile_s,
        "mc_wall_time_s": mc_elapsed,
        "mc_runs_s": mc_runs,
        "mc_walk_steps": mc_info["walk_steps"],
        "mc_walk_steps_per_s": mc_info["walk_steps"] / mc_elapsed,
        "mc_abandoned_frac": mc_info["abandoned_walks"] / max(mc_info["total_walks"], 1),
        "mc_jaccard_average": mc_stats["jaccard average"],
        "mc_kendall_average": mc_stats["kendall average"],
    }
    return elapsed, extra


def bench_dense_eat(graph, device="cuda", K=K, L=L, iters=ITERS, damping=DAMPING, tol=TOL,
                    test_nodes=TEST_NODES, repeats=REPEATS):
    """The dense engine on the same canonical Eat config, with its FLOP
    rate; ``dense_mfu`` is a share of the H100's dense bf16 peak (None on
    the CPU)."""
    dev = resolve_device(device)
    run = lambda it: grank_baskets(graph, K, L, it, damping, tol, engine="dense",  # noqa: E731
                                   return_info=True, device=dev)
    _, compile_s = _timed(lambda: run(2), dev)
    (baskets, info), elapsed, runs = _median_runs(lambda: run(iters), dev, repeats)
    stats = benchmark_algorithm(baskets, graph, test_nodes, True, seed=0, device=dev)
    out = {
        "dense_compile_s": compile_s,
        "dense_wall_time_s": elapsed,
        "dense_runs_s": runs,
        "dense_iterations_ran": info["iterations_ran"],
        "dense_jaccard_average": stats["jaccard average"],
        "dense_recall_average": stats["recall average"],
    }
    if "flops" in info:
        out["dense_tflops"] = info["flops"] / elapsed / 1e12
        out["dense_mfu"] = (info["flops"] / elapsed / BF16_PEAK_FLOPS
                            if dev.type == "cuda" else None)
    return out


def bench_ring(graph, sparse_wall_s=None, device="cuda", K=K, L=L, iters=ITERS,
               damping=DAMPING, tol=TOL, repeats=REPEATS, keep=None):
    """The sharded ring path on a mesh of one shard, its ids against the
    unsharded sparse engine's; ``keep`` receives the ring baskets
    (``"ring"``)."""
    from approximated_personalized_pagerank_tpu_torch.parallel.ring import (
        ring_grank_baskets,
    )

    dev = resolve_device(device)
    shard = torch.device("cuda", torch.cuda.current_device()) if dev.type == "cuda" else dev
    mesh = make_mesh(1, [shard])
    run = lambda it: ring_grank_baskets(graph, K, L, it, damping, tol, mesh=mesh,  # noqa: E731
                                        return_info=True)
    _, compile_s = _timed(lambda: run(2), dev)
    (rb, rinfo), ring_wall, runs = _median_runs(lambda: run(iters), dev, repeats)
    sb = grank_baskets(graph, K, L, iters, damping, tol, engine="sparse", device=dev)
    if keep is not None:
        keep.update(ring=rb)
    out = {
        "ring_compile_s": compile_s,
        "ring_wall_s": ring_wall,
        "ring_runs_s": runs,
        "ring_iterations_ran": rinfo["iterations_ran"],
        "ring_ids_identical_to_sparse": bool(torch.equal(rb.ids, sb.ids)),
    }
    if sparse_wall_s:
        out["ring_vs_sparse"] = ring_wall / sparse_wall_s
    return out


def bench_scale(device="cuda", nodes=SCALE_N, edges=SCALE_E, K=K, L=L, sweeps=SCALE_SWEEPS,
                walks=SCALE_WALKS, damping=DAMPING, repeats=REPEATS):
    """Measured sparse-engine + walk-engine throughput on a uniform graph
    (1M nodes, 10M edges), with the card's peak allocated memory over the
    block (None on the CPU)."""
    from approximated_personalized_pagerank_tpu_torch.ops.walk import (
        walk_baskets,
        walk_trace_basket_chunks,
    )

    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    rng = np.random.default_rng(1)
    graph = Graph.from_edges(
        rng.integers(0, nodes, size=edges),
        rng.integers(0, nodes, size=edges),
        num_nodes=nodes,
    )
    # GRank sparse: time `sweeps` half-sweeps (tolerance < 0 disables the
    # stop so exactly that many run; warm-up with the same program)
    run = lambda it: grank_baskets(graph, K, L, it, damping, -1.0, engine="sparse",  # noqa: E731
                                   return_info=True, device=dev)
    _, compile_s = _timed(lambda: run(1), dev)
    (_, info), elapsed, runs = _median_runs(lambda: run(sweeps), dev, repeats)
    out = {
        "scale_nodes": nodes,
        "scale_edges": edges,
        "scale_compile_s": compile_s,
        "scale_grank_half_sweeps": info["iterations_ran"],
        "scale_grank_wall_s": elapsed,
        "scale_grank_runs_s": runs,
        "scale_grank_merges_per_s": measured_merges(graph, L, info["iterations_ran"]) / elapsed,
    }
    # Walk engine: R walks/node over all sources, measured visits; the
    # warm-up runs one source chunk
    _, out["scale_walk_compile_s"] = _timed(
        lambda: next(iter(walk_trace_basket_chunks(graph, L, walks, damping, seed=0,
                                                   device=dev))), dev)
    (_, winfo), walk_elapsed, walk_runs = _median_runs(
        lambda: walk_baskets(graph, L, walks, damping, seed=0, return_info=True, device=dev),
        dev, repeats)
    out["scale_walk_wall_s"] = walk_elapsed
    out["scale_walk_runs_s"] = walk_runs
    out["scale_walk_steps"] = winfo["walk_steps"]
    out["scale_walk_steps_per_s"] = winfo["walk_steps"] / walk_elapsed
    out["scale_peak_allocated_bytes"] = (
        torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None)
    return out


def bench_scale_full(device="cuda", **kwargs):
    """The north-star run end to end: 4.8M nodes / 69M edges, full sparse
    GRank to tolerance, the quality evaluation on 32 strict sources (one
    oracle batch) and full MCCompletePathV2, on one card
    (examples/run_scale_torch.py).  ``kwargs`` go to ``run_scale``."""
    spec = importlib.util.spec_from_file_location(
        "ppr_run_scale_torch", os.path.join(HERE, "examples", "run_scale_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.run_scale(test_nodes=32, device=device, **kwargs)


def result_json(elapsed, extra) -> dict:
    return {"metric": "grank_eat_wall_time", "value": elapsed, "unit": "s", "extra": extra}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="where the blocks run (default: the card)")
    parser.add_argument("--graph", default=None,
                        help="the Eat edge list as a CSV file (default: the bundled copy)")
    args = parser.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("bench_torch: no CUDA device; pass --device cpu to run on the CPU",
              file=sys.stderr)
        return 1
    dev = resolve_device(args.device)

    extra = kernel_build(dev)
    graph, dataset = load_graph(args.graph)
    elapsed, eat = bench_eat(graph, dataset, dev)
    extra.update(eat)
    result = result_json(elapsed, extra)
    print(json.dumps(result), flush=True)
    extra.update(bench_dense_eat(graph, dev))
    print(json.dumps(result), flush=True)

    failed = False

    def block(name, fn):
        nonlocal failed
        try:
            extra.update(fn())
        except Exception as e:  # kept as bench.py's key; the run then exits 1
            traceback.print_exc()
            extra[f"{name}_error"] = f"{type(e).__name__}: {e}"
            failed = True
        print(json.dumps(result), flush=True)

    block("ring", lambda: bench_ring(graph, sparse_wall_s=elapsed, device=dev))
    if os.environ.get("PPR_BENCH_SCALE", "1") != "0":
        block("scale", lambda: bench_scale(dev))
    # the north star: on by default only on the card; on the CPU the
    # 4.8M-node block would run for hours (opt in with =1, =0 skips anywhere)
    if os.environ.get("PPR_BENCH_SCALE_FULL", "1" if dev.type == "cuda" else "0") != "0":
        block("scale_full", lambda: bench_scale_full(dev))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
