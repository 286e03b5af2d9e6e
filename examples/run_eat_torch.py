#!/usr/bin/env python
"""The reference driver's run (src/main.cc:30-76) on the PyTorch port:
import the Eat graph, run GRank and MCCompletePathV2 with the canonical
parameters, time each, and print the five benchmark statistics for 200
strict-sampled sources.  The port's counterpart of ``examples/run_eat.py``.

Usage:
    python examples/run_eat_torch.py [path/to/edges.csv] [--device cpu]

Without a path it reads the bundled Eat graph.  Runs on the card unless
``--device cpu`` is given (Eat's MC takes the dense engine under auto,
a [23,132, 23,132] product on the CPU: minutes).
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from approximated_personalized_pagerank_tpu_torch import (
    benchmark_algorithm,
    eat_graph_path,
    grank_baskets,
    load_csv_graph,
    mccompletepathv2_baskets,
)
from approximated_personalized_pagerank_tpu_torch.utils.device import (
    card_line,
    resolve_device,
    synchronize,
)

# the reference driver's calls: grank(50, 100, 30, 0.85, 1e-4) and
# mccompletepathv2(50, 200, 1000, 0.85)
K, L, ITERATIONS, DAMPING, TOL = 50, 100, 30, 0.85, 1e-4
MC_L, MC_R = 200, 1000


def report(name, fn, graph, dev, test_nodes, out=print) -> dict:
    """Time one call (ended by a synchronize), then print its statistics
    as the reference does; returns them with the time."""
    t0 = time.perf_counter()
    baskets = fn()
    synchronize(dev)
    ms = (time.perf_counter() - t0) * 1000
    out(f"{name} run-time = {ms:.0f} ms")
    stats = benchmark_algorithm(baskets, graph, test_nodes, True, seed=0, device=dev)
    out("-------")
    for k, v in stats.items():
        out(f"{k}     {v:.6g}")
    out("-------")
    return {"run_time_ms": ms, **stats}


def run_eat(path=None, device=None, test_nodes=200, iterations=ITERATIONS, mc_r=MC_R,
            out=print) -> dict:
    """The driver's run; returns ``{"grank": {...}, "mccompletepathv2": {...}}``
    with each call's ``run_time_ms`` and statistics.  ``iterations`` and
    ``mc_r`` are the reference's 30 and 1000 unless a caller cuts them."""
    dev = resolve_device(device)
    graph = load_csv_graph(path or eat_graph_path())
    out(f"nodes: {graph.num_nodes} edges: {graph.num_edges}")
    if dev.type == "cuda":
        out(f"card: {card_line()}")
    # warm-up calls, so the timings below do not include first-call costs
    # (the kernel build, allocator growth); MC's warm-up takes seed 1 and the
    # timed run seed 0, as run_eat.py does
    out("warming up...")
    grank_baskets(graph, K, L, 2, DAMPING, TOL, device=dev)
    mccompletepathv2_baskets(graph, K, MC_L, mc_r, DAMPING, seed=1, device=dev)
    synchronize(dev)
    return {
        "grank": report(
            "grank", lambda: grank_baskets(graph, K, L, iterations, DAMPING, TOL, device=dev),
            graph, dev, test_nodes, out),
        "mccompletepathv2": report(
            "mccompletepathv2",
            lambda: mccompletepathv2_baskets(graph, K, MC_L, mc_r, DAMPING, seed=0, device=dev),
            graph, dev, test_nodes, out),
    }


def main():
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("path", nargs="?", default=None, help="edge-list CSV (default: Eat)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()
    run_eat(args.path, device=args.device)


if __name__ == "__main__":
    main()
