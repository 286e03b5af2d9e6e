#!/usr/bin/env python
"""Scalability demo of the PyTorch port: the sparse engine on a synthetic
large graph.  The port's counterpart of ``examples/run_synthetic.py``.

Builds a uniform random directed graph (defaults: 1M nodes / 10M edges),
runs GRank half-sweeps and the MC walk phase on the card, and prints the
two throughput counters: basket-merge slot-updates/s and walk steps/s.

Usage:
    python examples/run_synthetic_torch.py [nodes] [edges] [iterations] [--device cpu]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np

from approximated_personalized_pagerank_tpu_torch import Graph, grank_baskets, walk_baskets
from approximated_personalized_pagerank_tpu_torch.utils.device import (
    card_line,
    resolve_device,
    synchronize,
)

K, L, DAMPING, TOL = 50, 100, 0.85, 1e-4
WALK_R = 200


def run_synthetic(n=1_000_000, e=10_000_000, iters=4, device=None, out=print) -> dict:
    """Half-sweeps and walks on the uniform graph; returns the counters."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    graph = Graph.from_edges(rng.integers(0, n, size=e), rng.integers(0, n, size=e),
                             num_nodes=n)
    out(f"graph: {graph} (synthetic uniform); device {dev}"
        + (f" ({card_line()})" if dev.type == "cuda" else ""))

    t0 = time.perf_counter()
    grank_baskets(graph, K, L, 1, DAMPING, TOL, engine="sparse", device=dev)
    synchronize(dev)
    warm = time.perf_counter() - t0
    out(f"  warm-up (1 half-sweep, plans included): {warm:.1f}s")

    t0 = time.perf_counter()
    _, info = grank_baskets(graph, K, L, iters, DAMPING, TOL, engine="sparse",
                            return_info=True, device=dev)
    synchronize(dev)
    grank_s = time.perf_counter() - t0
    # each half-sweep covers the active partition's edges
    part = graph.partition
    deg = graph.out_degree.astype(np.int64)
    e_p = [int(deg[part == p].sum()) for p in (0, 1)]
    h = info["iterations_ran"]
    merges = ((h + 1) // 2 * e_p[0] + h // 2 * e_p[1]) * L
    out(f"grank sparse: {h} half-sweeps in {grank_s:.2f}s "
        f"-> {merges / grank_s / 1e6:.0f}M basket-merge slot-updates/s (measured)")

    out(f"walk phase (trace engine, R={WALK_R})...")
    t0 = time.perf_counter()
    _, winfo = walk_baskets(graph, L, WALK_R, DAMPING, seed=1, engine="trace",
                            return_info=True, device=dev)
    synchronize(dev)
    walk_s = time.perf_counter() - t0
    out(f"walks: {n} sources x {WALK_R} walks in {walk_s:.2f}s "
        f"-> {winfo['walk_steps'] / walk_s / 1e6:.1f}M walk-steps/s (measured)")
    return {"nodes": n, "edges": e, "warmup_s": warm, "half_sweeps": h,
            "grank_s": grank_s, "merges_per_s": merges / grank_s, "walk_s": walk_s,
            "walk_steps": winfo["walk_steps"], "walk_steps_per_s": winfo["walk_steps"] / walk_s,
            "abandoned_walks": winfo["abandoned_walks"], "total_walks": winfo["total_walks"]}


def main():
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("nodes", nargs="?", type=int, default=1_000_000)
    ap.add_argument("edges", nargs="?", type=int, default=10_000_000)
    ap.add_argument("iterations", nargs="?", type=int, default=4)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()
    run_synthetic(args.nodes, args.edges, args.iterations, device=args.device)


if __name__ == "__main__":
    main()
