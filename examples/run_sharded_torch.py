#!/usr/bin/env python
"""Sharded demo of the PyTorch port: ring-sharded GRank and sharded
MCCompletePathV2 on D shards, with the ring's memory figures.  The port's
counterpart of ``examples/run_sharded.py``.

The shards are D virtual shards on the first card (``[cuda:0] * D``), or
D shards on the CPU with ``--device cpu``.  Virtual shards on one card
run the sharded code and its plan, but a rotation moves nothing; with
several cards, ``grank_multi`` over ``init_distributed`` runs a real ring.
Memory is the ring's own account (``info["memory"]``): the plan's bytes
for one shard's live buffers, and each card's peak allocation.

Usage:
    python examples/run_sharded_torch.py [n_shards] [nodes] [edges] [--device cpu]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np
import torch

from approximated_personalized_pagerank_tpu_torch import (
    Graph,
    make_mesh,
    mccompletepathv2_baskets,
)
from approximated_personalized_pagerank_tpu_torch.parallel.ring import ring_grank_baskets
from approximated_personalized_pagerank_tpu_torch.utils.device import (
    card_line,
    resolve_device,
    synchronize,
)

K, L, ITERS, DAMPING, TOL = 50, 100, 10, 0.85, 1e-4
MC_R = 200


def shard_devices(n_shards: int, device=None) -> list:
    """``n_shards`` virtual shards on the first card, or on the CPU."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", 0 if dev.index is None else dev.index)
    return [dev] * n_shards


def run_sharded(n_shards=8, n=100_000, e=1_000_000, device=None, out=print) -> dict:
    """Ring GRank and sharded MC on ``n_shards`` shards; returns walls,
    half-sweeps, the memory figures and the walk steps."""
    devices = shard_devices(n_shards, device)
    rng = np.random.default_rng(0)
    graph = Graph.from_edges(rng.integers(0, n, size=e), rng.integers(0, n, size=e),
                             num_nodes=n)
    mesh = make_mesh(n_shards, devices)
    out(f"graph: {graph}; mesh: {n_shards} virtual shards on {devices[0]}"
        + (f" ({card_line()})" if devices[0].type == "cuda" else ""))

    t0 = time.perf_counter()
    baskets, info = ring_grank_baskets(graph, K, L, ITERS, DAMPING, TOL, mesh=mesh,
                                       analyze_memory=True)
    synchronize(devices[0])
    grank_s = time.perf_counter() - t0
    mem = info["memory"]
    peak = max(mem["device_peak_bytes"].values(), default=None)
    non_empty = int((baskets.ids[:, 0] >= 0).sum())
    out(f"ring grank: {info['iterations_ran']} half-sweeps in {grank_s:.1f}s "
        f"(first call); {non_empty}/{n} non-empty baskets")
    out(f"planned bytes of one shard: {mem['shard_bytes'] / 1e6:.1f} MB vs full basket "
        f"{mem['full_basket_bytes'] / 1e6:.1f} MB "
        f"({mem['shard_bytes'] / mem['full_basket_bytes']:.0%})"
        + (f"; card peak {peak / 1e6:.1f} MB for all {n_shards} shards" if peak else ""))

    t0 = time.perf_counter()
    mc, mc_info = mccompletepathv2_baskets(graph, K, L, MC_R, DAMPING, seed=0, mesh=mesh,
                                           return_info=True)
    synchronize(devices[0])
    mc_s = time.perf_counter() - t0
    out(f"sharded mccompletepathv2: {mc_s:.1f}s ({mc_info['walk_steps']} walk hops, "
        f"source-sharded walks + ring combine)")
    return {"n_shards": n_shards, "grank_s": grank_s,
            "iterations_ran": info["iterations_ran"], "non_empty_baskets": non_empty,
            "memory": mem, "mc_s": mc_s, "mc_walk_steps": mc_info["walk_steps"],
            "baskets": baskets, "mc": mc}


def main():
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("n_shards", nargs="?", type=int, default=8)
    ap.add_argument("nodes", nargs="?", type=int, default=100_000)
    ap.add_argument("edges", nargs="?", type=int, default=1_000_000)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()
    run_sharded(args.n_shards, args.nodes, args.edges, device=args.device)


if __name__ == "__main__":
    main()
