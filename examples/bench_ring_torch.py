#!/usr/bin/env python
"""Ring scaling of the PyTorch port at D in {1, 2, 4, 8} shards.  The
port's counterpart of ``examples/bench_ring.py``.

Times ring GRank half-sweeps on one graph at each shard count and reports
the rounds of the ring plan, the comm-volume model and the ring's memory
account (``info["memory"]``).  The shards are virtual shards on the first
card (or on the CPU with ``--device cpu``): a rotation moves nothing
there, so the wall times measure D shards' work on one device, not a ring,
and ``ring_bytes_total`` is the model's volume on D devices, not a
measurement.

Comm model (parallel/ring.py): each half-sweep rotates the old basket
shard D-1 times per round, so a device sends
``rounds * (D-1)/D * n_pad * L * 8`` bytes per half-sweep; total ring
traffic per half-sweep is D times that.

Usage:
    python examples/bench_ring_torch.py [--nodes 200000] [--edges 2000000] [--device cpu]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from approximated_personalized_pagerank_tpu_torch import make_mesh
from approximated_personalized_pagerank_tpu_torch.ops.merge import resolve_merge_algo
from approximated_personalized_pagerank_tpu_torch.parallel.ring import (
    build_ring_plan,
    ring_grank_baskets,
)
from approximated_personalized_pagerank_tpu_torch.utils.device import (
    card_line,
    synchronize,
)
from approximated_personalized_pagerank_tpu_torch.utils.synthetic import powerlaw_graph

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from run_sharded_torch import shard_devices  # noqa: E402

NOTE = ("virtual shards on one device: a rotation moves nothing; wall times "
        "measure D shards' work on one device, ring_bytes_total is the model's "
        "volume on D devices")


def bench_ring(nodes=200_000, edges=2_000_000, half_sweeps=4, L=100, K=50,
               shards=(1, 2, 4, 8), device=None, out=print) -> list:
    """One row per shard count (printed as a JSON line each); returns them."""
    graph = powerlaw_graph(nodes, edges, seed=11)
    card = card_line() if shard_devices(1, device)[0].type == "cuda" else None
    out(json.dumps({"graph": repr(graph), "max_out_degree": int(graph.out_degree.max()),
                    "nvidia_smi": card, "note": NOTE}))
    rows, base = [], None
    for d in shards:
        devices = shard_devices(d, device)
        mesh = make_mesh(d, devices)
        algo = resolve_merge_algo(None, devices[0])
        # warm-up: one half-sweep (plans, allocator), excluded from timing
        ring_grank_baskets(graph, K, L, 1, 0.85, -1.0, mesh=mesh)
        synchronize(devices[0])
        t0 = time.perf_counter()
        _, info = ring_grank_baskets(graph, K, L, half_sweeps, 0.85, -1.0, mesh=mesh,
                                     analyze_memory=True)
        synchronize(devices[0])
        wall = time.perf_counter() - t0
        s = -(-graph.num_nodes // d)
        rounds = len(build_ring_plan(graph, 0, d, L, algo=algo).rounds)
        mem = info["memory"]
        row = {
            "shards": d,
            "wall_s": wall,
            "per_half_sweep_s": wall / info["iterations_ran"],
            "iterations_ran": info["iterations_ran"],
            "rounds_per_sweep": rounds,
            "ring_bytes_total": rounds * (d - 1) * s * L * 8 * half_sweeps,
            "shard_bytes_planned": mem["shard_bytes"],
            "full_basket_bytes": mem["full_basket_bytes"],
            "device_peak_bytes": max(mem["device_peak_bytes"].values(), default=None),
            "speedup_vs_1": base / wall if base else 1.0,
        }
        if base is None:
            base = wall
        rows.append(row)
        out(json.dumps(row))
    out(json.dumps({"ring_scaling": rows, "note": NOTE}))
    return rows


def main():
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--nodes", type=int, default=200_000)
    ap.add_argument("--edges", type=int, default=2_000_000)
    ap.add_argument("--half-sweeps", type=int, default=4)
    ap.add_argument("--L", type=int, default=100)
    ap.add_argument("--K", type=int, default=50)
    ap.add_argument("--shards", type=str, default="1,2,4,8",
                    help="comma-separated shard counts")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()
    bench_ring(args.nodes, args.edges, args.half_sweeps, args.L, args.K,
               tuple(int(x) for x in args.shards.split(",")), device=args.device)


if __name__ == "__main__":
    main()
