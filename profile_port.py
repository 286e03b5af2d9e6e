#!/usr/bin/env python3
"""Where the PyTorch/CUDA port spends its time on the card.

    python3 profile_port.py [grank|mc|dense]

Runs the port's smoke cells under ``torch.profiler`` (no argument: all
three modes).  ``grank``: sparse GRank on Eat (K=50, L=100, 30
half-sweeps, tol 1e-4) and two half-sweeps on
``powerlaw_graph(1_000_000, 10_000_000, seed=7, locality=0.8)``.  ``mc``:
sparse MCCompletePathV2 on Eat (K=50, L=200, R=1000, seed 1, as
chip_smoke.py phase 4) and its walks alone (``walk_baskets``, the trace
top-L included).  ``dense``: the dense engine on Eat (chip_smoke.py phase
6): GRank as above, and MCCompletePathV2 through ``engine="auto"``.
Every cell runs twice
unprofiled (a warm-up, then the timed call) and once profiled.  For each it
prints one JSON line: host wall time, the summed time of all device
activities (kernels and copies), the device's idle share of the host wall
time of the unprofiled call (the work runs on one stream, so device
activities do not overlap), the merge kernel's device time and share, the
kernel launches per unit of work (half-sweep, or walk source chunk), and
the device activities and host operators with the most time.  Needs a
CUDA card.
"""

from __future__ import annotations

import json
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

K, L, DAMPING = 50, 100, 0.85
MC_K, MC_L, MC_R = 50, 200, 1000


def _device_us(evt) -> float:
    return float(evt.self_device_time_total)


def _timed(fn) -> float:
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def profiled(name: str, fn, units: int, unit: str) -> float:
    """Profile one call of ``fn`` (see the module doc); ``units`` of
    ``unit`` divide its launches.  Returns the unprofiled wall time."""
    _timed(fn)  # warm-up: builds the kernel, fills the allocator's pools
    wall = _timed(fn)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        profiled_wall = _timed(fn)
    events = prof.key_averages()
    # device activities only: a host operator also reports the device time
    # of the kernels it launched, which would count them twice
    device = [e for e in events if e.device_type == DeviceType.CUDA]
    device_s = sum(_device_us(e) for e in device) / 1e6
    kernels = sorted(device, key=_device_us, reverse=True)[:12]
    merge_s = sum(_device_us(e) for e in device if "merge_kernel" in e.key) / 1e6
    # basket rows read by advanced indexing (basket.ids[...]) outside the kernel
    vgather = [e for e in device if "vectorized_gather" in e.key]
    launches = sum(e.count for e in events if e.device_type == DeviceType.CPU
                   and e.key in ("cudaLaunchKernel", "cuLaunchKernel"))
    host = sorted(
        (e for e in events if e.device_type == DeviceType.CPU),
        key=lambda e: e.self_cpu_time_total, reverse=True,
    )[:12]
    print(json.dumps({
        "cell": name,
        "wall_s": wall,
        "profiled_wall_s": profiled_wall,
        "device_busy_s": device_s,
        "device_idle_share": 1.0 - device_s / wall,
        "device_activities": sum(e.count for e in device),
        "merge_kernel_s": merge_s,
        "merge_kernel_share_of_busy": merge_s / device_s,
        "vectorized_gather_calls": sum(e.count for e in vgather),
        "vectorized_gather_ms": sum(_device_us(e) for e in vgather) / 1e3,
        "kernel_launches": launches,
        f"launches_per_{unit}": launches / units,
        "top_device": [
            {"name": e.key[:80], "calls": e.count, "device_ms": _device_us(e) / 1e3}
            for e in kernels
        ],
        "top_host_self": [
            {"name": e.key[:80], "calls": e.count, "cpu_ms": e.self_cpu_time_total / 1e3}
            for e in host
        ],
    }), flush=True)
    return wall


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_port: no CUDA device", file=sys.stderr)
        return 1
    from approximated_personalized_pagerank_tpu_torch import (
        grank_baskets,
        load_eat_graph,
        mccompletepathv2_baskets,
        walk_baskets,
    )
    from approximated_personalized_pagerank_tpu_torch.ops.walk import _trace_chunks
    from approximated_personalized_pagerank_tpu_torch.utils.synthetic import powerlaw_graph

    modes = sys.argv[1:] or ["grank", "mc", "dense"]
    if set(modes) - {"grank", "mc", "dense"}:
        print(f"profile_port: unknown mode in {modes}", file=sys.stderr)
        return 2
    print(json.dumps({"device": torch.cuda.get_device_name(0)}), flush=True)
    eat = load_eat_graph()
    if "grank" in modes:
        # Eat runs all 30 half-sweeps at this tolerance (chip_smoke.py phase 2)
        profiled("eat_grank",
                 lambda: grank_baskets(eat, K, L, 30, DAMPING, 1e-4, engine="sparse"),
                 30, "half_sweep")
        big = powerlaw_graph(1_000_000, 10_000_000, seed=7, locality=0.8)
        profiled("powerlaw_1m_2_sweeps",
                 lambda: grank_baskets(big, K, L, 2, DAMPING, -1.0, engine="sparse"),
                 2, "half_sweep")
    if "mc" in modes:
        chunk = _trace_chunks(eat.num_nodes, MC_R, DAMPING, None, None, 32)[0]
        chunks = -(-eat.num_nodes // chunk)
        mc_wall = profiled(
            "eat_mc",
            lambda: mccompletepathv2_baskets(eat, MC_K, MC_L, MC_R, DAMPING, seed=1,
                                             engine="sparse"),
            chunks, "walk_chunk")
        walk_wall = profiled(
            "eat_mc_walks", lambda: walk_baskets(eat, MC_L, MC_R, DAMPING, seed=1),
            chunks, "walk_chunk")
        print(json.dumps({"cell": "eat_mc", "walk_share_of_wall": walk_wall / mc_wall}),
              flush=True)
    if "dense" in modes:
        profiled("eat_dense_grank",
                 lambda: grank_baskets(eat, K, L, 30, DAMPING, 1e-4, engine="dense"),
                 30, "half_sweep")
        chunk = _trace_chunks(eat.num_nodes, MC_R, DAMPING, None, None, 32)[0]
        profiled("eat_dense_mc",  # auto: dense up to 32,768 nodes
                 lambda: mccompletepathv2_baskets(eat, MC_K, MC_L, MC_R, DAMPING, seed=1),
                 -(-eat.num_nodes // chunk), "walk_chunk")
    return 0


if __name__ == "__main__":
    sys.exit(main())
