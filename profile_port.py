#!/usr/bin/env python3
"""Where the PyTorch/CUDA port spends its time on the card.

    python3 profile_port.py

Runs the port's two smoke cells under ``torch.profiler``: GRank on Eat
(K=50, L=100, 30 half-sweeps, tol 1e-4, after a warm-up call) and two
half-sweeps on ``powerlaw_graph(1_000_000, 10_000_000, seed=7,
locality=0.8)``.  For each it prints one JSON line: host wall time, the
summed time of all device activities (kernels and copies), the device's
idle share of the host wall time of an unprofiled run (the work runs on one
stream, so device activities do not overlap), the merge kernel's device
time and share, the kernel launches per half-sweep, and the device
activities and host operators with the most time.  Needs a CUDA card.
"""

from __future__ import annotations

import json
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

K, L, DAMPING = 50, 100, 0.85


def _device_us(evt) -> float:
    return float(evt.self_device_time_total)


def _timed(fn) -> float:
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def profiled(name: str, fn, half_sweeps: int) -> None:
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
        "launches_per_half_sweep": launches / half_sweeps,
        "top_device": [
            {"name": e.key[:80], "calls": e.count, "device_ms": _device_us(e) / 1e3}
            for e in kernels
        ],
        "top_host_self": [
            {"name": e.key[:80], "calls": e.count, "cpu_ms": e.self_cpu_time_total / 1e3}
            for e in host
        ],
    }), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_port: no CUDA device", file=sys.stderr)
        return 1
    from approximated_personalized_pagerank_tpu_torch import grank_baskets, load_eat_graph
    from approximated_personalized_pagerank_tpu_torch.utils.synthetic import powerlaw_graph

    print(json.dumps({"device": torch.cuda.get_device_name(0)}), flush=True)
    eat = load_eat_graph()
    # Eat runs all 30 half-sweeps at this tolerance (chip_smoke.py phase 2)
    profiled("eat_grank", lambda: grank_baskets(eat, K, L, 30, DAMPING, 1e-4), 30)
    big = powerlaw_graph(1_000_000, 10_000_000, seed=7, locality=0.8)
    profiled("powerlaw_1m_2_sweeps",
             lambda: grank_baskets(big, K, L, 2, DAMPING, -1.0), 2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
