#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the fused merge kernel from the repository's sources, holds it
against its plain PyTorch version on the card, then drives the port's main
path: sparse GRank on the bundled Eat graph (scored against the exact
oracle) and two half-sweeps on a 1M-node power-law graph that takes the hub
path.  Each phase prints one JSON line; any failure exits non-zero.  The
last line is ``{"ok": true, "device": {...}}``.  Exits non-zero, printing
no result, when no CUDA device is present.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

K, L, ITERS, DAMPING, TOL = 50, 100, 30, 0.85, 1e-4
WIDTHS = (256, 512, 1024, 2048, 4096, 8192)
L_PADS = (128, 256)
ROWS_PER_CASE = 320
# Eat's widest merge chunks at L=100 and the default element budget
# (1<<22 candidates): C rows of width W.
EAT_SHAPES = ((8192, 517), (4096, 1048))
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, and 32-bit operations/s
# outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
KERNEL_SOURCE = "approximated_personalized_pagerank_tpu_torch/csrc/merge_topl.cu"
REPLACES = "approximated_personalized_pagerank_tpu/ops/pallas/merge_kernel.py:91"
ATOL = 1e-6
EAT_REPEATS = 5


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


# ------------------------------------------------------------ phase 1 inputs
def kernel_cases(w: int, rows: int, rng: np.random.Generator, pad_id: int):
    """[rows, w] candidate rows of five kinds, scores summing to <= 1 per
    row like GRank's: heavy duplicates, all-PAD rows, rows with fewer live
    entries than l_pad, all-zero live scores, and wide-id rows."""
    ids = np.full((rows, w), pad_id, dtype=np.int32)
    scores = np.zeros((rows, w), dtype=np.float32)
    for r in range(rows):
        kind = r % 5
        if kind == 1:  # all PAD
            continue
        live = {0: w, 2: int(rng.integers(1, 100)), 3: w // 2, 4: w - w // 8}[kind]
        hi = {0: max(2, w // 16), 2: 1000, 3: 50, 4: 23132}[kind]
        ids[r, :live] = rng.integers(0, hi, live)
        s = rng.random(live).astype(np.float32)
        scores[r, :live] = 0.0 if kind == 3 else s / s.sum()
        perm = rng.permutation(w)
        ids[r] = ids[r, perm]
        scores[r] = scores[r, perm]
    return ids, scores


def time_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def network_ops(w: int) -> int:
    """Compare-exchanges of one bitonic sort of a width-w row."""
    lg = int(math.log2(w))
    return w // 2 * lg * (lg + 1) // 2


def bound_ms(c: int, w: int, l_pad: int) -> tuple:
    """Least time for the merge of [c, w] -> [c, l_pad] on an H100: each
    input byte read once and each output byte written once, against the
    compare-exchanges of one id-sort network at one 32-bit op each."""
    t_bytes = (c * w * 8 + c * l_pad * 8) / HBM_BYTES_PER_S * 1e3
    t_ops = c * network_ops(w) / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def measured_merges(graph, half_sweeps: int) -> int:
    """Basket-merge slot updates performed: for each half-sweep, every edge
    out of the active partition contributes one basket of L slots
    (partition 0 sweeps first).  The formula of bench.py."""
    part = graph.partition
    deg = graph.out_degree.astype(np.int64)
    e0 = int(deg[part == 0].sum())
    e1 = int(deg[part == 1].sum())
    return (((half_sweeps + 1) // 2) * e0 + (half_sweeps // 2) * e1) * L


def phase_device():
    """Phase 0: the card, and the kernel's build time."""
    from approximated_personalized_pagerank_tpu_torch.ops import merge_kernel

    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi_line()
    t0 = time.perf_counter()
    merge_kernel.load_library()
    emit({"phase": 0, "device": name, "count": count, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "kernel_build_s": time.perf_counter() - t0})
    return name, count, smi


def phase_kernel():
    """Phase 1: the kernel against its plain version at every (W, l_pad),
    and both timed at Eat's widest chunk shapes."""
    from approximated_personalized_pagerank_tpu_torch.ops import merge_kernel
    from approximated_personalized_pagerank_tpu_torch.utils.compare import (
        topl_max_error,
    )

    kernel = merge_kernel.fused_merge_topl
    plain = merge_kernel.merge_topl_plain
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    max_err = 0.0
    cases = []
    for w in WIDTHS:
        ids_np, sc_np = kernel_cases(w, ROWS_PER_CASE, rng, merge_kernel.PAD_ID)
        ids = torch.as_tensor(ids_np, device=dev)
        sc = torch.as_tensor(sc_np, device=dev)
        for l_pad in L_PADS:
            k_ids, k_sc = kernel(ids, sc, l_pad)
            p_ids, p_sc = plain(ids, sc, l_pad)
            torch.cuda.synchronize()
            err = topl_max_error(k_ids.cpu().numpy(), k_sc.cpu().numpy(),
                               p_ids.cpu().numpy(), p_sc.cpu().numpy(), ATOL)
            max_err = max(max_err, err)
            cases.append({"W": w, "l_pad": l_pad, "rows": ROWS_PER_CASE,
                          "max_abs_err": err})
    timings = []
    for w, c in EAT_SHAPES:
        ids_np = rng.integers(0, 23132, (c, w)).astype(np.int32)
        ids_np[rng.random((c, w)) < 0.15] = merge_kernel.PAD_ID
        ids = torch.as_tensor(ids_np, device=dev)
        sc = torch.as_tensor(rng.random((c, w)).astype(np.float32) / w, device=dev)
        ms = time_ms(lambda: kernel(ids, sc, 128), 20)
        plain_ms = time_ms(lambda: plain(ids, sc, 128), 5)
        b_ms, b_by = bound_ms(c, w, 128)
        timings.append({"W": w, "C": c, "l_pad": 128, "ms": ms,
                        "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by})
    emit({"phase": 1, "atol": ATOL, "max_abs_err": max_err, "cases": cases,
          "timings": timings})
    return max_err, timings


def phase_eat() -> int:
    """Phase 2: the headline, GRank on Eat through the kernel, against the
    sort pipeline and the exact oracle.  ``wall_s`` is the median of
    EAT_REPEATS timed calls; the launch counts are the first call's.
    Returns the main path's launches."""
    from approximated_personalized_pagerank_tpu_torch import (
        benchmark_sampled,
        grank_baskets,
        load_eat_graph,
        sample_result,
    )
    from approximated_personalized_pagerank_tpu_torch.ops.basket import jaccard_rows
    from approximated_personalized_pagerank_tpu_torch.ops.merge_kernel import (
        fused_merge_topl as kernel,
    )

    graph = load_eat_graph()
    grank_baskets(graph, K, L, 2, DAMPING, TOL, return_info=True)
    torch.cuda.synchronize()
    kernel.launches.clear()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    baskets, info = grank_baskets(graph, K, L, ITERS, DAMPING, TOL, return_info=True)
    torch.cuda.synchronize()
    walls = [time.perf_counter() - t0]
    launches = dict(kernel.launches)
    peak = torch.cuda.max_memory_allocated()
    n_launch = sum(launches.values())
    check(n_launch > 0, "the Eat run launched no merge kernel")
    check(tuple(baskets.ids.shape) == (graph.num_nodes, K), "Eat baskets have the wrong shape")
    check(bool(torch.isfinite(baskets.scores).all()), "non-finite Eat scores")
    iters = info["iterations_ran"]
    for _ in range(EAT_REPEATS - 1):  # the run-to-run spread of the wall time
        t0 = time.perf_counter()
        grank_baskets(graph, K, L, ITERS, DAMPING, TOL)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall = float(np.median(walls))

    t0 = time.perf_counter()
    sorted_b, sort_info = grank_baskets(
        graph, K, L, ITERS, DAMPING, TOL, merge_algo="sort", return_info=True
    )
    torch.cuda.synchronize()
    sort_wall = time.perf_counter() - t0
    agree = float(jaccard_rows(baskets.ids, sorted_b.ids).mean())
    samples = [sample_result(b, graph, 200, True, seed=0) for b in (baskets, sorted_b)]
    stats, sort_stats = benchmark_sampled(samples, graph)
    emit({"phase": 2, "graph": "eat", "nodes": graph.num_nodes,
          "edges": graph.num_edges, "wall_s": wall, "walls_s": walls,
          "iterations_ran": iters,
          "basket_merges_per_s": measured_merges(graph, iters) / wall,
          "kernel_launches": {f"{w}x{lp}": v for (w, lp), v in sorted(launches.items())},
          "peak_bytes": peak, "sort_wall_s": sort_wall,
          "sort_iterations_ran": sort_info["iterations_ran"],
          "kernel_vs_sort_jaccard": agree,
          "jaccard_average": stats["jaccard average"],
          "jaccard_min": stats["jaccard min"],
          "recall_average": stats["recall average"],
          "kendall_average": stats["kendall average"],
          "average_map_size": stats["average map size"],
          "sort_jaccard_average": sort_stats["jaccard average"],
          "sort_recall_average": sort_stats["recall average"],
          "sort_kendall_average": sort_stats["kendall average"]})
    check(agree >= 0.98, f"kernel vs sort mean jaccard {agree} < 0.98")
    check(stats["jaccard average"] >= 0.90, "Eat jaccard_average < 0.90")
    check(stats["recall average"] >= 0.94, "Eat recall_average < 0.94")
    return n_launch


def phase_scale() -> None:
    """Phase 3: two half-sweeps at 1M nodes, through the hub path."""
    from approximated_personalized_pagerank_tpu_torch import grank_baskets
    from approximated_personalized_pagerank_tpu_torch.ops.merge_kernel import (
        MAX_KERNEL_WIDTH,
        fused_merge_topl as kernel,
    )
    from approximated_personalized_pagerank_tpu_torch.utils.synthetic import (
        powerlaw_graph,
    )

    t0 = time.perf_counter()
    big = powerlaw_graph(1_000_000, 10_000_000, seed=7, locality=0.8)
    hub_sub = (MAX_KERNEL_WIDTH - 1) // L
    plans = [big.merge_plan(p, L=L, net_width=MAX_KERNEL_WIDTH) for p in (0, 1)]
    hub_rows = sum(b.rows.size for p in plans for b in p.buckets if b.cap > hub_sub)
    setup_s = time.perf_counter() - t0
    check(hub_rows > 0, "the 1M graph has no hub rows")
    kernel.launches.clear()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out, info = grank_baskets(big, K, L, 2, DAMPING, -1.0, return_info=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernel.launches)
    peak = torch.cuda.max_memory_allocated()
    wide = sum(v for (w, lp), v in launches.items() if lp == 256)
    rows = torch.as_tensor(
        np.random.default_rng(1).choice(big.num_nodes, 4096, replace=False),
        device="cuda",
    )
    ids = out.ids[rows].cpu().numpy()
    sc = out.scores[rows].cpu().numpy()
    emit({"phase": 3, "graph": "powerlaw(1e6, 1e7, seed=7, locality=0.8)",
          "setup_s": setup_s, "wall_s": wall,
          "iterations_ran": info["iterations_ran"], "peak_bytes": peak,
          "hub_rows": int(hub_rows), "l_pad_256_launches": wide,
          "kernel_launches": {f"{w}x{lp}": v for (w, lp), v in sorted(launches.items())},
          "basket_merges_per_s": measured_merges(big, 2) / wall})
    check(wide > 0, "no l_pad=256 (hub group) launches at 1M nodes")
    check(np.isfinite(sc).all(), "non-finite scores at 1M nodes")
    for r in range(ids.shape[0]):
        live = ids[r] >= 0
        s = sc[r][live]
        check(np.all(np.diff(s) <= 0), f"1M row {r}: not descending")
        check(np.unique(ids[r][live]).size == live.sum(), f"1M row {r}: repeated ids")
        check(s.sum() <= 1 + 1e-4, f"1M row {r}: row sum {s.sum()} > 1")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    name, count, smi = phase_device()
    max_err, timings = phase_kernel()
    n_launch = phase_eat()
    phase_scale()
    t = timings[0]  # Eat's widest chunk, W=8192
    emit({"kernels": [{
        "name": "fused_merge_topl", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES, "launches": n_launch, "max_abs_err": max_err,
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": None,
    }]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
