#!/usr/bin/env python3
"""Where the PyTorch/CUDA port spends its time on the card.

    python3 profile_port.py [grank|mc|dense|ring|gather|tiebranch]

Runs the port's smoke cells under ``torch.profiler`` (no argument: the
first four modes).  ``grank``: sparse GRank on Eat (K=50, L=100, 30
half-sweeps, tol 1e-4) and two half-sweeps on
``powerlaw_graph(1_000_000, 10_000_000, seed=7, locality=0.8)``.  ``mc``:
sparse MCCompletePathV2 on Eat (K=50, L=200, R=1000, seed 1, as
chip_smoke.py phase 4) and its walks alone (``walk_baskets``, the trace
top-L included).  ``dense``: the dense engine on Eat (chip_smoke.py phase
6): GRank as above, and MCCompletePathV2 through ``engine="auto"``.
``ring``: GRank on Eat as above through the ring (chip_smoke.py phase 7) at
D=1 and at D=4 virtual shards on the one card.  Every cell runs twice
unprofiled (a warm-up, then the timed call) and once profiled.  For each it
prints one JSON line: host wall time, the summed time of all device
activities (kernels and copies), the device's idle share of the host wall
time of the unprofiled call (the work runs on one stream, so device
activities do not overlap), the merge kernel's device time and share, the
kernel launches per unit of work (half-sweep, or walk source chunk), and
the device activities and host operators with the most time.  ``gather`` is no
profiler cell: it splits the merge kernel's gather entry into its stages by
building copies of ``csrc/merge_topl.cu`` with a stage cut out (the run
sorts, the merge levels, everything after the merge, or step 4d, the tied
rows' prune network), and times each
with CUDA events beside the whole kernel on real basket state at its
widest bucket: Eat's GRank baskets after two half-sweeps, Eat's MC walk
baskets (the combine's input) and the 1M graph's GRank baskets after two
half-sweeps.  A cut copy computes wrong
baskets; only its time is read.  It also times, bucket by bucket over those
states and the 1M graph's after two half-sweeps, the kernel as built (the
run merge on rows of 8192, the network below) beside a copy that takes the
run merge from 512 up, whose output is checked bitwise
equal, and beside the copy without step 4d.  ``tiebranch`` sets step
4d's threshold: it times the matrix entry on tied rows of m live keys
(``chip_smoke.py::live_count_rows``) at GRank's and MC's widths, built
with the live form taking every m its lanes hold, with the dense network
always and with no step 4d, beside the kernel as built (and on untied
rows).  Needs a CUDA card.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import time

import numpy as np
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


# Tied rows write what step 4c left: wrong for them, timed only.
NO_STEP_4D = ("no_step_4d", "  if (!tied) {\n", "  if (true) {\n")
# Stage cuts of the gather entry: (name, text of csrc/merge_topl.cu, its
# replacement).  "steps_1_2" returns after the merge, keeping its keys live.
GATHER_CUTS = (
    ("no_run_sort", "  sort_keys<EW>(key, lane, 32 * EW, sm);  // one warp: sm is not touched\n",
     ""),
    ("no_merge", "  while ((1 << levels) < n_runs) ++levels;\n", ""),
    ("steps_1_2", "    live_n = gather_by_run<E>(g, row, t, nt, sm, cum, key);\n",
     "    live_n = gather_by_run<E>(g, row, t, nt, sm, cum, key);\n"
     "    uint64_t x = 0;\n    for (int e = 0; e < E; ++e) x ^= key[e];\n"
     "    if (x == 0x12345ull) out_ids[row] = 1;\n    return;\n"),
    ("run_merge_from_512", "n == kRunMergeWidth && lb <= kMaxRunWidth",
     "n >= 512 && lb <= kMaxRunWidth"),
    NO_STEP_4D,
)
# Step 4d's two forms, for the tiebranch mode: the live form for every m
# the block's lanes hold (4 a lane), the dense network always, and no step
# 4d.
LIVE_SHARE = "constexpr int kLiveShare = "
TIE_FORMS = (
    ("live", LIVE_SHARE, LIVE_SHARE + "1; //"),
    ("dense", LIVE_SHARE, LIVE_SHARE + "(1 << 20); //"),
    NO_STEP_4D,
)


def _variant_libs(cuts, entry: str) -> dict:
    """The whole kernel and each variant (name, anchor, replacement) of its
    source, built in parallel into build/kernels/; name -> the C entry
    ``entry``."""
    from approximated_personalized_pagerank_tpu_torch.ops import merge_kernel as mk

    whole = mk.load_library()
    with open(mk.KERNEL_SOURCE) as f:
        src = f.read()
    procs = {}
    for name, old, new in cuts:
        if src.count(old) != 1:
            raise RuntimeError(f"variant {name!r}: its anchor is not in {mk.KERNEL_SOURCE}")
        path = os.path.join(mk.BUILD_DIR, f"variant_{name}.cu")
        with open(path, "w") as f:
            f.write(src.replace(old, new))
        procs[name] = subprocess.Popen(
            [mk._nvcc(), *mk.NVCC_FLAGS, "-o", path[:-3] + ".so", path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {"whole": getattr(whole, entry)}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"variant {name!r} failed to build:\n{log}")
        fn = getattr(ctypes.CDLL(os.path.join(mk.BUILD_DIR, f"variant_{name}.so")), entry)
        fn.restype, fn.argtypes = ctypes.c_int, getattr(whole, entry).argtypes
        libs[name] = fn
    return libs


def _card() -> str:
    from approximated_personalized_pagerank_tpu_torch.utils.device import card_line

    return card_line()


def _events_ms(fn, reps: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def gather_stages(eat) -> None:
    """The ``gather`` mode (see the module doc): a JSON line a state for the
    stage cuts at its widest bucket, and one for the buckets' widths."""
    from approximated_personalized_pagerank_tpu_torch import grank_baskets, walk_baskets
    from approximated_personalized_pagerank_tpu_torch.ops.merge import DEFAULT_ELEM_BUDGET, _scales
    from approximated_personalized_pagerank_tpu_torch.utils.synthetic import powerlaw_graph

    libs = _variant_libs(GATHER_CUTS, "ppr_gather_merge_topl")
    damping = torch.tensor(DAMPING, device="cuda")
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

    def launcher(state, bucket, width, mode):
        """A function that launches one build on the bucket's first chunk,
        and its output tensors."""
        chunk = DEFAULT_ELEM_BUDGET // (2 * width)
        succ = torch.as_tensor(bucket.succ[:chunk], dtype=torch.int64, device="cuda")
        rows = torch.as_tensor(bucket.rows[:chunk], dtype=torch.int64, device="cuda")
        scale, self_sc, post = (x.contiguous() for x in
                                _scales((succ >= 0).sum(-1).float(), damping, mode))
        l_pad = 1 << (max(width, 128) - 1).bit_length()
        c, d = succ.shape
        out = (torch.empty((c, width), dtype=torch.int32, device="cuda"),
               torch.empty((c, width), dtype=torch.float32, device="cuda"))
        # the closure holds the tensors: a raw pointer alone would let the
        # allocator hand their memory to the next tensor
        tensors = (state.ids, state.scores, succ, rows, scale, self_sc, post, *out)

        def launch(fn):
            p = [ctypes.c_void_p(x.data_ptr()) for x in tensors]
            err = fn(p[0], p[1], state.ids.shape[0], width, p[2], d, p[3],
                     p[4], p[5], p[6], p[7], p[8], c, width, l_pad, None, stream)
            if err:
                raise RuntimeError(f"gather cut launch failed (CUDA error {err})")
        return launch, out, c, d

    big = powerlaw_graph(1_000_000, 10_000_000, seed=7, locality=0.8)
    states = (
        ("eat grank after 2 half-sweeps", eat,
         grank_baskets(eat, L, L, 2, DAMPING, 1e-4, engine="sparse"), 0, L, "grank"),
        ("eat mc walks", eat, walk_baskets(eat, MC_L, MC_R, DAMPING, seed=1), None, MC_L,
         "mc_combine"),
        ("1M grank after 2 half-sweeps", big,
         grank_baskets(big, L, L, 2, DAMPING, -1.0, engine="sparse"), 0, L, "grank"),
    )
    for label, graph, state, partition, width, mode in states:
        hub_sub = (8192 - 1) // width
        plan = graph.merge_plan(partition, L=width, net_width=8192)
        buckets = [b for b in plan.buckets if b.cap <= hub_sub and b.cap * width + 1 > 256]
        live = float((state.ids >= 0).float().mean())
        top = max(buckets, key=lambda b: (b.cap, b.rows.size))
        launch, _, c, d = launcher(state, top, width, mode)
        ms = {name: _events_ms(lambda fn=fn: launch(fn))
              for name, fn in libs.items() if name != "run_merge_from_512"}
        whole = ms["whole"]
        print(json.dumps({
            "cell": "gather_stages", "state": label, "D": d, "C": c, "Lb": width,
            "live_slot_share": live, "ms": ms,
            "share_run_sort": (whole - ms["no_run_sort"]) / whole,
            "share_merge": (whole - ms["no_merge"]) / whole,
            "share_steps_3_4": (whole - ms["steps_1_2"]) / whole,
            "share_step_4d": (whole - ms["no_step_4d"]) / whole,
        }), flush=True)
        rows = []
        for b in buckets:
            launch, out, c, d = launcher(state, b, width, mode)
            launch(libs["whole"])
            ref = [x.clone() for x in out]
            launch(libs["run_merge_from_512"])
            if not (torch.equal(out[0], ref[0]) and
                    torch.equal(out[1].view(torch.int32), ref[1].view(torch.int32))):
                raise RuntimeError(f"{label}: the run merge differs at cap {b.cap}")
            rows.append({"D": d, "C": c, "W": 1 << (d * width).bit_length(),
                         "ms": _events_ms(lambda: launch(libs["whole"])),
                         "run_merge_ms": _events_ms(lambda: launch(libs["run_merge_from_512"])),
                         "no_step_4d_ms": _events_ms(lambda: launch(libs["no_step_4d"]))})
        print(json.dumps({"cell": "gather_widths", "state": label, "live_slot_share": live,
                          "buckets": rows}), flush=True)
    print(json.dumps({"cell": "gather", "nvidia_smi": _card()}), flush=True)


# tiebranch: (W, l_pad, rows) of the matrix entry, and the live counts m
TIE_BRANCH_SHAPES = ((8192, 128, 517), (8192, 256, 512), (4096, 128, 1048),
                     (2048, 128, 1024), (1024, 128, 1024))
TIE_BRANCH_M = (64, 128, 256, 512, 768, 1024, 1536, 2047)


def tie_branch() -> None:
    """The ``tiebranch`` mode (see the module doc): a JSON line a shape,
    each m's time in the live form, the dense network, the kernel as built
    and with no step 4d (the outputs of the first three checked bitwise
    equal), and the kernel as built on untied rows of the shape."""
    from chip_smoke import live_count_rows, untied_rows
    from approximated_personalized_pagerank_tpu_torch.ops import merge_kernel as mk

    libs = _variant_libs(TIE_FORMS, "ppr_merge_topl")
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    rng = np.random.default_rng(0)

    def timed(fn, ids, sc, c, w, l_pad):
        """fn's time on the rows, and its output."""
        out = (torch.empty((c, l_pad), dtype=torch.int32, device="cuda"),
               torch.empty((c, l_pad), dtype=torch.float32, device="cuda"))
        tensors = (ids, sc, *out)

        def launch():
            p = [ctypes.c_void_p(x.data_ptr()) for x in tensors]
            err = fn(p[0], p[1], p[2], p[3], c, w, l_pad, None, stream)
            if err:
                raise RuntimeError(f"tiebranch launch failed (CUDA error {err})")
        return _events_ms(launch), out

    for w, l_pad, c in TIE_BRANCH_SHAPES:
        n = max(w, 256)
        lanes = n // (16 if n >= 4096 else 8)
        untied = [torch.as_tensor(x, device="cuda") for x in untied_rows(w, c, rng, mk.PAD_ID)]
        untied_ms = timed(libs["whole"], *untied, c, w, l_pad)[0]
        rows = []
        for m in (m for m in TIE_BRANCH_M if m <= 4 * lanes and m <= w):  # the live form's lanes
            ids, sc = (torch.as_tensor(x, device="cuda")
                       for x in live_count_rows(w, c, l_pad, m, rng, mk.PAD_ID))
            outs = {}
            ms = {}
            for name, fn in libs.items():
                ms[name], outs[name] = timed(fn, ids, sc, c, w, l_pad)
            for name in ("live", "whole"):
                if not (torch.equal(outs[name][0], outs["dense"][0]) and torch.equal(
                        outs[name][1].view(torch.int32), outs["dense"][1].view(torch.int32))):
                    raise RuntimeError(f"tiebranch ({w}, {l_pad}) m={m}: {name} differs")
            rows.append({"m": m, "live_ms": ms["live"], "dense_ms": ms["dense"],
                         "as_built_ms": ms["whole"], "no_step_4d_ms": ms["no_step_4d"]})
        print(json.dumps({"cell": "tiebranch", "W": w, "l_pad": l_pad, "C": c,
                          "lanes": lanes, "untied_ms": untied_ms, "by_m": rows}), flush=True)
    print(json.dumps({"cell": "tiebranch", "nvidia_smi": _card()}), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_port: no CUDA device", file=sys.stderr)
        return 1
    from approximated_personalized_pagerank_tpu_torch import (
        grank_baskets,
        load_eat_graph,
        make_mesh,
        mccompletepathv2_baskets,
        walk_baskets,
    )
    from approximated_personalized_pagerank_tpu_torch.ops.walk import _trace_chunks
    from approximated_personalized_pagerank_tpu_torch.utils.synthetic import powerlaw_graph

    modes = sys.argv[1:] or ["grank", "mc", "dense", "ring"]
    if set(modes) - {"grank", "mc", "dense", "ring", "gather", "tiebranch"}:
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
    if "gather" in modes:
        gather_stages(eat)
    if "tiebranch" in modes:
        tie_branch()
    if "ring" in modes:
        card = torch.device("cuda", 0)
        for d in (1, 4):
            mesh = make_mesh(d, [card] * d)
            profiled(f"eat_ring_d{d}",
                     lambda: grank_baskets(eat, K, L, 30, DAMPING, 1e-4, mesh=mesh),
                     30, "half_sweep")
    return 0


if __name__ == "__main__":
    sys.exit(main())
