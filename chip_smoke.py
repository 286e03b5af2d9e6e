#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the fused merge kernel from the repository's sources and holds both
of its entries (the matrix entry ``fused_merge_topl`` and the gather entry
``gather_merge_topl``) against their plain PyTorch versions on the card,
checks that their output is bitwise deterministic and free of the order of
a row's candidates, and times them.  Then it drives the port's main paths,
counting each entry's launches in each:

* phase 2: sparse GRank on the bundled Eat graph, scored against the exact
  oracle;
* phase 3: two GRank half-sweeps on a 1M-node power-law graph that takes
  the hub path;
* phase 4: MCCompletePathV2 on Eat (K=50, L=200, R=1000), scored against
  the oracle beside the sort pipeline, with the walks' checks (one chunk's
  trace bitwise equal on the card and the CPU, threefry bits equal on
  both, trace and counts engines equal, two runs of one seed equal) and
  the kernel entries held and timed at the MC path's own shapes;
* phase 5: the walks alone (R=200) on the phase 3 graph;
* phase 6: the dense engine: (a) GRank on Eat, timed, its FLOP rate and
  quality; (b) dense (float32, exact truncation) against sparse on Eat,
  with a bfloat16 control that must fail its bounds; (c) MC on Eat through
  ``engine="auto"``, which is dense, then its walks and its combine run
  apart, timed, and bitwise equal to the call; (d) dense and sparse GRank
  at the auto cutoff, 16,384 nodes; (e) the CLI on the sample graph,
  saved and held bitwise against a direct call.

Phases 2-4 name ``engine="sparse"``.  Each phase (each part of phase 6)
prints one JSON line; any failure exits non-zero.  The last line
is ``{"ok": true, "device": {...}}``.  Exits non-zero, printing no result,
when no CUDA device is present.
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
# (W, l_pad) at the ends of the contract: a row below the kernel's sort width,
# l_pad below a warp, and l_pad above 256 (the block-wide final sort)
EDGE_CASES = ((2, 2), (64, 8), (512, 512), (8192, 1024), (8192, 8192))
ROWS_PER_CASE = 320
# Eat's widest merge chunks at L=100 and the default element budget
# (1<<22 candidates): C rows of width W.  The gather entry takes them as
# D = (W - 1) // L successors a row.
EAT_SHAPES = ((8192, 517), (4096, 1048))
# Eat's widest buckets (partition 0): C rows of D successors, one gather
# launch each on the main path.
EAT_BUCKETS = ((81, 2213), (40, 2063))
EAT_NODES = 23132
# The hub group level at L=100: groups of 81 successors, top 200 of l_pad 256,
# no self entry.
HUB_GROUP = (81, 1024, 200, 256)
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, and 32-bit operations/s
# outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
KERNEL_SOURCE = "approximated_personalized_pagerank_tpu_torch/csrc/merge_topl.cu"
REPLACES = "approximated_personalized_pagerank_tpu/ops/pallas/merge_kernel.py:91"
ATOL = 1e-6
EAT_REPEATS = 5
# MCCompletePathV2 as the reference driver runs it (src/main.cc:64): K, L, R;
# a warm-up call with seed 0, then timed calls with seed 1 (bench.py).
MC_K, MC_L, MC_R = 50, 200, 1000
MC_REPEATS = 3
MC_UNROLL = 32  # hops per macro step of the walks (ops/walk.py default)
# the walks at 1M nodes (bench.py's scale run): L, R
WALK_L, WALK_R = 100, 200
# phase 6, the dense engine: timed calls per measurement; the auto cutoff's
# graph (16,384 nodes at Eat's 13.5 edges a node); H100 SXM dense bf16 peak
DENSE_REPEATS = 3
CUTOFF_NODES, CUTOFF_EDGES = 16_384, 221_184
BF16_OPS_PER_S = 989e12
# phase 6b's bounds on the scores of ids both engines keep: the largest
# difference, and the least share within 1e-5 (see engines_agree)
SHARED_ATOL, SHARED_CLOSE, SHARED_CLOSE_SHARE = 5e-4, 1e-5, 0.99


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


def bound_ms(nbytes: int, ops: float) -> tuple:
    """Least time on an H100 for work that must move ``nbytes`` bytes and do
    ``ops`` 32-bit operations: the larger of the two times at peak rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sort_ops(live: torch.Tensor) -> float:
    """The fewest comparisons that order rows of ``live`` keys each,
    log2(live!) a row, at one 32-bit operation each."""
    return float((torch.lgamma(live.double() + 1) / math.log(2)).sum())


def matrix_work(ids: torch.Tensor, l_pad: int, pad_id: int,
                width: int | None = None) -> tuple:
    """(bytes, operations) of the matrix entry on these inputs: the [C, W]
    matrix read once and [C, l_pad] written once; a sort of each row's live
    candidates.  ``width``: the rows' width before ``pad_candidates``
    padded them to a power of two; only those columns are read."""
    c, w = ids.shape
    w = w if width is None else width
    return c * w * 8 + c * l_pad * 8, sort_ops((ids != pad_id).sum(dim=1))


def gather_work(basket_ids: torch.Tensor, succ: torch.Tensor, out_l: int,
                self_entry: bool = True) -> tuple:
    """(bytes, operations) of the gather entry on these inputs: the
    successor matrix and the per-row vectors (with a self entry: rows
    int64, scale, self score, post-scale f32; without: scale) read once,
    the basket row of each distinct valid successor read once, [C, out_l]
    written once; a sort of each row's live candidates (live basket slots
    of valid successors, and the self entry)."""
    c, d = succ.shape
    lb = basket_ids.shape[1]
    valid = succ >= 0
    distinct = int(torch.unique(succ[valid]).numel())
    live = ((basket_ids[succ.clamp(min=0)] >= 0) & valid[..., None]).sum(dim=(1, 2))
    per_row = 20 if self_entry else 4
    nbytes = c * d * 8 + c * per_row + distinct * lb * 8 + c * out_l * 8
    return nbytes, sort_ops(live + int(self_entry))


def gather_inputs(rng: np.random.Generator, c: int, d: int, dev):
    """Baskets [EAT_NODES, L] like GRank's (a tenth of the slots dead, rows
    of at most unit mass), and c rows of ragged degree in (d/2, d]."""
    ids = rng.integers(0, EAT_NODES, (EAT_NODES, L)).astype(np.int32)
    ids[rng.random((EAT_NODES, L)) < 0.1] = -1
    sc = np.where(ids >= 0, rng.random((EAT_NODES, L)) / L, 0).astype(np.float32)
    succ = rng.integers(0, EAT_NODES, (c, d)).astype(np.int64)
    deg = rng.integers(d // 2 + 1, d + 1, c)
    succ[np.arange(d)[None, :] >= deg[:, None]] = -1
    rows = rng.choice(EAT_NODES, c, replace=False).astype(np.int64)
    return [torch.as_tensor(x, device=dev) for x in (ids, sc, succ, rows)]


def grank_scales(succ: torch.Tensor):
    from approximated_personalized_pagerank_tpu_torch.ops.merge import _scales

    deg = (succ >= 0).sum(dim=-1).to(torch.float32)
    return _scales(deg, torch.tensor(DAMPING, device=succ.device), "grank")


def same_bits(a, b) -> bool:
    return bool(torch.equal(a[0], b[0])) and bool(
        torch.equal(a[1].view(torch.int32), b[1].view(torch.int32)))


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
    """Phase 1: both entries against their plain versions, at every
    (W, l_pad) for the matrix entry and at Eat's widest buckets and a hub
    group shape for the gather entry; the determinism and order checks; and
    both entries timed at Eat's widest shapes."""
    from approximated_personalized_pagerank_tpu_torch.ops import merge_kernel as mk
    from approximated_personalized_pagerank_tpu_torch.utils.compare import (
        topl_max_error,
    )

    kernel, plain = mk.fused_merge_topl, mk.merge_topl_plain
    gather, gather_plain = mk.gather_merge_topl, mk.gather_merge_topl_plain
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)

    def err_of(k, p):
        torch.cuda.synchronize()
        return topl_max_error(k[0].cpu().numpy(), k[1].cpu().numpy(),
                              p[0].cpu().numpy(), p[1].cpu().numpy(), ATOL)

    max_err = 0.0
    cases = []
    for w in WIDTHS:
        ids_np, sc_np = kernel_cases(w, ROWS_PER_CASE, rng, mk.PAD_ID)
        ids = torch.as_tensor(ids_np, device=dev)
        sc = torch.as_tensor(sc_np, device=dev)
        for l_pad in L_PADS:
            err = err_of(kernel(ids, sc, l_pad), plain(ids, sc, l_pad))
            max_err = max(max_err, err)
            cases.append({"W": w, "l_pad": l_pad, "rows": ROWS_PER_CASE,
                          "max_abs_err": err})
    for w, l_pad in EDGE_CASES:
        ids_np = rng.integers(0, max(2, w // 4), (ROWS_PER_CASE, w)).astype(np.int32)
        ids_np[rng.random((ROWS_PER_CASE, w)) < 0.2] = mk.PAD_ID
        ids = torch.as_tensor(ids_np, device=dev)
        sc = torch.as_tensor(rng.random((ROWS_PER_CASE, w)).astype(np.float32) / w,
                             device=dev)
        err = err_of(kernel(ids, sc, l_pad), plain(ids, sc, l_pad))
        max_err = max(max_err, err)
        cases.append({"W": w, "l_pad": l_pad, "rows": ROWS_PER_CASE,
                      "max_abs_err": err})

    # the gather entry: Eat's widest buckets (self entry, l_pad 128), a hub
    # group shape (no self entry, l_pad 256) and a row with l_pad 512
    g_err = 0.0
    g_cases = []
    for d, c, out_l, l_pad, self_entry in (
        [(d, c, L, 128, True) for d, c in EAT_BUCKETS]
        + [HUB_GROUP + (False,), (20, 256, 400, 512, True)]  # and l_pad > 256
    ):
        b_ids, b_sc, succ, rows = gather_inputs(rng, c, d, dev)
        scale, self_sc, post = grank_scales(succ)
        if not self_entry:
            self_sc, post = None, None
        args = (b_ids, b_sc, succ, rows, scale, self_sc, post, out_l, l_pad)
        err = err_of(gather(*args), gather_plain(*args))
        g_err = max(g_err, err)
        g_cases.append({"D": d, "C": c, "L": out_l, "l_pad": l_pad,
                        "self_entry": self_entry, "max_abs_err": err})

    # bitwise: two launches of one input; a row's candidates in another order
    ids_np, sc_np = kernel_cases(8192, ROWS_PER_CASE, rng, mk.PAD_ID)
    perm = rng.permutation(8192)
    ids, sc = torch.as_tensor(ids_np, device=dev), torch.as_tensor(sc_np, device=dev)
    first = kernel(ids, sc, 128)
    check(same_bits(kernel(ids, sc, 128), first), "matrix entry: two launches differ")
    check(same_bits(kernel(ids[:, perm], sc[:, perm], 128), first),
          "matrix entry: permuted columns change the output")
    d, c = EAT_BUCKETS[0]
    b_ids, b_sc, succ, rows = gather_inputs(rng, c, d, dev)
    scale, self_sc, post = grank_scales(succ)
    first = gather(b_ids, b_sc, succ, rows, scale, self_sc, post, L, 128)
    again = gather(b_ids, b_sc, succ, rows, scale, self_sc, post, L, 128)
    succ_perm = succ[:, torch.as_tensor(rng.permutation(d), device=dev)]
    permuted = gather(b_ids, b_sc, succ_perm, rows, scale, self_sc, post, L, 128)
    check(same_bits(again, first), "gather entry: two launches differ")
    check(same_bits(permuted, first), "gather entry: permuted successors change the output")

    timings = []
    for w, c in EAT_SHAPES:
        ids_np = rng.integers(0, EAT_NODES, (c, w)).astype(np.int32)
        ids_np[rng.random((c, w)) < 0.15] = mk.PAD_ID
        ids = torch.as_tensor(ids_np, device=dev)
        sc = torch.as_tensor(rng.random((c, w)).astype(np.float32) / w, device=dev)
        work = matrix_work(ids, 128, mk.PAD_ID)
        b_ms, b_by = bound_ms(*work)
        timings.append({"entry": "matrix", "W": w, "C": c, "l_pad": 128,
                        "ms": time_ms(lambda: kernel(ids, sc, 128), 20),
                        "plain_ms": time_ms(lambda: plain(ids, sc, 128), 5),
                        "bound_ms": b_ms, "bound_by": b_by,
                        "bound_bytes": work[0], "bound_ops": work[1]})
    for d, c in [((w - 1) // L, c) for w, c in EAT_SHAPES] + list(EAT_BUCKETS):
        b_ids, b_sc, succ, rows = gather_inputs(rng, c, d, dev)
        scale, self_sc, post = grank_scales(succ)
        args = (b_ids, b_sc, succ, rows, scale, self_sc, post, L, 128)
        w = mk.next_pow2(d * L + 1)
        work = gather_work(b_ids, succ, L)
        b_ms, b_by = bound_ms(*work)
        # the matrix entry on the same rows' candidates
        cand = mk.gather_successors(b_ids, b_sc, succ)
        cand_ids = torch.cat([cand[0], rows[:, None].to(torch.int32)], dim=-1)
        cand_sc = torch.cat([cand[1] * scale[:, None], self_sc[:, None]], dim=-1)
        m_ids, m_sc = mk.pad_candidates(cand_ids, cand_sc, 128)
        timings.append({"entry": "gather", "W": w, "D": d, "C": c, "l_pad": 128,
                        "ms": time_ms(lambda: gather(*args), 20),
                        "matrix_same_rows_ms": time_ms(lambda: kernel(m_ids, m_sc, 128), 20),
                        "plain_ms": time_ms(lambda: gather_plain(*args), 5),
                        "bound_ms": b_ms, "bound_by": b_by,
                        "bound_bytes": work[0], "bound_ops": work[1]})
    emit({"phase": 1, "atol": ATOL, "max_abs_err": max_err,
          "gather_max_abs_err": g_err, "bitwise_checks": "passed",
          "cases": cases, "gather_cases": g_cases, "timings": timings})
    return max_err, g_err, timings


def launch_counts():
    """The two entries' launch counters, by (W, l_pad)."""
    from approximated_personalized_pagerank_tpu_torch.ops import merge_kernel as mk

    return {"fused_merge_topl": mk.fused_merge_topl.launches,
            "gather_merge_topl": mk.gather_merge_topl.launches}


def clear_counts() -> None:
    for counter in launch_counts().values():
        counter.clear()


def read_counts() -> dict:
    return {name: dict(c) for name, c in launch_counts().items()}


def launches_json(counts: dict) -> dict:
    return {name: {f"{w}x{lp}": v for (w, lp), v in sorted(c.items())}
            for name, c in counts.items()}


def phase_eat() -> dict:
    """Phase 2: the headline, GRank on Eat through the kernel, against the
    sort pipeline and the exact oracle.  ``wall_s`` is the median of
    EAT_REPEATS timed calls; the launch counts are the first call's.
    Returns the main path's launches of each entry."""
    from approximated_personalized_pagerank_tpu_torch import (
        benchmark_sampled,
        grank_baskets,
        load_eat_graph,
        sample_result,
    )
    from approximated_personalized_pagerank_tpu_torch.ops.basket import jaccard_rows

    graph = load_eat_graph()
    grank_baskets(graph, K, L, 2, DAMPING, TOL, engine="sparse", return_info=True)
    torch.cuda.synchronize()
    clear_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    baskets, info = grank_baskets(graph, K, L, ITERS, DAMPING, TOL, engine="sparse",
                                  return_info=True)
    torch.cuda.synchronize()
    walls = [time.perf_counter() - t0]
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    check(sum(launches["gather_merge_topl"].values()) > 0,
          "the Eat run launched no gather merge kernel")
    check(tuple(baskets.ids.shape) == (graph.num_nodes, K), "Eat baskets have the wrong shape")
    check(bool(torch.isfinite(baskets.scores).all()), "non-finite Eat scores")
    iters = info["iterations_ran"]
    for _ in range(EAT_REPEATS - 1):  # the run-to-run spread of the wall time
        t0 = time.perf_counter()
        grank_baskets(graph, K, L, ITERS, DAMPING, TOL, engine="sparse")
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall = float(np.median(walls))

    t0 = time.perf_counter()
    sorted_b, sort_info = grank_baskets(
        graph, K, L, ITERS, DAMPING, TOL, merge_algo="sort", engine="sparse",
        return_info=True,
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
          "kernel_launches": launches_json(launches),
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
    return launches


def phase_scale() -> tuple:
    """Phase 3: two half-sweeps at 1M nodes, through the hub path.  Returns
    the launches of each entry, and the graph."""
    from approximated_personalized_pagerank_tpu_torch import grank_baskets
    from approximated_personalized_pagerank_tpu_torch.ops.merge_kernel import (
        MAX_KERNEL_WIDTH,
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
    clear_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out, info = grank_baskets(big, K, L, 2, DAMPING, -1.0, engine="sparse",
                              return_info=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    # the hub group level, through the gather entry at l_pad 256
    wide = sum(v for (w, lp), v in launches["gather_merge_topl"].items() if lp == 256)
    rows = torch.as_tensor(
        np.random.default_rng(1).choice(big.num_nodes, 4096, replace=False),
        device="cuda",
    )
    ids = out.ids[rows].cpu().numpy()
    sc = out.scores[rows].cpu().numpy()
    emit({"phase": 3, "graph": "powerlaw(1e6, 1e7, seed=7, locality=0.8)",
          "setup_s": setup_s, "wall_s": wall,
          "iterations_ran": info["iterations_ran"], "peak_bytes": peak,
          "hub_rows": int(hub_rows), "hub_group_gather_launches": wide,
          "kernel_launches": launches_json(launches),
          "basket_merges_per_s": measured_merges(big, 2) / wall})
    check(wide > 0, "no hub group (gather, l_pad=256) launches at 1M nodes")
    check(sum(launches["fused_merge_topl"].values()) > 0,
          "no matrix-entry (hub tree-reduce) launches at 1M nodes")
    check(np.isfinite(sc).all(), "non-finite scores at 1M nodes")
    for r in range(ids.shape[0]):
        live = ids[r] >= 0
        s = sc[r][live]
        check(np.all(np.diff(s) <= 0), f"1M row {r}: not descending")
        check(np.unique(ids[r][live]).size == live.sum(), f"1M row {r}: repeated ids")
        check(s.sum() <= 1 + 1e-4, f"1M row {r}: row sum {s.sum()} > 1")
    return launches, big


def mc_walk_checks(graph) -> dict:
    """Phase 4's checks of the walks on Eat's first source chunk: threefry
    bits, the trace on the card against the CPU, and the trace against the
    counts engine."""
    from approximated_personalized_pagerank_tpu_torch.ops import walk as tw
    from approximated_personalized_pagerank_tpu_torch.utils import prng

    n = graph.num_nodes
    chunk, row_chunk, slots, total, macro, width = tw._trace_chunks(
        n, MC_R, DAMPING, None, None, MC_UNROLL)
    key = prng.fold_in(prng.prng_key(1), 0)  # the timed runs' first chunk
    draws = {dev: prng.uniform_many(prng.split(prng.fold_in(key, 0)),
                                    (MC_UNROLL, chunk, slots), dev).cpu()
             for dev in ("cpu", "cuda")}
    check(torch.equal(draws["cpu"].view(torch.int32), draws["cuda"].view(torch.int32)),
          "threefry bits differ between the CPU and the card")
    out = {}
    for dev in ("cpu", "cuda"):
        dg = graph.device_graph(dev)
        srcs, _ = tw._chunk_sources(0, n, chunk, dev)
        damping_t = torch.tensor(DAMPING, dtype=torch.float32, device=dev)
        t0 = time.perf_counter()
        out[dev] = tw.walk_trace_chunk(dg.start_deg, dg.indices, srcs, key,
                                       damping_t, total, slots, macro, MC_UNROLL)
        if dev == "cuda":
            torch.cuda.synchronize()
        out[dev + "_s"] = time.perf_counter() - t0
    trace, abandoned = out["cuda"]
    check(torch.equal(trace.cpu(), out["cpu"][0]) and torch.equal(abandoned.cpu(), out["cpu"][1]),
          "chunk 0's trace on the card differs from the CPU's")
    # the counts engine on the same chunk against the trace's histogram
    dg = graph.device_graph("cuda")
    srcs, _ = tw._chunk_sources(0, n, chunk, "cuda")
    r_t = torch.tensor(float(MC_R), device="cuda")
    counts, c_abandoned = tw.walk_counts_chunk(
        dg.start_deg, dg.indices, srcs, key, torch.tensor(DAMPING, device="cuda"),
        r_t, total, n, slots, macro, MC_UNROLL)
    hist = torch.zeros((chunk, n + 1), dtype=torch.float32, device="cuda")
    hist.scatter_add_(1, torch.where(trace >= 0, trace, n).long(),
                      torch.ones(trace.shape, device="cuda"))
    hist[torch.arange(chunk, device="cuda"), srcs] += r_t
    hist = hist[:, :n] / r_t
    check(torch.equal(hist.view(torch.int32), counts.view(torch.int32))
          and torch.equal(c_abandoned, abandoned),
          "trace and counts engines differ on chunk 0")
    return {"chunk": chunk, "row_chunk": row_chunk, "slots": slots,
            "macro_steps": macro, "trace_width": width,
            "chunk0_visits": int((trace >= 0).sum()),
            "chunk0_macro_steps_run": int((trace >= 0).any(dim=0).nonzero().max())
            // (MC_UNROLL * slots) + 1,
            "chunk0_cpu_s": out["cpu_s"], "chunk0_cuda_s": out["cuda_s"],
            "trace": trace, "sources": srcs}


def mc_kernel_shapes(graph, walk, trace, sources) -> tuple:
    """Both entries held against their plain versions and timed at the MC
    path's own inputs on Eat: the trace top-L of chunk 0 (matrix entry,
    W=8192, l_pad 256); the first combine pass's widest bucket below the
    hub path (gather entry, cap hub_sub, one launch, a self entry and
    mc_combine's scales, l_pad 256); and its hub rows: the group level
    (gather entry, groups of hub_sub successors, top 2L of l_pad 512, no
    self entry) and the final merge (matrix entry, W=1024, l_pad 256), in
    the row chunks ``merge_bucket`` gives them.  Matrix-entry bounds count
    the rows' width before their padding to a power of two."""
    from approximated_personalized_pagerank_tpu_torch.ops import merge as tm
    from approximated_personalized_pagerank_tpu_torch.ops import merge_kernel as mk
    from approximated_personalized_pagerank_tpu_torch.utils.compare import topl_max_error

    def err_of(k, p):
        """(max abs score error, its tolerance): ATOL times the largest
        score, since MC's scores are visit counts over R (and self entries
        up to deg/damping), and a run summed in another order moves by
        ulps of values far above 1."""
        torch.cuda.synchronize()
        atol = ATOL * max(1.0, float(p[1].abs().max()))
        return topl_max_error(k[0].cpu().numpy(), k[1].cpu().numpy(),
                              p[0].cpu().numpy(), p[1].cpu().numpy(), atol), atol

    rows = []
    l_pad = tm._l_pad(MC_L)
    ids = torch.cat([trace, sources[:, None].to(torch.int32)], dim=1)
    sc = torch.cat([(trace >= 0).to(torch.float32),
                    torch.full((trace.shape[0], 1), float(MC_R), device="cuda")], dim=1)
    m_ids, m_sc = mk.pad_candidates(ids, sc, l_pad)
    work = matrix_work(m_ids, l_pad, mk.PAD_ID, width=ids.shape[1])
    rows.append(("matrix", "trace top-L", m_ids.shape[1], m_ids.shape[0], None, l_pad,
                 err_of(mk.fused_merge_topl(m_ids, m_sc, l_pad),
                        mk.merge_topl_plain(m_ids, m_sc, l_pad)),
                 time_ms(lambda: mk.fused_merge_topl(m_ids, m_sc, l_pad), 20),
                 time_ms(lambda: mk.merge_topl_plain(m_ids, m_sc, l_pad), 5), work))

    damping_t = torch.tensor(DAMPING, device="cuda")
    hub_sub = (mk.MAX_KERNEL_WIDTH - 1) // MC_L
    plan = graph.merge_plan(None, L=MC_L, net_width=mk.MAX_KERNEL_WIDTH)
    top = max((b for b in plan.buckets if b.cap <= hub_sub),
              key=lambda b: (b.cap, b.rows.size))
    check(top.rows.size <= tm.DEFAULT_ELEM_BUDGET // (2 * MC_L),
          "the widest combine bucket takes more than one gather launch")
    b_succ = torch.as_tensor(top.succ, dtype=torch.int64, device="cuda")
    b_rows = torch.as_tensor(top.rows, dtype=torch.int64, device="cuda")
    scale, self_sc, post = tm._scales((b_succ >= 0).sum(dim=-1).to(torch.float32),
                                      damping_t, "mc_combine")
    b_args = (walk.ids, walk.scores, b_succ, b_rows, scale, self_sc, post, MC_L, l_pad)
    work = gather_work(walk.ids, b_succ, MC_L)
    rows.append(("gather", f"combine bucket (cap {top.cap})",
                 mk.next_pow2(1 + top.cap * MC_L), top.rows.size, top.cap, l_pad,
                 err_of(mk.gather_merge_topl(*b_args), mk.gather_merge_topl_plain(*b_args)),
                 time_ms(lambda: mk.gather_merge_topl(*b_args), 20),
                 time_ms(lambda: mk.gather_merge_topl_plain(*b_args), 5), work))

    hub = max((b for b in plan.buckets if b.cap > hub_sub), key=lambda b: b.rows.size)
    chunk = tm.DEFAULT_ELEM_BUDGET // (1 + hub.cap * MC_L)  # merge_bucket's chunk
    succ = torch.as_tensor(hub.succ[:chunk], dtype=torch.int64, device="cuda")
    hub_rows = torch.as_tensor(hub.rows[:chunk], dtype=torch.int64, device="cuda")
    c, g = succ.shape[0], hub.cap // hub_sub
    group_succ = succ.reshape(c * g, hub_sub)
    m = tm.HUB_TOP_M_FACTOR * MC_L
    scale = torch.ones(c * g, device="cuda")
    g_args = (walk.ids, walk.scores, group_succ, None, scale, None, None, m, tm._l_pad(m))
    part = mk.gather_merge_topl(*g_args)
    work = gather_work(walk.ids, group_succ, m, self_entry=False)
    rows.append(("gather", "hub group level", mk.next_pow2(hub_sub * MC_L), c * g, hub_sub,
                 tm._l_pad(m), err_of(part, mk.gather_merge_topl_plain(*g_args)),
                 time_ms(lambda: mk.gather_merge_topl(*g_args), 20),
                 time_ms(lambda: mk.gather_merge_topl_plain(*g_args), 5), work))

    deg = (succ >= 0).sum(dim=-1).to(torch.float32)
    _, self_sc, _ = tm._scales(deg, damping_t, "mc_combine")
    f_ids = torch.cat([part.ids.reshape(c, g * m), hub_rows[:, None].to(torch.int32)], dim=1)
    f_sc = torch.cat([part.scores.reshape(c, g * m), self_sc[:, None]], dim=1)
    live_w = f_ids.shape[1]
    f_ids, f_sc = mk.pad_candidates(f_ids, f_sc, l_pad)
    work = matrix_work(f_ids, l_pad, mk.PAD_ID, width=live_w)
    rows.append(("matrix", "hub final merge", f_ids.shape[1], c, None, l_pad,
                 err_of(mk.fused_merge_topl(f_ids, f_sc, l_pad),
                        mk.merge_topl_plain(f_ids, f_sc, l_pad)),
                 time_ms(lambda: mk.fused_merge_topl(f_ids, f_sc, l_pad), 20),
                 time_ms(lambda: mk.merge_topl_plain(f_ids, f_sc, l_pad), 5), work))
    timings = []
    for entry, where, w, c_, d, lp, (err, atol), ms, plain_ms, work in rows:
        b_ms, b_by = bound_ms(*work)
        timings.append({"entry": entry, "use": where, "W": w, "C": c_, "D": d,
                        "l_pad": lp, "max_abs_err": err, "atol": atol, "ms": ms,
                        "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                        "bound_bytes": work[0], "bound_ops": work[1]})
    return timings


def phase_mc() -> dict:
    """Phase 4: MCCompletePathV2 on Eat as the reference driver runs it,
    through the kernel, against the sort pipeline and the exact oracle.
    ``wall_s`` is the median of MC_REPEATS timed calls after a warm-up call;
    the launch counts are the first timed call's.  Returns the main path's
    launches of each entry, and the largest kernel-vs-plain errors."""
    from approximated_personalized_pagerank_tpu_torch import (
        benchmark_sampled,
        load_eat_graph,
        mccompletepathv2_baskets,
        sample_result,
        walk_baskets,
    )

    graph = load_eat_graph()
    args = (graph, MC_K, MC_L, MC_R, DAMPING)
    # the sparse engine: auto takes the dense one on Eat (phase 6)
    mccompletepathv2_baskets(*args, seed=0, engine="sparse")
    torch.cuda.synchronize()
    clear_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    baskets, info = mccompletepathv2_baskets(*args, seed=1, engine="sparse",
                                             return_info=True)
    torch.cuda.synchronize()
    walls = [time.perf_counter() - t0]
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    check(launches["fused_merge_topl"].get((8192, 256), 0) > 0,
          "the Eat MC run launched no matrix entry at W=8192, l_pad=256")
    check(any(lp == 512 for _, lp in launches["gather_merge_topl"]),
          "the Eat MC run launched no gather entry at l_pad=512")
    check(tuple(baskets.ids.shape) == (graph.num_nodes, MC_K), "MC baskets have the wrong shape")
    check(bool(torch.isfinite(baskets.scores).all()), "non-finite MC scores")
    for _ in range(MC_REPEATS - 1):
        t0 = time.perf_counter()
        again = mccompletepathv2_baskets(*args, seed=1, engine="sparse")
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        check(same_bits(again, baskets), "two MC runs with seed 1 differ")
    wall = float(np.median(walls))

    # the walks alone (trace top-L included), the first combine's input;
    # the walk rate is over their wall, as in phase 5
    walk_walls = []
    for _ in range(MC_REPEATS):
        t0 = time.perf_counter()
        walk, walk_info = walk_baskets(graph, MC_L, MC_R, DAMPING, seed=1, return_info=True)
        torch.cuda.synchronize()
        walk_walls.append(time.perf_counter() - t0)
    walk_wall = float(np.median(walk_walls))
    check(walk_info["walk_steps"] == info["walk_steps"],
          "the walks alone and MC's walks took different steps")
    t0 = time.perf_counter()
    sorted_b = mccompletepathv2_baskets(*args, seed=1, merge_algo="sort", engine="sparse")
    torch.cuda.synchronize()
    sort_wall = time.perf_counter() - t0
    samples = [sample_result(b, graph, 200, True, seed=0) for b in (baskets, sorted_b)]
    stats, sort_stats = benchmark_sampled(samples, graph)
    walks = mc_walk_checks(graph)
    timings = mc_kernel_shapes(graph, walk, walks.pop("trace"), walks.pop("sources"))
    emit({"phase": 4, "graph": "eat", "algorithm": "mccompletepathv2",
          "K": MC_K, "L": MC_L, "R": MC_R, "wall_s": wall, "walls_s": walls,
          "walk_wall_s": walk_wall, "walk_walls_s": walk_walls,
          "walk_steps": info["walk_steps"],
          "walk_steps_per_s": info["walk_steps"] / walk_wall,
          "abandoned_walks": info["abandoned_walks"], "total_walks": info["total_walks"],
          "abandoned_share": info["abandoned_walks"] / info["total_walks"],
          "kernel_launches": launches_json(launches), "peak_bytes": peak,
          "sort_wall_s": sort_wall,
          "jaccard_average": stats["jaccard average"],
          "jaccard_min": stats["jaccard min"],
          "recall_average": stats["recall average"],
          "kendall_average": stats["kendall average"],
          "sort_jaccard_average": sort_stats["jaccard average"],
          "sort_recall_average": sort_stats["recall average"],
          "sort_kendall_average": sort_stats["kendall average"],
          "walk_checks": "passed", **walks, "timings": timings})
    check(stats["jaccard average"] >= 0.94, "Eat MC jaccard_average < 0.94")
    check(abs(stats["jaccard average"] - sort_stats["jaccard average"]) <= 0.01,
          "kernel and sort pipelines' MC jaccard differ by more than 0.01")
    errs = {"fused_merge_topl": max(t["max_abs_err"] for t in timings if t["entry"] == "matrix"),
            "gather_merge_topl": max(t["max_abs_err"] for t in timings if t["entry"] == "gather")}
    return launches, errs


def phase_walk_scale(big) -> dict:
    """Phase 5: the walks alone on the phase 3 graph (bench.py's scale run:
    L=100, R=200, seed 0, after a warm-up of one source chunk).  Returns
    the launches of each entry."""
    from approximated_personalized_pagerank_tpu_torch import walk_baskets
    from approximated_personalized_pagerank_tpu_torch.ops.walk import walk_trace_basket_chunks

    t0 = time.perf_counter()
    next(iter(walk_trace_basket_chunks(big, WALK_L, WALK_R, DAMPING, seed=0)))
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    clear_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    wb, info = walk_baskets(big, WALK_L, WALK_R, DAMPING, seed=0, return_info=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    emit({"phase": 5, "graph": "powerlaw(1e6, 1e7, seed=7, locality=0.8)",
          "L": WALK_L, "R": WALK_R, "warmup_chunk_s": warm, "wall_s": wall,
          "walk_steps": info["walk_steps"], "walk_steps_per_s": info["walk_steps"] / wall,
          "abandoned_walks": info["abandoned_walks"], "total_walks": info["total_walks"],
          "peak_bytes": peak, "kernel_launches": launches_json(launches)})
    check(tuple(wb.ids.shape) == (big.num_nodes, WALK_L), "1M walk baskets have the wrong shape")
    check(bool(torch.isfinite(wb.scores).all()), "non-finite 1M walk scores")
    check(info["walk_steps"] > 0, "no walk steps at 1M nodes")
    check(info["abandoned_walks"] <= 0.01 * info["total_walks"], "over 1% of 1M walks abandoned")
    return launches


def emit_dense(part: str, smi: str, obj: dict) -> None:
    emit({"phase": 6, "part": part, "nvidia_smi": smi, **obj})


def timed(fn):
    """(result, seconds) of one call, ended by a synchronize."""
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def quality(baskets, graph) -> dict:
    """jaccard / recall / kendall averages against the exact oracle (200
    strict sources, seed 0)."""
    from approximated_personalized_pagerank_tpu_torch import benchmark_sampled, sample_result

    (stats,) = benchmark_sampled([sample_result(baskets, graph, 200, True, seed=0)], graph)
    return {"jaccard_average": stats["jaccard average"], "jaccard_min": stats["jaccard min"],
            "recall_average": stats["recall average"],
            "kendall_average": stats["kendall average"]}


def dense_grank_eat(graph, smi: str) -> dict:
    """Phase 6a: dense GRank on Eat (bench.py::bench_dense_eat): a warm-up
    of 2 half-sweeps, then the median of DENSE_REPEATS calls; the product
    and the rest of one partition-0 half-sweep timed alone.  Returns the
    launches of each merge entry (none: no kernel is on this path)."""
    from approximated_personalized_pagerank_tpu_torch import grank_baskets
    from approximated_personalized_pagerank_tpu_torch.ops import dense as td

    run = lambda it: grank_baskets(graph, K, L, it, DAMPING, TOL, engine="dense",  # noqa: E731
                                   return_info=True)
    _, warm_s = timed(lambda: run(2))
    clear_counts()
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for _ in range(DENSE_REPEATS):
        (baskets, info), s = timed(lambda: run(ITERS))
        walls.append(s)
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    wall = float(np.median(walls))
    check(tuple(baskets.ids.shape) == (graph.num_nodes, K), "dense Eat baskets have the wrong shape")
    check(bool(torch.isfinite(baskets.scores).all()), "non-finite dense Eat scores")
    # one partition-0 half-sweep, split: the product, then the rest
    plan = td.build_dense_plan(graph, DAMPING)
    A0, _, S = td._dense_init(plan, DAMPING, L, torch.bfloat16, False, "cuda")
    mm_ms = time_ms(lambda: td._mm_f32(A0, S), 5)
    half_ms = time_ms(lambda: td._dense_half(A0, S, 0, td._self_score(DAMPING, "cuda"), L,
                                             False, True), 5)
    del A0, S
    flops = info["flops"]
    q = quality(baskets, graph)
    emit_dense("a: dense GRank on Eat", smi, {
        "K": K, "L": L, "half_sweeps": ITERS, "tol": TOL, "matmul_dtype": "bfloat16",
        "n_pad": plan.n_pad, "n0": plan.n0, "n1": plan.n1,
        "warmup_2_half_sweeps_s": warm_s, "wall_s": wall, "walls_s": walls,
        "iterations_ran": info["iterations_ran"], "flops": flops,
        "tflops_per_s": flops / wall / 1e12, "bf16_peak_share": flops / wall / BF16_OPS_PER_S,
        "half_sweep_ms": half_ms, "half_sweep_product_ms": mm_ms,
        "product_tflops_per_s": 2 * plan.n0 * plan.n_pad ** 2 / mm_ms / 1e9,
        "peak_bytes": peak, "kernel_launches": launches_json(launches), **q})
    check(q["jaccard_average"] >= 0.90, "dense Eat jaccard_average < 0.90")
    check(q["recall_average"] >= 0.94, "dense Eat recall_average < 0.94")
    return launches


def engines_agree(graph, smi: str) -> None:
    """Phase 6b: dense (float32, exact truncation) against sparse (sort
    pipeline), 4 half-sweeps, no early stop: mean per-row jaccard, and the
    score differences of ids both keep.

    The engines break ties at a cut differently (the dense one by lowest
    column of the partition order), and a node whose degree exceeds L has
    a tied cut already at init; a row that then reads another tied
    successor set moves the scores of ids both keep.  So the shared ids are
    held to SHARED_ATOL at most and SHARED_CLOSE_SHARE of them within
    SHARED_CLOSE.  A control run with the default bfloat16 products and
    state must fail one of the three bounds: it shows they can see a state
    rounded to bfloat16."""
    from approximated_personalized_pagerank_tpu_torch import grank_baskets
    from approximated_personalized_pagerank_tpu_torch.ops.basket import jaccard_rows

    def against_sparse(dense) -> dict:
        rows_j = jaccard_rows(dense.ids, sparse.ids)
        both = ((dense.ids[:, :, None] == sparse.ids[:, None, :])
                & (dense.ids[:, :, None] >= 0))
        diff = torch.where(both, (dense.scores[:, :, None] - sparse.scores[:, None, :]).abs(),
                           0.0)
        shared = int(both.sum())
        close = int((both & (diff <= SHARED_CLOSE)).sum())
        return {"mean_row_jaccard": float(rows_j.mean()),
                "rows_with_other_ids": int((rows_j < 1).sum()),
                "shared_ids": shared, "shared_ids_within_1e-5": close,
                "shared_share_within_1e-5": close / shared,
                "rows_with_a_shared_diff_over_1e-5":
                    int((diff.amax(dim=(1, 2)) > SHARED_CLOSE).sum()),
                "max_shared_score_diff": float(diff.max())}

    def fails(m: dict) -> list:
        return [msg for bad, msg in (
            (m["mean_row_jaccard"] < 0.98, "mean row jaccard < 0.98"),
            (m["max_shared_score_diff"] > SHARED_ATOL,
             f"shared-id score difference > {SHARED_ATOL}"),
            (m["shared_share_within_1e-5"] < SHARED_CLOSE_SHARE,
             f"share of shared ids within 1e-5 < {SHARED_CLOSE_SHARE}")) if bad]

    run = lambda dtype: grank_baskets(  # noqa: E731
        graph, K, L, 4, DAMPING, -1.0, engine="dense", matmul_dtype=dtype, exact_trunc=True)
    dense, dense_s = timed(lambda: run(torch.float32))
    sparse, sparse_s = timed(lambda: grank_baskets(
        graph, K, L, 4, DAMPING, -1.0, engine="sparse", merge_algo="sort"))
    control, control_s = timed(lambda: run(torch.bfloat16))
    m, c = against_sparse(dense), against_sparse(control)
    emit_dense("b: dense f32 exact vs sparse sort on Eat", smi, {
        "half_sweeps": 4, "dense_f32_wall_s": dense_s, "sparse_sort_wall_s": sparse_s,
        **m, "shared_atol": SHARED_ATOL, "shared_close_share_floor": SHARED_CLOSE_SHARE,
        "bf16_control": {"wall_s": control_s, **c, "fails": fails(c)}})
    check(not fails(m), f"dense f32 vs sparse: {fails(m)}")
    check(bool(fails(c)), "the bfloat16 control passed phase 6b's bounds")


def dense_mc_eat(graph, smi: str) -> dict:
    """Phase 6c: MCCompletePathV2 on Eat through engine="auto" (dense) with
    seed 1; then its walks alone and its combine alone, timed apart: a
    second run of seed 1, held bitwise against the call.  Returns the
    launches of each merge entry in the call."""
    from approximated_personalized_pagerank_tpu_torch import (
        mccompletepathv2_baskets,
        walk_baskets,
    )
    from approximated_personalized_pagerank_tpu_torch.ops import dense as td

    check(td.use_dense_engine(graph.num_nodes, "auto", td.MC_DENSE_MAX_NODES),
          "engine='auto' does not resolve to dense for Eat MC")
    args = (graph, MC_K, MC_L, MC_R, DAMPING)
    clear_counts()
    torch.cuda.reset_peak_memory_stats()
    (baskets, info), first_s = timed(lambda: mccompletepathv2_baskets(
        *args, seed=1, return_info=True))
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    check(tuple(baskets.ids.shape) == (graph.num_nodes, MC_K), "dense MC baskets have the wrong shape")
    check(bool(torch.isfinite(baskets.scores).all()), "non-finite dense MC scores")
    walk, walk_s = timed(lambda: walk_baskets(graph, MC_L, MC_R, DAMPING, seed=1))
    n_pad = td._padded(graph.num_nodes)
    edges, factor = td._mc_edges(graph, DAMPING, "cuda")
    combine, combine_s = timed(lambda: td._dense_mc_combine(
        edges, factor, walk, n_pad, MC_L, MC_K, 2, torch.bfloat16))
    check(same_bits(combine, baskets), "walks + combine alone differ from the MC call")
    flops = 2 * 2 * graph.num_nodes * n_pad * n_pad  # 2 passes of [n, n_pad] @ [n_pad, n_pad]
    q = quality(baskets, graph)
    emit_dense("c: MC on Eat through engine='auto' (dense)", smi, {
        "K": MC_K, "L": MC_L, "R": MC_R, "combine_passes": 2, "wall_s": first_s,
        "walks_alone_s": walk_s, "combine_alone_s": combine_s,
        "combine_flops": flops, "combine_tflops_per_s": flops / combine_s / 1e12,
        "walk_steps": info["walk_steps"], "abandoned_walks": info["abandoned_walks"],
        "total_walks": info["total_walks"], "peak_bytes": peak,
        "kernel_launches": launches_json(launches), "walks_plus_combine_bitwise_equal": True, **q})
    check(q["jaccard_average"] >= 0.94, "dense Eat MC jaccard_average < 0.94")
    return launches


def dense_cutoff(smi: str) -> None:
    """Phase 6d: canonical GRank at the auto cutoff (16,384 nodes, Eat's
    13.5 edges a node), dense and sparse, the median of DENSE_REPEATS calls
    each after a warm-up call."""
    from approximated_personalized_pagerank_tpu_torch import grank_baskets
    from approximated_personalized_pagerank_tpu_torch.utils.synthetic import powerlaw_graph

    g = powerlaw_graph(CUTOFF_NODES, CUTOFF_EDGES, seed=7)
    out = {"graph": f"powerlaw_graph({CUTOFF_NODES}, {CUTOFF_EDGES}, seed=7)",
           "nodes": g.num_nodes, "edges": g.num_edges}
    for engine in ("dense", "sparse"):
        run = lambda: grank_baskets(g, K, L, ITERS, DAMPING, TOL, engine=engine,  # noqa: E731
                                    return_info=True)
        timed(run)
        walls = []
        for _ in range(DENSE_REPEATS):
            (b, info), s = timed(run)
            walls.append(s)
        check(bool(torch.isfinite(b.scores).all()), f"non-finite {engine} scores at the cutoff")
        out[f"{engine}_wall_s"] = float(np.median(walls))
        out[f"{engine}_walls_s"] = walls
        out[f"{engine}_iterations_ran"] = info["iterations_ran"]
    emit_dense("d: dense vs sparse at the auto cutoff", smi, out)


def dense_cli(smi: str) -> None:
    """Phase 6e: the CLI on the bundled sample graph (engine auto: dense),
    saved, loaded back and held bitwise against a direct call."""
    import contextlib
    import io
    import os

    from approximated_personalized_pagerank_tpu_torch import (
        grank_baskets,
        load_baskets,
        load_csv_graph,
        sample_graph_path,
    )
    from approximated_personalized_pagerank_tpu_torch.cli import main as cli_main

    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "cli_baskets.npz")
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        rc, cli_s = timed(lambda: cli_main(["--save", path]))
    check(rc == 0, f"the CLI exited {rc}")
    loaded, keys = load_baskets(path)
    direct = grank_baskets(load_csv_graph(sample_graph_path()), K, L, ITERS, DAMPING, TOL)
    check(same_bits(loaded, direct), "the CLI's saved baskets differ from a direct call")
    lines = printed.getvalue().splitlines()
    emit_dense("e: the CLI on the sample graph", smi, {
        "cli_s": cli_s, "rows": loaded.ids.shape[0], "keys": len(keys),
        "bitwise_equal_to_direct_call": True,
        "printed": [ln for ln in lines if "run-time" in ln or "jaccard average" in ln]})


def phase_dense(smi: str) -> dict:
    """Phase 6: the dense engine (6a-6e), and its wall time.  Returns the
    launches of each merge entry on its paths."""
    from approximated_personalized_pagerank_tpu_torch import load_eat_graph

    t0 = time.perf_counter()
    eat = load_eat_graph()
    grank_launches = dense_grank_eat(eat, smi)
    engines_agree(eat, smi)
    mc_launches = dense_mc_eat(eat, smi)
    dense_cutoff(smi)
    dense_cli(smi)
    emit_dense("all", smi, {"wall_s": time.perf_counter() - t0})
    return {k: {key: grank_launches[k].get(key, 0) + mc_launches[k].get(key, 0)
                for key in set(grank_launches[k]) | set(mc_launches[k])}
            for k in grank_launches}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    name, count, smi = phase_device()
    max_err, g_err, timings = phase_kernel()
    eat_launches = phase_eat()
    scale_launches, big = phase_scale()
    mc_launches, mc_errs = phase_mc()
    walk_launches = phase_walk_scale(big)
    del big
    # the main paths' runs
    runs = [eat_launches, scale_launches, mc_launches, walk_launches, phase_dense(smi)]
    launches = {k: sum(sum(r[k].values()) for r in runs) for k in runs[0]}
    for k, n in launches.items():
        check(n > 0, f"{k} was not launched on the main path")
    max_err, g_err = max(max_err, mc_errs["fused_merge_topl"]), max(g_err, mc_errs["gather_merge_topl"])
    matrix = timings[0]  # Eat's widest chunk, W=8192, C=517
    gather = next(t for t in timings  # Eat's widest bucket, one launch
                  if t["entry"] == "gather" and t["C"] == EAT_BUCKETS[0][1])
    emit({"kernels": [
        {"name": name_, "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": REPLACES, "launches": launches[name_], "max_abs_err": err,
         "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
         "bound_by": t["bound_by"], "library_ms": None}
        for name_, err, t in (("fused_merge_topl", max_err, matrix),
                              ("gather_merge_topl", g_err, gather))
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
