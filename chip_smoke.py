#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the fused merge kernel and the walk cohort kernel from the
repository's sources, and holds both of the merge kernel's entries (the
matrix entry ``fused_merge_topl`` and the gather entry
``gather_merge_topl``) against their plain PyTorch versions on the card:
modulo ties on rows of random scores, and bitwise (ids, score bits and
order) on rows of exact sums whose totals tie, at every instantiation of
the kernel and on both forms of its tie network (step 4d: the live totals
alone, or the dense network over the row); checks that their output is
bitwise deterministic and free of the order of a row's candidates, and
times them, tied rows beside untied.
Then it drives the port's main paths, counting each entry's launches in
each:

* phase 2: sparse GRank on the bundled Eat graph, scored against the exact
  oracle, with the gather entry held and timed on the warm-up's real
  basket state (the widest bucket);
* phase 3: two GRank half-sweeps on a 1M-node power-law graph that takes
  the hub path, and the gather entry on that graph's real basket state;
* phase 4: MCCompletePathV2 on Eat (K=50, L=200, R=1000), scored against
  the oracle beside the sort pipeline, with the walks' checks (one chunk's
  trace bitwise equal on the card, walked by the walk cohort kernel, and
  on the CPU, by the plain loop; threefry bits equal on both; trace and
  counts engines equal; two runs of one seed equal; the walk baskets'
  digest equal to the CPU plain pipeline's on the same walks), the walk
  kernel held bitwise against the plain loop on the card and both timed
  at Eat's chunk, and the merge kernel's entries held and timed at the MC
  path's own shapes;
* phase 5: the walks alone (R=200) on the phase 3 graph;
* phase 6: the dense engine: (a) GRank on Eat, timed, its FLOP rate and
  quality; (b) dense (float32, exact truncation) against sparse on Eat,
  with a bfloat16 control that must fail its bounds; (c) MC on Eat through
  ``engine="auto"``, which is dense, then its walks and its combine run
  apart, timed, and bitwise equal to the call; (d) dense and sparse GRank
  at the auto cutoff, 16,384 nodes; (e) the CLI on the sample graph,
  saved and held bitwise against a direct call;
* phase 7: the sharded paths on virtual shards of the one card (7a-7g:
  the ring on Eat and at 1M nodes, sharded MC, the sharded oracle, a
  process group of one over NCCL, the CLI's ``grank_multi``), bitwise
  checks included, and (7h) the sort pipeline's run sums repeated for
  equal bits;
* phase 8: the native loader on Eat, then the example drivers
  (``examples/*_torch.py``): ``run_eat_torch`` at full Eat scale,
  ``run_synthetic_torch``, ``run_sharded_torch`` and ``bench_ring_torch``
  at reduced sizes, and the north star, ``run_scale_torch`` at 4.8M nodes
  and 69M edges through ``bench_torch.py::bench_scale_full``, held to the
  TPU run's quality on the same graph, its MC jaccard printed beside the
  TPU's, then on its graph the walk kernel against the plain loop, bitwise
  and timed, at MC's first source chunk (32,768 rows);
* phase 9: ``bench_torch.py``'s quick blocks (bench.py's Eat GRank and
  MC, dense, ring and 1M-node scale blocks), its keys held against
  bench.py's, its Eat GRank baskets against phase 2's digest.

Phases 2, 3, 4 and 8f print the sha256 of their final baskets (the ids'
bytes and the scores' bits), so two trees' runs can be held bit for bit,
and the share of each entry's rows that took the kernel's prune network
for ties (step 4d of ``csrc/merge_topl.cu``), by cause (the cut split a
run of equal totals, or only survivors repeated one) and by live count m.
Phases 2-4 name ``engine="sparse"``.  Each phase (each part of phase 6)
prints one JSON line; any failure exits non-zero.  The total wall comes
before the ``kernels`` line; the last line is ``{"ok": true, "device":
{...}}``.  Exits non-zero, printing no result,
when no CUDA device is present.
"""

from __future__ import annotations

import contextlib
import json
import math
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
# Rows whose sums are exact (dyadic scores from TIE_VALUES, TIE_NODES ids in
# the gather entry's baskets): each entry must equal its plain version bit
# for bit, ties included.  Matrix entry: every network width at l_pad 128-512,
# the ends of the contract, and GRank's and MC's widest shapes; gather entry
# (D, Lb, L, l_pad, self entry): the network at 256-4096, the run merge at
# 8192 (GRank, the MC combine, a hub group), a row as wide as l_pad, and runs
# over 512 (the network at 8192).
TIE_VALUES = np.array([0.25, 0.5, 1.0], dtype=np.float32)
TIE_NODES = 3000
TIE_L_PADS = (128, 256, 512)
TIE_SHAPES = ((8192, 517, 128), (4096, 1048, 128), (8192, 512, 256))
TIE_GATHER = ((5, 50, 50, 128, True), (10, 100, 100, 128, True), (20, 100, 100, 256, True),
              (40, 100, 100, 128, True), (81, 100, 100, 128, True), (40, 200, 200, 256, True),
              (40, 200, 400, 512, False), (20, 20, 300, 512, True), (15, 520, 100, 128, True))
TIE_ROWS = 256
# Step 4d's forms (csrc/merge_topl.cu): tied rows of m live keys on either
# side of its branches, one warp (m <= 32, or the 32 threads of a row of
# 256), several warps, and the dense network (m above a quarter of the
# row's sort width).  Matrix entry (W, l_pad, m), at both thread counts
# (E=8 below 4096, E=16 from it); gather entry (D, Lb, valid successors,
# live slots a basket, l_pad, self entry): the run merge at 8192 (GRank's
# and MC's combine's shapes) and the network at 4096 and 1024.
LIVE_FORMS = ((256, 128, 60), (256, 128, 100), (1024, 256, 30), (1024, 256, 200),
              (1024, 256, 400), (4096, 128, 30), (4096, 128, 700), (4096, 128, 2000),
              (8192, 128, 32), (8192, 128, 700), (8192, 128, 2048), (8192, 128, 2049),
              (8192, 256, 5000))
LIVE_GATHER_FORMS = ((81, 100, 30, 1, 128, True), (81, 100, 81, 8, 128, True),
                     (81, 100, 81, 40, 128, True), (40, 200, 30, 1, 256, True),
                     (40, 200, 40, 10, 256, True), (40, 200, 40, 100, 256, True),
                     (40, 100, 30, 1, 128, True), (40, 100, 40, 10, 128, True),
                     (40, 100, 40, 40, 128, True), (10, 100, 10, 3, 128, True),
                     (10, 100, 10, 20, 128, True), (10, 100, 10, 80, 128, True))
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, and 32-bit operations/s
# outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# Lane instructions/s an H100 SXM issues at most: 132 SMs x 4 schedulers
# x 32 lanes x 1.98 GHz boost (Hopper architecture white paper).  The walk
# kernel's work is integer instructions, which issue on more than one pipe
# (IMAD on the FMA pipe, adds, shifts and logic on the ALU pipe), so its
# peak is the issue rate, not the 64 INT32 lanes of an SM.
ISSUE_OPS_PER_S = 132 * 4 * 32 * 1.98e9
# Integer operations of one threefry-2x32 hash of 20 rounds: 20 x (add,
# rotate, xor; a rotate is one funnel shift on sm_90), 5 key injections of
# 2 adds, and the 2 adds of the start.  A slot's hop draws two uniforms,
# one hash each; the hop's own work is not counted.
THREEFRY_OPS = 20 * 3 + 5 * 2 + 2
WALK_SOURCE = "approximated_personalized_pagerank_tpu_torch/csrc/walk_cohort.cu"
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
# phase 8f: the v5e TPU's MC jaccard on the same graph and config (the JAX
# package's docs/PERF.md, round 5: one run, seed 1).  The card reads
# 0.937-0.940 over seeds 1-4.  The gap is known not to be the walks (bitwise
# the JAX package's at 3,000 and 200,000 nodes and on Eat), a combine pass
# or the final cut (the JAX package's up to ties at the cut and the order of
# sums, from a shared input), nor the kernel or the hub hierarchy (the flat
# sort pipeline reads within the seed spread of the kernel's on the card):
# mc_tie_study.py stages / card, ROADMAP C5.
TPU_V5E_MC_JACCARD = 0.9449
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
    """The card's name and power limit, as ``nvidia-smi`` prints them."""
    from approximated_personalized_pagerank_tpu_torch.utils.device import card_line

    line = card_line()
    check(line is not None, "nvidia-smi gave no name and power limit")
    return line


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


def untied_rows(w: int, rows: int, rng: np.random.Generator, pad_id: int):
    """[rows, w] rows like a GRank chunk's: ids from Eat's node count, 15%
    dead, scores drawn at random (so totals seldom tie)."""
    ids = rng.integers(0, EAT_NODES, (rows, w)).astype(np.int32)
    ids[rng.random((rows, w)) < 0.15] = pad_id
    return ids, (rng.random((rows, w)) / w).astype(np.float32)


def tied_rows(w: int, rows: int, rng: np.random.Generator, pad_id: int):
    """[rows, w] candidate rows with scores of three dyadic values, so that
    every run sum is exact and totals tie within rows, at the cut and among
    the survivors: a live share of 1/8 to all of a row, ids drawn from a
    third of the live count (runs of about three)."""
    ids = np.full((rows, w), pad_id, dtype=np.int32)
    scores = np.zeros((rows, w), dtype=np.float32)
    for r in range(rows):
        live = int(rng.integers(max(1, w // 8), w + 1))
        ids[r, :live] = rng.integers(0, max(2, live // 3), live)
        scores[r, :live] = rng.choice(TIE_VALUES, live)
        perm = rng.permutation(w)
        ids[r], scores[r] = ids[r, perm], scores[r, perm]
    return ids, scores


def tied_gather_inputs(rng: np.random.Generator, c: int, d: int, lb: int, dev):
    """Like gather_inputs, with exact sums: baskets [TIE_NODES, lb] of
    distinct ids and dyadic scores, rows of ragged degree, per-row scales
    that are powers of two, dyadic self scores, and a post-scale."""
    ids = np.stack([rng.permutation(TIE_NODES)[:lb] for _ in range(TIE_NODES)]).astype(np.int32)
    ids[rng.random((TIE_NODES, lb)) < 0.1] = -1
    sc = np.where(ids >= 0, rng.choice(TIE_VALUES / 16, (TIE_NODES, lb)), 0).astype(np.float32)
    succ = rng.integers(0, TIE_NODES, (c, d)).astype(np.int64)
    deg = rng.integers(d // 2 + 1, d + 1, c)
    succ[np.arange(d)[None, :] >= deg[:, None]] = -1
    rows = rng.integers(0, TIE_NODES, c).astype(np.int64)
    scale = (2.0 ** -rng.integers(0, 4, c)).astype(np.float32)
    self_sc = rng.choice(TIE_VALUES, c).astype(np.float32)
    post = rng.random(c).astype(np.float32)
    return [torch.as_tensor(x, device=dev) for x in (ids, sc, succ, rows, scale, self_sc, post)]


def live_count_rows(w: int, rows: int, l_pad: int, m: int, rng: np.random.Generator,
                    pad_id: int):
    """[rows, w] tied rows of exact sums whose live count (the totals at or
    above the top-l_pad cut) is m: m distinct ids of total 1 or 2 (fewer
    than l_pad of 2), a quarter of them a run of two halves, and when m >=
    l_pad ids of total 0.25, below the cut, in the free slots."""
    ids = np.full((rows, w), pad_id, dtype=np.int32)
    sc = np.zeros((rows, w), dtype=np.float32)
    for r in range(rows):
        uid = rng.permutation(w)
        tot = np.ones(m, dtype=np.float32)
        tot[: min(l_pad, m) // 2] = 2.0
        doubles = min(m // 4, w - m)
        slot_ids = np.concatenate([uid[:m], uid[:doubles]])
        slot_sc = np.concatenate([tot, np.zeros(doubles, dtype=np.float32)])
        slot_sc[:doubles] /= 2
        slot_sc[m:] = slot_sc[:doubles]
        if m >= l_pad:
            free = w - slot_ids.size
            slot_ids = np.concatenate([slot_ids, uid[m:m + free]])
            slot_sc = np.concatenate([slot_sc, np.full(free, 0.25, dtype=np.float32)])
        perm = rng.permutation(w)[: slot_ids.size]
        ids[r, perm], sc[r, perm] = slot_ids, slot_sc
    return ids, sc


def live_count_gather(rng: np.random.Generator, c: int, d: int, lb: int, d_live: int,
                      lv: int, self_entry: bool, dev):
    """The gather entry's inputs, exact sums, rows of about d_live * lv live
    keys: baskets [TIE_NODES, lb] of lv live slots with ids of their own
    (1/16, the first 1/8), c rows of d_live distinct successors padded with
    -1 to d, scales that are powers of two, a dyadic self entry and a
    post-scale (or neither)."""
    ids = np.full((TIE_NODES, lb), -1, dtype=np.int32)
    ids[:, :lv] = np.arange(TIE_NODES)[:, None] * lb + np.arange(lv)[None, :]
    sc = np.where(ids >= 0, 1 / 16, 0).astype(np.float32)
    sc[:, 0] = 1 / 8
    succ = np.stack([rng.permutation(TIE_NODES)[:d] for _ in range(c)]).astype(np.int64)
    succ[:, d_live:] = -1
    rows = rng.integers(0, TIE_NODES, c).astype(np.int64)
    scale = (2.0 ** -rng.integers(0, 4, c)).astype(np.float32)
    out = [torch.as_tensor(x, device=dev) for x in (ids, sc, succ, rows, scale)]
    if not self_entry:
        return out + [None, None]
    return out + [torch.as_tensor(x, device=dev) for x in (
        rng.choice(TIE_VALUES, c).astype(np.float32), rng.random(c).astype(np.float32))]


def live_counts(ids: np.ndarray, scores: np.ndarray, l_pad: int, pad_id: int) -> np.ndarray:
    """Each row's live count m: its totals at or above the l_pad-th largest
    (all of them, when no more than l_pad)."""
    out = []
    for r_ids, r_sc in zip(ids, scores):
        live = (r_ids != pad_id) & (r_ids >= 0)
        _, inv = np.unique(r_ids[live], return_inverse=True)
        tot = np.bincount(inv, weights=r_sc[live].astype(np.float64))
        thr = -np.sort(-tot)[l_pad - 1] if tot.size > l_pad else -np.inf
        out.append(int(np.sum(tot >= thr)))
    return np.array(out)


def live_hist(m: np.ndarray, tied: np.ndarray) -> dict:
    """The kernel's m histogram of the tied rows, from their live counts."""
    from approximated_personalized_pagerank_tpu_torch.ops.merge_kernel import LIVE_BUCKETS

    bucket = np.searchsorted([128, 512, 2048], m[tied])
    return {b: int(np.sum(bucket == i)) for i, b in enumerate(LIVE_BUCKETS)}


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


def real_state_timing(graph, state, partition: int, label: str) -> dict:
    """The gather entry on a real basket state (GRank's ``[N, L]`` baskets:
    distinct ids sorted by score, -1 tails): the rows of ``partition``'s
    widest bucket below the hub path, in the first chunk ``merge_bucket``
    gives it, held against the plain version (``ATOL``) and timed beside
    its bound."""
    from approximated_personalized_pagerank_tpu_torch.ops import merge as tm
    from approximated_personalized_pagerank_tpu_torch.ops import merge_kernel as mk
    from approximated_personalized_pagerank_tpu_torch.utils.compare import topl_max_error

    hub_sub = (mk.MAX_KERNEL_WIDTH - 1) // L
    plan = graph.merge_plan(partition, L=L, net_width=mk.MAX_KERNEL_WIDTH)
    top = max((b for b in plan.buckets if b.cap <= hub_sub), key=lambda b: (b.cap, b.rows.size))
    chunk = tm.DEFAULT_ELEM_BUDGET // (2 * L)
    succ = torch.as_tensor(top.succ[:chunk], dtype=torch.int64, device="cuda")
    rows = torch.as_tensor(top.rows[:chunk], dtype=torch.int64, device="cuda")
    scale, self_sc, post = grank_scales(succ)
    args = (state.ids, state.scores, succ, rows, scale, self_sc, post, L, 128)
    k, p = mk.gather_merge_topl(*args), mk.gather_merge_topl_plain(*args)
    torch.cuda.synchronize()
    err = topl_max_error(k.ids.cpu().numpy(), k.scores.cpu().numpy(),
                         p.ids.cpu().numpy(), p.scores.cpu().numpy(), ATOL)
    work = gather_work(state.ids, succ, L)
    b_ms, b_by = bound_ms(*work)
    return {"entry": "gather", "state": label, "W": mk.next_pow2(top.cap * L + 1),
            "D": top.cap, "C": int(succ.shape[0]), "l_pad": 128,
            "live_slot_share": float((state.ids >= 0).float().mean()),
            "max_abs_err": err, "atol": ATOL,
            "ms": time_ms(lambda: mk.gather_merge_topl(*args), 20),
            "plain_ms": time_ms(lambda: mk.gather_merge_topl_plain(*args), 5),
            "bound_ms": b_ms, "bound_by": b_by, "bound_bytes": work[0], "bound_ops": work[1]}


def measured_merges(graph, half_sweeps: int) -> int:
    """Basket-merge slot updates of ``half_sweeps`` half-sweeps at L
    (bench_torch.py's, bench.py's formula)."""
    return load_bench().measured_merges(graph, L, half_sweeps)


def phase_device():
    """Phase 0: the card, and the kernels' build times."""
    from approximated_personalized_pagerank_tpu_torch.ops import merge_kernel, walk_kernel

    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi_line()
    t0 = time.perf_counter()
    merge_kernel.load_library()
    t1 = time.perf_counter()
    walk_kernel.load_library()
    emit({"phase": 0, "device": name, "count": count, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "kernel_build_s": t1 - t0, "walk_kernel_build_s": time.perf_counter() - t1})
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

    tied, tied_timings = tied_checks(rng, dev)

    timings = []
    for w, c in EAT_SHAPES:
        ids, sc = (torch.as_tensor(x, device=dev) for x in untied_rows(w, c, rng, mk.PAD_ID))
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
          "tied_bitwise_cases": tied, "tied_timings": tied_timings,
          "cases": cases, "gather_cases": g_cases, "timings": timings})
    return max_err, g_err, timings


def tie_causes(ids: np.ndarray, scores: np.ndarray, l_pad: int, pad_id: int) -> tuple:
    """[split, repeat only]: the rows of exact sums whose top-``l_pad`` cut
    splits a run of equal totals, and the other rows whose survivors repeat
    a total (the kernel's two tied-row counters); and which rows tie."""
    split = repeat = 0
    tied = []
    for r_ids, r_sc in zip(ids, scores):
        live = r_ids != pad_id
        uniq, inv = np.unique(r_ids[live], return_inverse=True)
        tot = -np.sort(-np.bincount(inv, weights=r_sc[live].astype(np.float64)))
        if tot.size > l_pad and np.sum(tot == tot[l_pad - 1]) > np.sum(tot[:l_pad] == tot[l_pad - 1]):
            split += 1
            tied.append(True)
        elif np.any(tot[:l_pad][1:] == tot[:l_pad][:-1]):
            repeat += 1
            tied.append(True)
        else:
            tied.append(False)
    return [split, repeat], np.array(tied)


def tied_checks(rng: np.random.Generator, dev) -> tuple:
    """Phase 1's rows with exact sums: each entry bitwise equal to its plain
    version on the card (ids, score bits and order) at every instantiation,
    and the shapes of the main path timed on tied rows beside untied ones.
    Returns (the cases checked, the timings)."""
    from approximated_personalized_pagerank_tpu_torch.ops import merge_kernel as mk

    kernel, plain = mk.fused_merge_topl, mk.merge_topl_plain
    gather, gather_plain = mk.gather_merge_topl, mk.gather_merge_topl_plain
    cases, timings = [], []
    matrix = [(w, TIE_ROWS, lp) for w in WIDTHS for lp in TIE_L_PADS if lp <= w]
    matrix += [(w, TIE_ROWS, lp) for w, lp in EDGE_CASES] + list(TIE_SHAPES)
    for w, c, l_pad in matrix:
        ids_np, sc_np = tied_rows(w, c, rng, mk.PAD_ID)
        ids, sc = torch.as_tensor(ids_np, device=dev), torch.as_tensor(sc_np, device=dev)
        check(same_bits(kernel(ids, sc, l_pad), plain(ids, sc, l_pad)),
              f"matrix entry, tied rows ({w}, {c}, {l_pad}): not bitwise its plain version")
        cases.append({"entry": "matrix", "W": w, "C": c, "l_pad": l_pad})
        if (w, c, l_pad) in TIE_SHAPES:
            untied = [torch.as_tensor(x, device=dev)
                      for x in untied_rows(w, c, rng, mk.PAD_ID)]
            mk.count_tied_rows(True)
            kernel(ids, sc, l_pad)
            counts = mk.tied_row_counts()["fused_merge_topl"]
            want, tied = tie_causes(ids_np, sc_np, l_pad, mk.PAD_ID)
            hist = live_hist(live_counts(ids_np, sc_np, l_pad, mk.PAD_ID), tied)
            check([counts["split"], counts["repeat_only"]] == want and counts["live_hist"] == hist,
                  f"matrix entry, tied rows ({w}, {c}, {l_pad}): the kernel counted "
                  f"{counts}, the rows hold {want} (split, repeat only) and m {hist}")
            mk.count_tied_rows(True)
            kernel(*untied, l_pad)
            untied_counts = mk.tied_row_counts()["fused_merge_topl"]
            mk.count_tied_rows(False)
            timings.append({"entry": "matrix", "W": w, "C": c, "l_pad": l_pad,
                            "tied_rows": counts, "untied_rows_tied": untied_counts,
                            "tied_ms": time_ms(lambda: kernel(ids, sc, l_pad), 20),
                            "untied_ms": time_ms(lambda: kernel(*untied, l_pad), 20)})
    for d, lb, out_l, l_pad, self_entry in TIE_GATHER:
        b_ids, b_sc, succ, rows, scale, self_sc, post = tied_gather_inputs(
            rng, TIE_ROWS, d, lb, dev)
        if not self_entry:
            self_sc, post = None, None
        args = (b_ids, b_sc, succ, rows, scale, self_sc, post, out_l, l_pad)
        check(same_bits(gather(*args), gather_plain(*args)),
              f"gather entry, tied rows (D {d}, Lb {lb}, l_pad {l_pad}): "
              "not bitwise its plain version")
        w = d * lb + int(self_entry)
        cases.append({"entry": "gather", "W": max(mk.next_pow2(w), l_pad), "D": d,
                      "Lb": lb, "C": TIE_ROWS, "l_pad": l_pad, "self_entry": self_entry})
    # step 4d's forms, each on rows of one live count m (a stream of their own,
    # so the cases and timings around them keep their inputs)
    frng = np.random.default_rng(9)
    for w, l_pad, m in LIVE_FORMS:
        ids_np, sc_np = live_count_rows(w, 64, l_pad, m, frng, mk.PAD_ID)
        ids, sc = torch.as_tensor(ids_np, device=dev), torch.as_tensor(sc_np, device=dev)
        mk.count_tied_rows(True)
        got = kernel(ids, sc, l_pad)
        counts = mk.tied_row_counts()["fused_merge_topl"]
        mk.count_tied_rows(False)
        check(same_bits(got, plain(ids, sc, l_pad)),
              f"matrix entry, step 4d at m={m} ({w}, {l_pad}): not bitwise its plain version")
        hist = live_hist(np.full(64, m), np.ones(64, dtype=bool))
        check(counts["live_hist"] == hist,
              f"matrix entry, step 4d at m={m} ({w}, {l_pad}): the kernel counted {counts}")
        cases.append({"entry": "matrix", "W": w, "C": 64, "l_pad": l_pad, "m": m,
                      "ms": time_ms(lambda: kernel(ids, sc, l_pad), 20)})
    for d, lb, d_live, lv, l_pad, self_entry in LIVE_GATHER_FORMS:
        args = (*live_count_gather(frng, 64, d, lb, d_live, lv, self_entry, dev), l_pad, l_pad)
        check(same_bits(gather(*args), gather_plain(*args)),
              f"gather entry, step 4d (D {d}, Lb {lb}, {d_live} x {lv} live, l_pad {l_pad}): "
              "not bitwise its plain version")
        cases.append({"entry": "gather", "D": d, "Lb": lb, "C": 64, "l_pad": l_pad,
                      "m_about": d_live * lv + int(self_entry), "self_entry": self_entry,
                      "ms": time_ms(lambda: gather(*args), 20)})
    # the gather entry at Eat's widest bucket: tied rows beside GRank-like ones
    d, c = EAT_BUCKETS[0]
    b_ids, b_sc, succ, rows, scale, self_sc, post = tied_gather_inputs(rng, c, d, L, dev)
    t_args = (b_ids, b_sc, succ, rows, scale, self_sc, post, L, 128)
    check(same_bits(gather(*t_args), gather_plain(*t_args)),
          "gather entry, tied rows at Eat's widest bucket: not bitwise its plain version")
    u_ids, u_sc, u_succ, u_rows = gather_inputs(rng, c, d, dev)
    u_args = (u_ids, u_sc, u_succ, u_rows, *grank_scales(u_succ), L, 128)
    timings.append({"entry": "gather", "D": d, "C": c, "l_pad": 128,
                    "tied_ms": time_ms(lambda: gather(*t_args), 20),
                    "untied_ms": time_ms(lambda: gather(*u_args), 20)})
    return cases, timings


def launch_counts():
    """The merge entries' launch counters, by (W, l_pad)."""
    from approximated_personalized_pagerank_tpu_torch.ops import merge_kernel as mk

    return {"fused_merge_topl": mk.fused_merge_topl.launches,
            "gather_merge_topl": mk.gather_merge_topl.launches}


def clear_counts() -> None:
    """Sets every kernel's launch count to 0: a phase's window opens."""
    from approximated_personalized_pagerank_tpu_torch.ops import walk_kernel

    for counter in launch_counts().values():
        counter.clear()
    walk_kernel.walk_cohort.launches = 0


def read_counts() -> dict:
    """Each kernel's launches since clear_counts: the merge entries' by
    (W, l_pad), the walk kernel's (one a source chunk) under "chunks"."""
    from approximated_personalized_pagerank_tpu_torch.ops import walk_kernel

    counts = {name: dict(c) for name, c in launch_counts().items()}
    counts["walk_cohort"] = {"chunks": walk_kernel.walk_cohort.launches}
    return counts


def start_tie_counts() -> None:
    from approximated_personalized_pagerank_tpu_torch.ops import merge_kernel as mk

    mk.count_tied_rows(True)


def read_tie_counts() -> dict:
    """Each entry's rows since start_tie_counts, and the shares of them
    that took the kernel's prune network, by cause; counting stops."""
    from approximated_personalized_pagerank_tpu_torch.ops import merge_kernel as mk

    counts = mk.tied_row_counts()
    mk.count_tied_rows(False)
    return {name: {**c, "split_share": c["split"] / max(c["rows"], 1),
                   "repeat_only_share": c["repeat_only"] / max(c["rows"], 1)}
            for name, c in counts.items()}


def launches_json(counts: dict) -> dict:
    return {name: {"x".join(map(str, k)) if isinstance(k, tuple) else k: v
                   for k, v in sorted(c.items())}
            for name, c in counts.items()}


def phase_eat() -> dict:
    """Phase 2: the headline, GRank on Eat through the kernel, against the
    sort pipeline and the exact oracle.  ``wall_s`` is the median of
    EAT_REPEATS timed calls; the launch counts are the first call's.
    Returns the main path's launches of each entry, and the baskets'
    sha256."""
    from approximated_personalized_pagerank_tpu_torch import (
        benchmark_sampled,
        grank_baskets,
        load_eat_graph,
        sample_result,
    )
    from approximated_personalized_pagerank_tpu_torch.ops.basket import jaccard_rows
    from approximated_personalized_pagerank_tpu_torch.utils.compare import basket_sha256

    graph = load_eat_graph()
    # the warm-up keeps all L slots: the basket state the half-sweeps read
    state = grank_baskets(graph, L, L, 2, DAMPING, TOL, engine="sparse")
    torch.cuda.synchronize()
    real_state = real_state_timing(graph, state, 0, "eat after 2 half-sweeps")
    del state
    clear_counts()
    start_tie_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    baskets, info = grank_baskets(graph, K, L, ITERS, DAMPING, TOL, engine="sparse",
                                  return_info=True)
    torch.cuda.synchronize()
    walls = [time.perf_counter() - t0]
    launches = read_counts()
    ties = read_tie_counts()
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
    digest = basket_sha256(baskets)
    samples = [sample_result(b, graph, 200, True, seed=0) for b in (baskets, sorted_b)]
    stats, sort_stats = benchmark_sampled(samples, graph)
    emit({"phase": 2, "graph": "eat", "nodes": graph.num_nodes,
          "edges": graph.num_edges, "wall_s": wall, "walls_s": walls,
          "iterations_ran": iters,
          "basket_merges_per_s": measured_merges(graph, iters) / wall,
          "kernel_launches": launches_json(launches), "tied_rows": ties,
          "peak_bytes": peak, "sort_wall_s": sort_wall,
          "sort_iterations_ran": sort_info["iterations_ran"],
          "baskets_sha256": digest, "gather_real_state": real_state,
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
    return launches, digest


def phase_scale() -> tuple:
    """Phase 3: two half-sweeps at 1M nodes, through the hub path.  Returns
    the launches of each entry, and the graph."""
    from approximated_personalized_pagerank_tpu_torch import grank_baskets
    from approximated_personalized_pagerank_tpu_torch.ops.merge_kernel import (
        MAX_KERNEL_WIDTH,
    )
    from approximated_personalized_pagerank_tpu_torch.utils.compare import basket_sha256
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
    start_tie_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out, info = grank_baskets(big, K, L, 2, DAMPING, -1.0, engine="sparse",
                              return_info=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    ties = read_tie_counts()
    peak = torch.cuda.max_memory_allocated()
    # the hub group level, through the gather entry at l_pad 256
    wide = sum(v for (w, lp), v in launches["gather_merge_topl"].items() if lp == 256)
    rows = torch.as_tensor(
        np.random.default_rng(1).choice(big.num_nodes, 4096, replace=False),
        device="cuda",
    )
    ids = out.ids[rows].cpu().numpy()
    sc = out.scores[rows].cpu().numpy()
    digest = basket_sha256(out)
    state = grank_baskets(big, L, L, 2, DAMPING, -1.0, engine="sparse")
    real_state = real_state_timing(big, state, 0, "1M after 2 half-sweeps")
    del state
    emit({"phase": 3, "graph": "powerlaw(1e6, 1e7, seed=7, locality=0.8)",
          "setup_s": setup_s, "wall_s": wall,
          "iterations_ran": info["iterations_ran"], "peak_bytes": peak,
          "hub_rows": int(hub_rows), "hub_group_gather_launches": wide,
          "kernel_launches": launches_json(launches), "tied_rows": ties,
          "basket_merges_per_s": measured_merges(big, 2) / wall,
          "baskets_sha256": digest, "gather_real_state": real_state})
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


def walk_kernel_timing(graph, R: int, seed: int) -> dict:
    """The walk cohort kernel against the plain loop, both on the card, on
    the graph's first source chunk of MC's walks at ``R`` under ``seed``:
    trace, abandoned walks and macro steps bitwise equal (``max_abs_err``
    is the largest difference read); each timed with CUDA events (the
    kernel over several launches, the plain loop over one call, its host
    syncs included), beside the kernel's bound.  Call it outside a launch
    count's window: its launches are not a main path's."""
    from approximated_personalized_pagerank_tpu_torch.ops import walk as tw
    from approximated_personalized_pagerank_tpu_torch.utils import profiling, prng

    n = graph.num_nodes
    chunk, _, slots, total, macro, width = tw._trace_chunks(
        n, R, DAMPING, None, None, MC_UNROLL)
    dg = graph.device_graph("cuda")
    srcs, real = tw._chunk_sources(0, n, chunk, "cuda")
    key = prng.fold_in(tw._root_key(seed), 0)
    damping_t = torch.tensor(DAMPING, dtype=torch.float32, device="cuda")
    args = (dg.start_deg, dg.indices, srcs, key, damping_t, total, slots, macro, MC_UNROLL)

    def walked(fn):
        with profiling.record():
            with profiling.span("mc.walks") as s:
                out = fn(*args)
        torch.cuda.synchronize()
        profiling.clear()
        return out, s.counts.get("macro_steps", 0)

    (k_trace, k_ab), k_steps = walked(tw.walk_trace_chunk)
    (p_trace, p_ab), p_steps = walked(tw.walk_trace_plain)
    err = max(int((k_trace.long() - p_trace.long()).abs().max()),
              int((k_ab - p_ab).abs().max()), abs(k_steps - p_steps))
    check(err == 0, f"the walk kernel differs from the plain loop on the card ({n} nodes, "
                    f"R={R}): largest difference {err}")
    kernel_ms = time_ms(lambda: tw.walk_trace_chunk(*args), 10)
    plain_ms = time_ms(lambda: tw.walk_trace_plain(*args), 1)
    # the least work these inputs need.  Bytes: the trace and the rows'
    # results written once, the sources read, and of the CSR only what the
    # walks must touch: the (indptr, degree) row of each distinct node stood
    # on and, for each distinct node stepped to, one entry of ``indices``.
    # Operations: two threefry hashes for each slot's hop that steps (a
    # visit); a hop at a dangling node (at most one a walk that ends,
    # ``walk_ends``) draws too and is left out.  Both are lower bounds.
    stepped = k_trace[k_trace >= 0].long()
    visits = int(stepped.numel())
    stepped = torch.unique(stepped)
    stood = torch.unique(torch.cat([srcs, stepped]))
    has_edges = dg.start_deg[srcs, 1] > 0
    walk_ends = int((total - k_ab)[has_edges].sum())
    nbytes = (k_trace.numel() * 4 + (chunk + 1) * 8 + srcs.numel() * 8
              + stood.numel() * 16 + stepped.numel() * 8)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = visits * 2 * THREEFRY_OPS / ISSUE_OPS_PER_S * 1e3
    bound, bound_by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    return {"nodes": n, "R": R, "seed": seed, "rows": chunk, "real_rows": real,
            "slots": slots, "macro_steps": macro, "macro_steps_walked": k_steps,
            "trace_width": width, "visits": visits, "walk_ends": walk_ends,
            "nodes_stood_on": int(stood.numel()), "bytes": nbytes,
            "abandoned": int(k_ab.sum()), "ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": bound_by, "bytes_ms": t_bytes, "ops_ms": t_ops,
            "roofline_share": bound / kernel_ms, "max_abs_err": err}


def cpu_walk_sha256(graph) -> str:
    """sha256 of phase 4's walk baskets (L=MC_L, R=MC_R, seed 1) as the
    CPU's kernel pipeline cuts them: every chunk's trace walked on the card
    (bitwise the CPU's, mc_walk_checks), its top-L taken on the CPU by the
    kernel's plain version, in walk_trace_basket_chunks' order."""
    from approximated_personalized_pagerank_tpu_torch.ops import walk as tw
    from approximated_personalized_pagerank_tpu_torch.ops.basket import Baskets
    from approximated_personalized_pagerank_tpu_torch.utils.compare import basket_sha256

    n = graph.num_nodes
    chunk, row_chunk, slots, total, macro, _ = tw._trace_chunks(
        n, MC_R, DAMPING, None, None, MC_UNROLL)
    dg = graph.device_graph("cuda")
    root = tw._root_key(1)
    damping_t = torch.tensor(DAMPING, dtype=torch.float32, device="cuda")
    r_total = torch.tensor(float(MC_R))
    ids, scores = [], []
    for s0 in range(0, n, chunk):
        sources, real = tw._chunk_sources(s0, n, chunk, "cuda")
        trace, _ = tw.walk_trace_chunk(dg.start_deg, dg.indices, sources, tw.fold_in(root, s0),
                                       damping_t, total, slots, macro, MC_UNROLL)
        top = tw._trace_topl(trace[:real].cpu(), sources[:real].cpu(), r_total, MC_L,
                             row_chunk, "kernel")
        ids.append(top.ids)
        scores.append(top.scores)
    return basket_sha256(Baskets(torch.cat(ids), torch.cat(scores)))


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
    launches of each entry, the largest kernel-vs-plain errors, and the walk
    kernel's timing at Eat's first chunk."""
    from approximated_personalized_pagerank_tpu_torch import (
        benchmark_sampled,
        load_eat_graph,
        mccompletepathv2_baskets,
        sample_result,
        walk_baskets,
    )
    from approximated_personalized_pagerank_tpu_torch.utils.compare import basket_sha256

    graph = load_eat_graph()
    args = (graph, MC_K, MC_L, MC_R, DAMPING)
    # the sparse engine: auto takes the dense one on Eat (phase 6)
    mccompletepathv2_baskets(*args, seed=0, engine="sparse")
    torch.cuda.synchronize()
    clear_counts()
    start_tie_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    baskets, info = mccompletepathv2_baskets(*args, seed=1, engine="sparse",
                                             return_info=True)
    torch.cuda.synchronize()
    walls = [time.perf_counter() - t0]
    launches = read_counts()
    ties = read_tie_counts()
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
    digest = basket_sha256(baskets)
    walks = mc_walk_checks(graph)
    walks["walk_kernel"] = walk_kernel_timing(graph, MC_R, 1)
    timings = mc_kernel_shapes(graph, walk, walks.pop("trace"), walks.pop("sources"))
    walk_digest = basket_sha256(walk)
    t0 = time.perf_counter()
    cpu_walk_digest = cpu_walk_sha256(graph)
    cpu_walk_s = time.perf_counter() - t0
    emit({"phase": 4, "graph": "eat", "algorithm": "mccompletepathv2",
          "K": MC_K, "L": MC_L, "R": MC_R, "wall_s": wall, "walls_s": walls,
          "walk_wall_s": walk_wall, "walk_walls_s": walk_walls,
          "walk_steps": info["walk_steps"],
          "walk_steps_per_s": info["walk_steps"] / walk_wall,
          "abandoned_walks": info["abandoned_walks"], "total_walks": info["total_walks"],
          "abandoned_share": info["abandoned_walks"] / info["total_walks"],
          "kernel_launches": launches_json(launches), "tied_rows": ties,
          "peak_bytes": peak, "sort_wall_s": sort_wall, "baskets_sha256": digest,
          "walk_baskets_sha256": walk_digest, "cpu_walk_baskets_sha256": cpu_walk_digest,
          "cpu_walk_baskets_s": cpu_walk_s,
          "jaccard_average": stats["jaccard average"],
          "jaccard_min": stats["jaccard min"],
          "recall_average": stats["recall average"],
          "kendall_average": stats["kendall average"],
          "sort_jaccard_average": sort_stats["jaccard average"],
          "sort_recall_average": sort_stats["recall average"],
          "sort_kendall_average": sort_stats["kendall average"],
          "walk_checks": "passed", **walks, "timings": timings})
    check(walk_digest == cpu_walk_digest,
          "the card's walk baskets differ from the CPU plain pipeline's on the same walks")
    check(stats["jaccard average"] >= 0.94, "Eat MC jaccard_average < 0.94")
    check(abs(stats["jaccard average"] - sort_stats["jaccard average"]) <= 0.01,
          "kernel and sort pipelines' MC jaccard differ by more than 0.01")
    errs = {"fused_merge_topl": max(t["max_abs_err"] for t in timings if t["entry"] == "matrix"),
            "gather_merge_topl": max(t["max_abs_err"] for t in timings if t["entry"] == "gather")}
    return launches, errs, walks["walk_kernel"]


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


def emit_ring(part: str, smi: str, obj: dict) -> None:
    emit({"phase": 7, "part": part, "nvidia_smi": smi, **obj})


def same_baskets(a, b) -> bool:
    return tuple(a.ids.shape) == tuple(b.ids.shape) and same_bits(a, b)


def ring_rounds(graph, d: int, L_: int, partitions) -> list:
    from approximated_personalized_pagerank_tpu_torch.parallel.ring import build_ring_plan

    return [len(build_ring_plan(graph, p, d, L_, algo="kernel").rounds) for p in partitions]


def ring_eat(eat, smi: str) -> tuple:
    """Phase 7a: the ring at D=1 on Eat (K=50, L=100, 30 half-sweeps):
    median of 3 walls beside sparse's; its ids equal the sparse engine's;
    quality through ``benchmark_sampled(mesh=)``.  Phase 7b: 4 virtual
    shards on the card, bitwise equal to D=1.  Returns the launches of the
    timed D=1 and D=4 runs, and the D=1 result."""
    from approximated_personalized_pagerank_tpu_torch import (
        benchmark_sampled,
        grank_baskets,
        make_mesh,
        sample_result,
    )

    card = torch.device("cuda", 0)
    mesh1, mesh4 = make_mesh(1, [card]), make_mesh(4, [card] * 4)
    ring = lambda mesh: grank_baskets(eat, K, L, ITERS, DAMPING, TOL, mesh=mesh,  # noqa: E731
                                      return_info=True)
    sparse = lambda: grank_baskets(eat, K, L, ITERS, DAMPING, TOL, engine="sparse",  # noqa: E731
                                   return_info=True)
    timed(lambda: ring(mesh1))  # warm-up
    clear_counts()
    (r1_any, info), first = timed(lambda: ring(mesh1))
    launches = read_counts()
    ring_walls = [first] + [timed(lambda: ring(mesh1))[1] for _ in range(2)]
    sparse_walls = [timed(sparse)[1] for _ in range(3)]
    r1, r1_info = ring(mesh1)
    s1, s1_info = sparse()
    r4, r4_info = ring(mesh4)
    ids_equal = bool(torch.equal(r1.ids, s1.ids))
    (q,) = benchmark_sampled([sample_result(r1, eat, 200, True, seed=0)], eat, mesh=mesh1)
    ring_wall, sparse_wall = float(np.median(ring_walls)), float(np.median(sparse_walls))
    emit_ring("a: ring D=1 on Eat", smi, {
        "K": K, "L": L, "half_sweeps": ITERS, "tol": TOL,
        "wall_s": ring_wall, "walls_s": ring_walls, "sparse_wall_s": sparse_wall,
        "sparse_walls_s": sparse_walls, "ring_vs_sparse": ring_wall / sparse_wall,
        "iterations_ran": info["iterations_ran"], "sparse_iterations_ran": s1_info["iterations_ran"],
        "rounds": ring_rounds(eat, 1, L, (0, 1)), "kernel_launches": launches_json(launches),
        "ids_identical_to_sparse": ids_equal,
        "scores_bitwise_equal_to_sparse": same_baskets(r1, s1),
        "jaccard_average": q["jaccard average"], "recall_average": q["recall average"],
        "kendall_average": q["kendall average"]})
    check(ids_equal, "7a: ring D=1 ids differ from the sparse engine's")
    check(r1_info["iterations_ran"] == s1_info["iterations_ran"] == info["iterations_ran"],
          "7a: ring and sparse ran different half-sweeps")
    check(q["jaccard average"] >= 0.90, "7a: ring Eat jaccard_average < 0.90")
    check(q["recall average"] >= 0.94, "7a: ring Eat recall_average < 0.94")

    clear_counts()
    (r4_any, info4), wall4 = timed(lambda: ring(mesh4))
    launches4 = read_counts()
    emit_ring("b: ring D=4 virtual shards on Eat", smi, {
        "wall_s": wall4, "iterations_ran": info4["iterations_ran"],
        "rounds": ring_rounds(eat, 4, L, (0, 1)), "kernel_launches": launches_json(launches4),
        "bitwise_equal_to_d1": same_baskets(r4, r1),
        "timed_runs_bitwise_equal": same_baskets(r4_any, r1_any)})
    check(same_baskets(r4, r1) and r4_info == r1_info, "7b: D=4 differs from D=1 on Eat")
    check(same_baskets(r4_any, r1_any) and same_baskets(r1_any, r1),
          "7b: the timed ring runs differ in bits")
    return [launches, launches4], r1


def ring_scale(big, smi: str) -> list:
    """Phase 7c: two half-sweeps (tol -1) on phase 3's 1M-node graph at D=1
    and D=4 virtual shards: bitwise equal;
    the flat hub rows (wider than the kernel, so through the sort
    pipeline); walls and peak memory against the full basket."""
    from approximated_personalized_pagerank_tpu_torch import make_mesh
    from approximated_personalized_pagerank_tpu_torch.ops.merge_kernel import MAX_KERNEL_WIDTH
    from approximated_personalized_pagerank_tpu_torch.parallel.ring import (
        build_ring_plan,
        ring_grank_baskets,
    )

    card = torch.device("cuda", 0)
    plans = [build_ring_plan(big, p, 1, L, algo="kernel") for p in (0, 1)]
    flat = sum(int((b.rows < big.num_nodes).sum()) for p in plans for r in p.rounds
               for b in r if b.cap * L + 1 > MAX_KERNEL_WIDTH)
    out, all_launches = {}, []
    for d in (1, 4):
        clear_counts()
        (b, info), wall = timed(lambda: ring_grank_baskets(
            big, K, L, 2, DAMPING, -1.0, mesh=make_mesh(d, [card] * d),
            analyze_memory=True))
        all_launches.append(read_counts())
        out[d] = b
        mem = info["memory"]
        emit_ring(f"c: ring D={d} at 1M nodes", smi, {
            "graph": "powerlaw(1e6, 1e7, seed=7, locality=0.8)", "half_sweeps": 2,
            "wall_s": wall,
            "iterations_ran": info["iterations_ran"], "rounds": ring_rounds(big, d, L, (0, 1)),
            "flat_hub_rows_through_sort": flat, "shard_bytes_planned": mem["shard_bytes"],
            "full_basket_bytes": mem["full_basket_bytes"],
            "peak_bytes": mem["device_peak_bytes"][str(card)],
            "kernel_launches": launches_json(all_launches[-1])})
        check(info["iterations_ran"] == 2, "7c: the 1M ring did not run 2 half-sweeps")
        check(bool(torch.isfinite(b.scores).all()), "7c: non-finite scores at 1M")
    check(flat > 0, "7c: no flat hub row at 1M nodes")
    check(same_baskets(out[1], out[4]), "7c: D=4 differs from D=1 at 1M nodes")
    return all_launches


def ring_mc(eat, smi: str) -> list:
    """Phase 7d: Eat MC (K=50, L=200, R=1000, seed 1) through
    ``mccompletepathv2_multi_baskets`` on 2 virtual shards: bitwise equal
    to the D=1 ring combine of the
    unsharded walks; the sharded walks bitwise equal to the unsharded ones
    at the same chunk size; quality.  Returns the call's launches."""
    from approximated_personalized_pagerank_tpu_torch import (
        benchmark_sampled,
        make_mesh,
        mccompletepathv2_multi_baskets,
        sample_result,
        walk_baskets,
    )
    from approximated_personalized_pagerank_tpu_torch.ops import walk as tw
    from approximated_personalized_pagerank_tpu_torch.parallel.ring import ring_mc_combine

    card = torch.device("cuda", 0)
    mesh1, mesh2 = make_mesh(1, [card]), make_mesh(2, [card] * 2)
    chunk = tw._trace_chunks(eat.num_nodes, MC_R, DAMPING, None, None, MC_UNROLL)[0]
    check(tw._sharded_trace_chunks(eat.num_nodes, MC_R, DAMPING, None, None, MC_UNROLL, 2)[0]
          == chunk, "7d: the sharded and unsharded walk chunks differ on Eat")
    clear_counts()
    multi, wall = timed(lambda: mccompletepathv2_multi_baskets(
        eat, MC_K, MC_L, MC_R, DAMPING, 2, seed=1, devices=[card] * 2))
    launches = read_counts()
    (w2, w2_info), w2_s = timed(lambda: walk_baskets(eat, MC_L, MC_R, DAMPING, seed=1,
                                                     mesh=mesh2, return_info=True))
    (w1, w1_info), w1_s = timed(lambda: walk_baskets(eat, MC_L, MC_R, DAMPING, seed=1,
                                                     return_info=True))
    one, one_s = timed(lambda: ring_mc_combine(eat, w1, MC_K, MC_L, DAMPING, 2, mesh=mesh1))
    (q,) = benchmark_sampled([sample_result(multi, eat, 200, True, seed=0)], eat, mesh=mesh2)
    emit_ring("d: MC on Eat, 2 virtual shards", smi, {
        "K": MC_K, "L": MC_L, "R": MC_R, "walk_chunk": chunk, "wall_s": wall,
        "sharded_walks_s": w2_s, "unsharded_walks_s": w1_s, "d1_ring_combine_s": one_s,
        "walk_steps": w1_info["walk_steps"], "rounds": ring_rounds(eat, 2, MC_L, (None,)),
        "kernel_launches": launches_json(launches),
        "walks_bitwise_equal": same_baskets(w1, w2) and w1_info == w2_info,
        "bitwise_equal_to_d1_ring": same_baskets(multi, one),
        "jaccard_average": q["jaccard average"], "recall_average": q["recall average"],
        "kendall_average": q["kendall average"]})
    check(same_baskets(w1, w2) and w1_info == w2_info, "7d: sharded walks differ")
    check(same_baskets(multi, one), "7d: sharded MC differs from the D=1 ring")
    check(q["jaccard average"] >= 0.94, "7d: sharded MC jaccard_average < 0.94")
    return [launches]


def ring_oracle(eat, smi: str) -> None:
    """Phase 7e: the oracle for 64 Eat sources (strict, seed 0) on 4
    virtual shards against the unsharded oracle."""
    from approximated_personalized_pagerank_tpu_torch import make_mesh, ppr_single_source_batch

    rng = np.random.default_rng(0)
    sources = rng.permutation(np.nonzero(eat.out_degree > 0)[0])[:64]
    mesh4 = make_mesh(4, [torch.device("cuda", 0)] * 4)
    plain, plain_s = timed(lambda: ppr_single_source_batch(eat, sources, 100, DAMPING, 1e-4))
    sharded, sharded_s = timed(lambda: ppr_single_source_batch(eat, sources, 100, DAMPING, 1e-4,
                                                               mesh=mesh4))
    err = float((plain - sharded).abs().max())
    emit_ring("e: the oracle on 4 virtual shards", smi, {
        "sources": 64, "unsharded_s": plain_s, "sharded_s": sharded_s, "max_abs_err": err})
    check(err <= 1e-6, f"7e: the sharded oracle is {err} from the unsharded one")


def ring_nccl(eat, d1, smi: str) -> list:
    """Phase 7f: the process-group path at world size 1 over NCCL: the ring
    on Eat equal to 7a's, its convergence max
    through ``all_reduce`` once a half-sweep.  Returns its launches."""
    import socket

    import torch.distributed as dist

    from approximated_personalized_pagerank_tpu_torch import grank_baskets, make_mesh
    from approximated_personalized_pagerank_tpu_torch.parallel.mesh import init_distributed

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    t0 = time.perf_counter()
    init_distributed(f"127.0.0.1:{port}", 1, 0)
    try:
        init_s = time.perf_counter() - t0
        mesh = make_mesh()
        check(mesh.group is not None and mesh.n_shards == 1, "7f: no process-group mesh")
        backend = dist.get_backend(mesh.group)
        clear_counts()
        (out, info), wall = timed(lambda: grank_baskets(
            eat, K, L, ITERS, DAMPING, TOL, mesh=mesh, return_info=True))
        launches = read_counts()
    finally:
        dist.destroy_process_group()
    emit_ring("f: process group of 1 over NCCL", smi, {
        "backend": backend, "init_s": init_s, "wall_s": wall,
        "iterations_ran": info["iterations_ran"], "all_reduce_calls": info["iterations_ran"],
        "bitwise_equal_to_7a": same_baskets(out, d1)})
    check(backend == "nccl", f"7f: backend {backend}, not nccl")
    check(same_baskets(out, d1), "7f: the NCCL ring differs from 7a's")
    return [launches]


def ring_cli(smi: str) -> None:
    """Phase 7g: ``ppr-torch --algorithm grank_multi --n-shards 1`` saves
    baskets equal to a direct call; with one card
    ``--n-shards 2`` raises "exceeds available devices"."""
    import io
    import os

    from approximated_personalized_pagerank_tpu_torch import (
        grank_multi_baskets,
        load_baskets,
        load_csv_graph,
        sample_graph_path,
    )
    from approximated_personalized_pagerank_tpu_torch.cli import main as cli_main

    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "cli_ring_baskets.npz")
    args = ["--algorithm", "grank_multi", "--no-eval", "--save", path]
    with contextlib.redirect_stdout(io.StringIO()):
        rc, cli_s = timed(lambda: cli_main(args + ["--n-shards", "1"]))
        direct = grank_multi_baskets(load_csv_graph(sample_graph_path()), K, L, ITERS, DAMPING,
                                     TOL, 1)
    check(rc == 0, f"7g: the CLI exited {rc}")
    loaded, _ = load_baskets(path)
    equal = same_baskets(loaded, direct)
    raised = None
    if torch.cuda.device_count() == 1:
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                cli_main(args + ["--n-shards", "2"])
        except ValueError as e:
            raised = str(e)
    emit_ring("g: the CLI's grank_multi", smi, {
        "cli_s": cli_s, "bitwise_equal_to_direct_call": equal, "n_shards_2_raised": raised})
    check(equal, "7g: the CLI's ring baskets differ from a direct call")
    check(torch.cuda.device_count() > 1 or (raised or "").startswith(
        "n_shards=2 exceeds available devices (1)"), "7g: --n-shards 2 did not raise on one card")


def run_sums_repeat(smi: str) -> None:
    """Phase 7h: the sort pipeline of ``_merge_rows`` (rows of 16,384
    candidates, wider than the kernel, and rows of 201, narrower than the
    network width), ``merge_topl_plain`` and ``norm1_rows`` run three times
    each on one card input with runs of three or more equal ids: identical
    bits every time, with no deterministic mode (the run sums are a
    segmented scan of elementwise ops, ops/basket.py::run_sums)."""
    from approximated_personalized_pagerank_tpu_torch.ops import basket as tb
    from approximated_personalized_pagerank_tpu_torch.ops import merge as tm
    from approximated_personalized_pagerank_tpu_torch.ops import merge_kernel as mk

    rng = np.random.default_rng(7)
    out = {}
    for w, id_hi in ((16384, 300), (201, 20)):
        ids_np = rng.integers(0, id_hi, (512, w)).astype(np.int32)
        ids_np[rng.random((512, w)) < 0.2] = -1
        sc_np = np.where(ids_np >= 0, rng.random((512, w)) / w, 0).astype(np.float32)
        ids, sc = torch.as_tensor(ids_np, device="cuda"), torch.as_tensor(sc_np, device="cuda")
        longest = int(torch.unique_consecutive(torch.sort(ids[0]).values,
                                               return_counts=True)[1][1:].max())
        merged = [tm._merge_rows(ids, sc, L, "kernel") for _ in range(3)]
        half = len(merged[0].ids) // 2
        a = tb.Baskets(merged[0].ids[:half], merged[0].scores[:half])
        b = tb.Baskets(merged[0].ids[half:], merged[0].scores[half:])
        l1 = [tb.norm1_rows(a, b) for _ in range(3)]
        # the matrix entry's input: the first 8192 columns at most, padded
        # to a power of two as the kernel pipeline pads a row
        p_ids, p_sc = mk.pad_candidates(ids[:, :mk.MAX_KERNEL_WIDTH],
                                        sc[:, :mk.MAX_KERNEL_WIDTH], 128)
        plain = [mk.merge_topl_plain(p_ids, p_sc, 128) for _ in range(3)]
        same = (all(same_baskets(m, merged[0]) for m in merged)
                and all(torch.equal(x.view(torch.int32), l1[0].view(torch.int32)) for x in l1)
                and all(same_bits(x, plain[0]) for x in plain))
        out[f"W{w}"] = {"rows": 512, "longest_live_run": longest, "repeats": 3,
                        "sort_pipeline": not tm._takes_kernel("kernel", w),
                        "identical_bits": same}
        check(longest >= 3, f"7h: W={w} has no run of three equal ids")
        check(same, f"7h: W={w}: repeated run sums differ in bits")
    emit_ring("h: run sums repeat bitwise", smi, out)


def phase_ring(big, smi: str) -> list:
    """Phase 7: the sharded paths (7a-7g), and its wall.  D > 1 runs as
    virtual shards on the one card.  Returns the main path runs' launches."""
    from approximated_personalized_pagerank_tpu_torch import load_eat_graph

    t0 = time.perf_counter()
    eat = load_eat_graph()
    runs, d1 = ring_eat(eat, smi)
    runs += ring_scale(big, smi)
    runs += ring_mc(eat, smi)
    ring_oracle(eat, smi)
    runs += ring_nccl(eat, d1, smi)
    ring_cli(smi)
    run_sums_repeat(smi)
    emit_ring("all", smi, {"wall_s": time.perf_counter() - t0})
    check(all(sum(r["fused_merge_topl"].values()) > 0 for r in runs),
          "a ring run launched no matrix entry")
    return runs


def emit_examples(part: str, smi: str, obj: dict) -> None:
    emit({"phase": 8, "part": part, "nvidia_smi": smi, **obj})


def load_script(*path: str):
    """A script of the repository (its path under the root) as a module."""
    import importlib.util
    import os

    full = os.path.join(os.path.dirname(os.path.abspath(__file__)), *path)
    spec = importlib.util.spec_from_file_location(os.path.basename(full)[:-3], full)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_example(name: str):
    """An example driver of the port (examples/<name>.py) as a module."""
    return load_script("examples", f"{name}.py")


def load_bench():
    """bench_torch.py, the port's counterpart of bench.py, as a module."""
    return load_script("bench_torch.py")


def native_loader(big, smi: str) -> None:
    """Phase 8a: the native loader built from the port's own source; its
    parse of Eat (decompressed to a plain file) and its 2-colouring of Eat
    and of phase 3's 1M-node graph byte-equal to the numpy versions, each
    colouring timed on both paths (the CSC built beforehand)."""
    import gzip
    import os

    from approximated_personalized_pagerank_tpu_torch import eat_graph_path, load_csv_graph
    from approximated_personalized_pagerank_tpu_torch.utils import io as tio

    t0 = time.perf_counter()
    check(tio.native_available(), "8a: the native loader did not build")
    build_s = time.perf_counter() - t0
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "eat.csv")
    with gzip.open(eat_graph_path(), "rb") as f:
        data = f.read()
    with open(path, "wb") as f:
        f.write(data)
    (src, dst), parse_s = timed(lambda: tio.parse_edge_csv(path))
    parser = tio.paths_ran()["parse_edge_csv"]
    ref_src, ref_dst = tio._parse_bytes(data, path)
    parse_equal = src.tobytes() == ref_src.tobytes() and dst.tobytes() == ref_dst.tobytes()
    graph = load_csv_graph(path)
    colour, colour_s = timed(lambda: graph.partition)
    colourer = tio.paths_ran()["bfs_bipartition"]
    plain, plain_s = timed(graph._bfs_bipartition)
    csc = big.csc
    big_native, big_native_s = timed(lambda: tio.native_bfs_bipartition(
        big.indptr, big.indices, *csc))
    big_plain, big_plain_s = timed(big._bfs_bipartition)
    big_equal = big_native.tobytes() == big_plain.tobytes()
    emit_examples("a: the native loader on Eat", smi, {
        "library_build_s": build_s, "parser": parser, "parse_s": parse_s, "edges": int(src.size),
        "parse_byte_equal_to_numpy": parse_equal, "colouring": colourer,
        "colouring_s": colour_s, "numpy_colouring_s": plain_s,
        "colouring_byte_equal_to_numpy": colour.tobytes() == plain.tobytes(),
        "1M_colouring_s": big_native_s, "1M_numpy_colouring_s": big_plain_s,
        "1M_colouring_byte_equal_to_numpy": big_equal})
    check(parser == "native" and colourer == "native", "8a: a numpy path ran, not the native one")
    check(parse_equal, "8a: the native parse of Eat differs from numpy's")
    check(colour.tobytes() == plain.tobytes(), "8a: the native colouring of Eat differs")
    check(big_equal, "8a: the native colouring of the 1M graph differs")


def example_eat(smi: str) -> dict:
    """Phase 8b: examples/run_eat_torch.py at full Eat scale (GRank 30
    half-sweeps, MC R=1000, 200 strict sources).  Returns its launches."""
    mod = load_example("run_eat_torch")
    printed = []
    clear_counts()
    res, wall = timed(lambda: mod.run_eat(device="cuda", out=printed.append))
    launches = read_counts()
    g, m = res["grank"], res["mccompletepathv2"]
    emit_examples("b: run_eat_torch on Eat", smi, {
        "wall_s": wall, "grank": g, "mccompletepathv2": m,
        "kernel_launches": launches_json(launches), "printed": printed})
    check(g["jaccard average"] >= 0.90 and g["recall average"] >= 0.94,
          "8b: run_eat's GRank quality is below phase 2's bounds")
    check(m["jaccard average"] >= 0.94, "8b: run_eat's MC jaccard_average < 0.94")
    return launches


def example_synthetic(smi: str) -> dict:
    """Phase 8c: examples/run_synthetic_torch.py at 200,000 nodes and 2M
    edges (its default is 1M / 10M, which phases 3 and 5 cover)."""
    mod = load_example("run_synthetic_torch")
    clear_counts()
    res, wall = timed(lambda: mod.run_synthetic(200_000, 2_000_000, 4, device="cuda",
                                                out=lambda *_: None))
    launches = read_counts()
    emit_examples("c: run_synthetic_torch, 200k nodes", smi, {
        "wall_s": wall, **res, "kernel_launches": launches_json(launches)})
    check(res["half_sweeps"] == 4 and res["merges_per_s"] > 0, "8c: no half-sweeps")
    check(res["abandoned_walks"] <= 0.01 * res["total_walks"], "8c: over 1% of walks abandoned")
    return launches


def example_sharded(smi: str) -> dict:
    """Phase 8d: examples/run_sharded_torch.py on 4 virtual shards at
    100,000 nodes (its default size; 8 shards there)."""
    mod = load_example("run_sharded_torch")
    clear_counts()
    res, wall = timed(lambda: mod.run_sharded(4, 100_000, 1_000_000, device="cuda",
                                              out=lambda *_: None))
    launches = read_counts()
    baskets, mc = res.pop("baskets"), res.pop("mc")
    emit_examples("d: run_sharded_torch, 4 virtual shards", smi, {
        "wall_s": wall, **res, "kernel_launches": launches_json(launches)})
    check(bool(torch.isfinite(baskets.scores).all()) and bool(torch.isfinite(mc.scores).all()),
          "8d: non-finite sharded scores")
    check(res["non_empty_baskets"] == 100_000, "8d: empty ring baskets")
    return launches


def example_bench_ring(smi: str) -> dict:
    """Phase 8e: examples/bench_ring_torch.py at D = 1, 2, 4, 8 virtual
    shards, 100,000 nodes, 2 half-sweeps (its default: 200,000, 4)."""
    mod = load_example("bench_ring_torch")
    printed = []
    clear_counts()
    rows, wall = timed(lambda: mod.bench_ring(100_000, 1_000_000, 2, device="cuda",
                                              out=printed.append))
    launches = read_counts()
    emit_examples("e: bench_ring_torch, virtual shards", smi, {
        "wall_s": wall, "rows": rows, "note": mod.NOTE,
        "kernel_launches": launches_json(launches)})
    check([r["shards"] for r in rows] == [1, 2, 4, 8], "8e: missing shard counts")
    check(all(r["iterations_ran"] == 2 for r in rows), "8e: a ring did not run 2 half-sweeps")
    return launches


def north_star(smi: str) -> dict:
    """Phase 8f: the north star, bench_torch.py::bench_scale_full, which
    runs examples/run_scale_torch.py::run_scale at full size (4.8M nodes, 69M edges, locality 0.8; GRank K=50, L=100, 30
    half-sweeps, tol 1e-4; MC mc_l=100, R=200; 32 strict sources), each
    stage's line forwarded as it ends, the timed GRank's and MC's with
    their tied rows.  Held to the TPU run on the same graph up to tie
    noise.  Then, on its graph, the walk kernel against the plain loop at
    MC's first source chunk (walk_kernel_timing).  Returns its launches."""
    bench = load_bench()
    stages = {}

    def forward(line: str) -> None:
        stage = json.loads(line)
        if stage["stage"] in ("grank", "mc"):
            stage["tied_rows"] = read_tie_counts()
        if stage["stage"] in ("grank_warmup", "grank"):
            start_tie_counts()
        stages[stage["stage"]] = stage
        emit_examples("f: north star stage", smi, stage)

    clear_counts()
    keep = {}
    out, wall = timed(lambda: bench.bench_scale_full("cuda", log=forward, digests=True,
                                                     keep=keep))
    launches = read_counts()
    # outside the window: the walk kernel against the plain loop at MC's
    # first source chunk on the north star's own graph
    walk = walk_kernel_timing(keep.pop("graph"), out["scale_full_mc_r"],
                              stages["mc"]["mc_seed"])
    torch.cuda.empty_cache()
    emit_examples("f: walk kernel at the north star's first chunk", smi, walk)
    emit_examples("f: north star", smi, {
        "wall_s": wall, **out, "tpu_v5e_mc_jaccard": TPU_V5E_MC_JACCARD,
        "peak_allocated_bytes": {
            k: v["peak_allocated_bytes"] for k, v in stages.items()},
        "kernel_launches": launches_json(launches)})
    check((out["scale_full_nodes"], out["scale_full_edges"]) == (4_800_000, 69_000_000),
          "8f: the north star ran below full size")
    check(out["scale_full_iterations"] >= 1, "8f: GRank ran no half-sweep")
    check(stages["prep"]["native_partition"], "8f: the 2-colouring did not run natively")
    check(out["scale_full_jaccard"] >= 0.966, "8f: GRank jaccard < 0.966")
    check(out["scale_full_recall"] >= 0.978, "8f: GRank recall < 0.978")
    check(out["scale_full_mc_jaccard"] >= 0.930, "8f: MC jaccard < 0.930")
    check(out["scale_full_mc_abandoned_frac"] <= 0.01, "8f: over 1% of MC walks abandoned")
    return launches


def phase_examples(big, smi: str) -> list:
    """Phase 8: the native loader and the example drivers on the card, the
    north star last.  Returns the drivers' launches."""
    t0 = time.perf_counter()
    native_loader(big, smi)
    runs = [example_eat(smi), example_synthetic(smi), example_sharded(smi),
            example_bench_ring(smi), north_star(smi)]
    emit_examples("all", smi, {"wall_s": time.perf_counter() - t0})
    return runs


def phase_bench(eat_digest: str, smi: str) -> dict:
    """Phase 9: bench_torch.py's quick blocks on the card, as its main runs
    them (bench_eat, bench_dense_eat, bench_ring, bench_scale; MC and the
    scale block cut to one timed run).  Checks its keys against bench.py's
    (read from bench.py's source), the Eat GRank baskets' digest against
    phase 2's (the same config: auto is sparse on Eat), the ring's ids
    against the sparse engine's, phase 2's and 4's quality bounds, and that
    both entries were launched.  Returns the launches."""
    from approximated_personalized_pagerank_tpu_torch.utils.compare import basket_sha256

    bench = load_bench()
    keep = {}
    clear_counts()
    t0 = time.perf_counter()
    extra = bench.kernel_build("cuda")
    graph, dataset = bench.load_graph()
    elapsed, eat = bench.bench_eat(graph, dataset, "cuda", mc_repeats=1, keep=keep)
    extra.update(eat)
    extra.update(bench.bench_dense_eat(graph, "cuda"))
    extra.update(bench.bench_ring(graph, sparse_wall_s=elapsed, device="cuda"))
    extra.update(bench.bench_scale("cuda", repeats=1))
    wall = time.perf_counter() - t0
    launches = read_counts()
    result = bench.result_json(elapsed, extra)
    keys, want = set(result) | set(extra), bench.expected_keys()
    digest = basket_sha256(keep["grank"])
    emit({"phase": 9, "nvidia_smi": smi, "wall_s": wall, "bench": result,
          "missing_keys": sorted(want - keys), "unexpected_keys": sorted(keys - want),
          "grank_sha256": digest, "kernel_launches": launches_json(launches)})
    check(keys == want, "9: bench_torch.py's keys differ from bench.py's under its mapping")
    check(result["value"] > 0, "9: no Eat GRank wall")
    check(digest == eat_digest, "9: the Eat GRank baskets differ from phase 2's")
    check(extra["ring_ids_identical_to_sparse"], "9: ring ids differ from the sparse engine's")
    check(extra["jaccard_average"] >= 0.90, "9: Eat GRank jaccard_average < 0.90")
    check(extra["recall_average"] >= 0.94, "9: Eat GRank recall_average < 0.94")
    check(extra["mc_jaccard_average"] >= 0.94, "9: Eat MC jaccard_average < 0.94")
    for name, c in launches.items():
        check(sum(c.values()) > 0, f"9: {name} was not launched")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    name, count, smi = phase_device()
    max_err, g_err, timings = phase_kernel()
    eat_launches, eat_digest = phase_eat()
    scale_launches, big = phase_scale()
    mc_launches, mc_errs, walk_ms = phase_mc()
    walk_launches = phase_walk_scale(big)
    dense_launches = phase_dense(smi)
    ring_launches = phase_ring(big, smi)
    example_launches = phase_examples(big, smi)
    del big
    bench_launches = phase_bench(eat_digest, smi)
    # the main paths' runs
    runs = [eat_launches, scale_launches, mc_launches, walk_launches, dense_launches,
            *ring_launches, *example_launches, bench_launches]
    launches = {k: sum(sum(r[k].values()) for r in runs) for k in runs[0]}
    for k, n in launches.items():
        check(n > 0, f"{k} was not launched on the main path")
    max_err, g_err = max(max_err, mc_errs["fused_merge_topl"]), max(g_err, mc_errs["gather_merge_topl"])
    matrix = timings[0]  # Eat's widest chunk, W=8192, C=517
    gather = next(t for t in timings  # Eat's widest bucket, one launch
                  if t["entry"] == "gather" and t["C"] == EAT_BUCKETS[0][1])
    emit({"total_wall_s": time.perf_counter() - t_start})
    emit({"kernels": [
        {"name": name_, "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": REPLACES, "launches": launches[name_], "max_abs_err": err,
         "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
         "bound_by": t["bound_by"], "library_ms": None}
        for name_, err, t in (("fused_merge_topl", max_err, matrix),
                              ("gather_merge_topl", g_err, gather))
    ] + [{"name": "walk_cohort", "route": "cuda", "source": WALK_SOURCE,
          "replaces": None, "launches": launches["walk_cohort"],
          "max_abs_err": walk_ms["max_abs_err"],
          "ms": walk_ms["ms"], "plain_ms": walk_ms["plain_ms"],
          "bound_ms": walk_ms["bound_ms"], "bound_by": walk_ms["bound_by"],
          "library_ms": None}]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
