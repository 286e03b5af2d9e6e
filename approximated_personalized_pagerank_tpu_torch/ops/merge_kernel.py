"""The fused basket merge: per row, sort by id, sum equal-id runs, keep the
top ``l_pad`` by score.

The port of the TPU kernel ``fused_merge_topl`` of the JAX package
(``ops/pallas/merge_kernel.py``).  One CUDA C++ source for Hopper
(``csrc/merge_topl.cu``, ``sm_90a``), built with ``nvcc`` at first use into
``build/kernels/`` beside the package and bound through ``ctypes``, has two
entry points over one device-side core:

* :func:`fused_merge_topl`, the matrix entry: rows of a ``[C, W]``
  candidate matrix (the init sweep, the hub tree-reduce levels);
* :func:`gather_merge_topl`, the gather entry: each row's candidates are
  built inside the kernel from the successors' baskets, so the ``[C, W]``
  matrix never reaches device memory (GRank's half-sweeps, the hub group
  level).

Each has a plain PyTorch version, :func:`merge_topl_plain` and
:func:`gather_merge_topl_plain`: what runs for CPU tensors, and what the
kernel is held against on the card.  A wrapper picks by the device of its
input: the plain version for a CPU tensor, the kernel for a CUDA tensor (a
failed build or launch raises; nothing falls back).  Each counts its kernel
launches by ``(W, l_pad)`` in its ``launches`` attribute; a CUDA graph's
replays count the launches it captured (:func:`capture_counts`).

Contract of the matrix entry: ``ids``/``scores`` are ``[C, W]``, W a power
of two in [2, 8192], ids int32 with dead slots ``PAD_ID`` (no negative
ids), scores float32.  Returns ``[C, l_pad]`` ids (-1 padding) and scores
(0 padding), rows sorted by descending score; ``l_pad`` is a power of two
``<= W``.  A run of PAD ids is dropped, and dead slots rank below every
live one, so a live score of 0 (damping 1) survives.

The function, stated once.  The TPU kernel sorts each row by id (W slots,
PAD last; W is the matrix entry's width, or the gather entry's candidate
count padded to a power of two and to at least ``l_pad``, as
:func:`pad_candidates` and the JAX package's ``_merge_rows`` pad it), sums
each run of equal ids into the run's last slot, and runs
``bitonic_prune_topk`` (its ``ops/bitonic.py:205``) on that row of (total
at the run-end position p, -inf elsewhere): a network that compares scores
alone, with strict < and >.  Both entries and both plain versions return
what that network returns: the same ids, the same scores and the same
order.  p = (slots with id <= the run's id) - 1 depends only on the row's
multiset of ids (negative ids count as PAD), so the output does not depend
on the order of a row's candidates.  Where no two survivors share a total
and the cut falls between distinct totals, this is simply the top
``l_pad`` by descending score; only tied rows depend on the rule.  The
port's sort pipeline (``ops/basket.py::keep_top``) keeps ``lax.top_k``'s
rule instead, as the JAX package's does.

Bits: where the run sums are exact (visit counts, dyadic scores) the
kernel, the plain versions and the TPU kernel agree bitwise in ids, scores
and order.  Elsewhere each decides ties on its own sums: the kernel sums a
run in the order of its score bits (bitwise deterministic), the plain
versions in candidate order, the TPU kernel by a prefix scan; these differ
in the last bits (``utils/compare.py::topl_max_error``).
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import os
from typing import Optional, Tuple

import torch

from ._cuda_build import PKG_DIR, build_shared_object
from .basket import (
    SENTINEL, Baskets, run_ends, run_sums, sort_rows_by_id,
)

# Id of a dead slot: sorts after every live id.
PAD_ID = 2**31 - 1
# Widest row the kernel takes: W (id, score) pairs fill 8*W bytes of
# shared memory, 64 KB at 8192.  Fixes the plan layout too
# (ops/merge.net_max_width), so it equals the JAX package's width cap.
MAX_KERNEL_WIDTH = 8192

KERNEL_SOURCE = os.path.join(PKG_DIR, "csrc", "merge_topl.cu")

_LIB = None


def load_library() -> ctypes.CDLL:
    """Build (once per source version, :func:`build_shared_object`) and load
    the kernel library."""
    global _LIB
    if _LIB is not None:
        return _LIB
    so_path = build_shared_object(KERNEL_SOURCE, "libppr_merge_topl")
    lib = ctypes.CDLL(so_path)
    lib.ppr_merge_topl.restype = ctypes.c_int
    lib.ppr_merge_topl.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.ppr_gather_merge_topl.restype = ctypes.c_int
    lib.ppr_gather_merge_topl.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.ppr_cuda_error_string.restype = ctypes.c_char_p
    lib.ppr_cuda_error_string.argtypes = [ctypes.c_int]
    _LIB = lib
    return lib


def _exchange(ids: torch.Tensor, keys: torch.Tensor, j: int, desc: torch.Tensor):
    """One compare-exchange stage at distance ``j`` on ``[C, W]`` rows: slot
    i (bit j clear) against i + j, the larger key to i where ``desc[i]``,
    the smaller elsewhere.  Equal keys never swap."""
    c, w = keys.shape
    k4 = keys.view(c, w // (2 * j), 2, j)
    i4 = ids.view(c, w // (2 * j), 2, j)
    lo, hi = k4[:, :, 0], k4[:, :, 1]
    swap = torch.where(desc.view(w // (2 * j), 2, j)[:, 0], lo < hi, lo > hi)
    keys = torch.stack([torch.where(swap, hi, lo), torch.where(swap, lo, hi)], dim=2)
    ids = torch.stack([torch.where(swap, i4[:, :, 1], i4[:, :, 0]),
                       torch.where(swap, i4[:, :, 0], i4[:, :, 1])], dim=2)
    return ids.view(c, w), keys.view(c, w)


def bitonic_prune_topk(
    ids: torch.Tensor, keys: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The TPU kernel's top-k network on ``[C, W]`` rows (W and k powers of
    two, k <= W; ``keys`` -inf in dead slots): the first k slots of each
    row in the network's order, descending, ties where the network leaves
    them.

    k = W: a bitonic sort, descending.  Else k-blocks are sorted ascending
    and descending in turn; then, log2(W/k) times, each pair of blocks
    keeps the larger of each two slots k apart (the first block's on a tie)
    and the survivors, a bitonic sequence, are merged back into blocks of
    alternating direction, descending in the last round."""
    c, w = keys.shape
    pos = torch.arange(w, device=keys.device)
    if k == w:
        size = 2
        while size <= w:
            j = size // 2
            while j >= 1:
                ids, keys = _exchange(ids, keys, j, (pos & size) == 0)
                j //= 2
            size *= 2
        return ids, keys
    size = 2
    while size <= k:
        j = size // 2
        while j >= 1:
            ids, keys = _exchange(ids, keys, j, (pos & size) != 0)
            j //= 2
        size *= 2
    while w > k:
        k4 = keys.view(c, w // (2 * k), 2, k)
        i4 = ids.view(c, w // (2 * k), 2, k)
        take = k4[:, :, 1] > k4[:, :, 0]
        keys = torch.where(take, k4[:, :, 1], k4[:, :, 0]).reshape(c, w // 2)
        ids = torch.where(take, i4[:, :, 1], i4[:, :, 0]).reshape(c, w // 2)
        w //= 2
        desc = (pos[:w] & k) != 0 if w > k else torch.ones_like(pos[:w], dtype=torch.bool)
        j = k // 2
        while j >= 1:
            ids, keys = _exchange(ids, keys, j, desc)
            j //= 2
    return ids, keys


def merge_topl_plain(
    ids: torch.Tensor, scores: torch.Tensor, l_pad: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch (same contract): the TPU
    kernel's three steps (module doc)."""
    ids = torch.where(ids < 0, torch.full_like(ids, PAD_ID), ids)
    ids_s, sc_s = sort_rows_by_id(ids, scores)
    # each live run's total at its last slot; + 0.0 makes a -0.0 total +0.0,
    # as the TPU kernel's scan does
    live = run_ends(ids_s) & (ids_s != PAD_ID)
    totals = run_sums(ids_s, sc_s) + 0.0
    keys = torch.where(live, totals, torch.full_like(totals, float("-inf")))
    out_ids, top = bitonic_prune_topk(ids_s, keys, l_pad)
    top_live = top > float("-inf")
    out_ids = torch.where(top_live, out_ids, torch.full_like(out_ids, -1))
    return out_ids, torch.where(top_live, top, torch.zeros_like(top))


def _check(ids: torch.Tensor, scores: torch.Tensor, l_pad: int) -> None:
    if ids.dim() != 2 or ids.shape != scores.shape:
        raise ValueError(
            f"ids and scores must be [C, W] of one shape, got "
            f"{tuple(ids.shape)} and {tuple(scores.shape)}"
        )
    if ids.dtype != torch.int32 or scores.dtype != torch.float32:
        raise TypeError(
            f"ids must be int32 and scores float32, got {ids.dtype}, {scores.dtype}"
        )
    w = ids.shape[1]
    if w < 2 or w > MAX_KERNEL_WIDTH or w & (w - 1):
        raise ValueError(
            f"W must be a power of two in [2, {MAX_KERNEL_WIDTH}], got {w}"
        )
    if l_pad < 1 or l_pad > w or l_pad & (l_pad - 1):
        raise ValueError(f"l_pad must be a power of two <= W, got {l_pad}")
    if scores.device != ids.device:
        raise ValueError("ids and scores must be on one device")


def fused_merge_topl(
    ids: torch.Tensor, scores: torch.Tensor, l_pad: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row-wise merge + top-``l_pad`` of candidate lists (see module doc)."""
    _check(ids, scores, l_pad)
    if ids.device.type == "cpu":
        return merge_topl_plain(ids, scores, l_pad)
    if ids.device.type != "cuda":
        raise ValueError(f"unsupported device {ids.device}")
    lib = load_library()
    ids = ids.contiguous()
    scores = scores.contiguous()
    c, w = ids.shape
    out_ids = torch.empty((c, l_pad), dtype=torch.int32, device=ids.device)
    out_scores = torch.empty((c, l_pad), dtype=torch.float32, device=ids.device)
    if c == 0:
        return out_ids, out_scores
    ties = _tie_counter("fused_merge_topl", c, ids.device)
    with torch.cuda.device(ids.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.ppr_merge_topl(
            ctypes.c_void_p(ids.data_ptr()),
            ctypes.c_void_p(scores.data_ptr()),
            ctypes.c_void_p(out_ids.data_ptr()),
            ctypes.c_void_p(out_scores.data_ptr()),
            c, w, l_pad, ctypes.c_void_p(None if ties is None else ties.data_ptr()),
            ctypes.c_void_p(stream),
        )
    _raise_on_error(lib, err, f"merge_topl [{c}, {w}] -> {l_pad}")
    fused_merge_topl.launches[(w, l_pad)] += 1
    return out_ids, out_scores


def _raise_on_error(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(
            f"{what}: launch failed: "
            f"{lib.ppr_cuda_error_string(err).decode()} (CUDA error {err})"
        )


def next_pow2(x: int) -> int:
    return 1 << (x - 1).bit_length()


def pad_candidates(
    ids: torch.Tensor, scores: torch.Tensor, l_pad: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Candidate rows [C, W] with -1 dead slots -> the matrix entry's
    input: dead ids become PAD_ID and rows are padded with dead slots to
    ``max(next_pow2(W), l_pad)``."""
    w = ids.shape[-1]
    w2 = max(next_pow2(w), l_pad)
    ids = torch.where(ids < 0, torch.full_like(ids, PAD_ID), ids)
    if w2 > w:
        ids = torch.nn.functional.pad(ids, (0, w2 - w), value=PAD_ID)
        scores = torch.nn.functional.pad(scores, (0, w2 - w))
    return ids, scores


def gather_successors(
    basket_ids: torch.Tensor, basket_scores: torch.Tensor, succ: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Successor baskets of each row, flattened: [R, D*Lb] ids and scores;
    a -1 successor or a dead basket slot gives (-1, 0)."""
    r = succ.shape[0]
    valid = succ >= 0
    safe = succ.clamp(min=0)
    cand_ids = basket_ids[safe]  # [R, D, Lb]
    cand_scores = basket_scores[safe]
    slot_valid = valid[..., None] & (cand_ids >= 0)
    cand_ids = torch.where(slot_valid, cand_ids, torch.full_like(cand_ids, SENTINEL))
    cand_scores = torch.where(slot_valid, cand_scores, torch.zeros_like(cand_scores))
    return cand_ids.reshape(r, -1), cand_scores.reshape(r, -1)


def gather_merge_topl_plain(
    basket_ids: torch.Tensor,
    basket_scores: torch.Tensor,
    succ: torch.Tensor,
    rows: Optional[torch.Tensor],
    scale: torch.Tensor,
    self_scores: Optional[torch.Tensor],
    post_scale: Optional[torch.Tensor],
    L: int,
    l_pad: int,
) -> Baskets:
    """The gather entry's function in plain PyTorch: the candidate gather,
    the matrix entry's plain version and the post-scale, in that order."""
    ids, scores = gather_successors(basket_ids, basket_scores, succ)
    scores = scores * scale[:, None]
    if self_scores is not None:
        ids = torch.cat([ids, rows[:, None].to(torch.int32)], dim=-1)
        scores = torch.cat([scores, self_scores[:, None]], dim=-1)
    out_ids, out_scores = merge_topl_plain(*pad_candidates(ids, scores, l_pad), l_pad)
    out_ids, out_scores = out_ids[:, :L], out_scores[:, :L]
    if post_scale is not None:
        out_scores = out_scores * post_scale[:, None]
    return Baskets(out_ids, out_scores)


def _check_gather(basket_ids, basket_scores, succ, rows, scale, self_scores,
                  post_scale, L, l_pad) -> int:
    """Checks the gather entry's arguments; returns the candidate width."""
    if basket_ids.dim() != 2 or basket_ids.shape != basket_scores.shape:
        raise ValueError(
            f"basket ids and scores must be [N, Lb] of one shape, got "
            f"{tuple(basket_ids.shape)} and {tuple(basket_scores.shape)}"
        )
    if basket_ids.dtype != torch.int32 or basket_scores.dtype != torch.float32:
        raise TypeError(
            f"basket ids must be int32 and scores float32, got "
            f"{basket_ids.dtype}, {basket_scores.dtype}"
        )
    if succ.dim() != 2 or succ.dtype != torch.int64:
        raise TypeError(f"succ must be int64 [C, D], got {succ.dtype} {tuple(succ.shape)}")
    c = succ.shape[0]
    if self_scores is not None and rows is None:
        raise ValueError("a self entry needs rows")
    per_row = {"scale": scale, "rows": rows, "self_scores": self_scores,
               "post_scale": post_scale}
    for name, x in per_row.items():
        if x is None:
            continue
        want = torch.int64 if name == "rows" else torch.float32
        if x.shape != (c,) or x.dtype != want:
            raise TypeError(
                f"{name} must be {want} [{c}], got {x.dtype} {tuple(x.shape)}"
            )
        if x.device != succ.device:
            raise ValueError(f"{name} must be on the device of succ")
    if basket_ids.device != succ.device or basket_scores.device != succ.device:
        raise ValueError("baskets and succ must be on one device")
    w = succ.shape[1] * basket_ids.shape[1] + (self_scores is not None)
    if w < 1 or next_pow2(w) > MAX_KERNEL_WIDTH:
        raise ValueError(
            f"candidate width {w} must lie in [1, {MAX_KERNEL_WIDTH}]"
        )
    if l_pad < 1 or l_pad > MAX_KERNEL_WIDTH or l_pad & (l_pad - 1):
        raise ValueError(f"l_pad must be a power of two <= {MAX_KERNEL_WIDTH}, got {l_pad}")
    if L < 1 or L > l_pad:
        raise ValueError(f"L must lie in [1, l_pad={l_pad}], got {L}")
    return w


def gather_merge_topl(
    basket_ids: torch.Tensor,
    basket_scores: torch.Tensor,
    succ: torch.Tensor,
    rows: Optional[torch.Tensor],
    scale: torch.Tensor,
    self_scores: Optional[torch.Tensor],
    post_scale: Optional[torch.Tensor],
    L: int,
    l_pad: int,
) -> Baskets:
    """Merged top-``L`` of each row's successor baskets (the gather entry).

    Row c's candidates are the live entries (id >= 0) of the baskets
    ``basket_ids/basket_scores[succ[c, d]]`` of its valid successors
    (``succ >= 0``), scores times ``scale[c]``, and the self entry
    ``(rows[c], self_scores[c])`` unless ``self_scores`` is None (the hub
    group level).  Returns Baskets ``[C, L]``: the first L of the row's
    top ``l_pad`` after the merge, scores times ``post_scale[c]`` (None:
    1).  Needs ``D*Lb (+1) <= 8192`` and ``L <= l_pad``.
    """
    w = _check_gather(basket_ids, basket_scores, succ, rows, scale,
                      self_scores, post_scale, L, l_pad)
    if succ.device.type == "cpu":
        return gather_merge_topl_plain(basket_ids, basket_scores, succ, rows,
                                       scale, self_scores, post_scale, L, l_pad)
    if succ.device.type != "cuda":
        raise ValueError(f"unsupported device {succ.device}")
    lib = load_library()
    c, d = succ.shape
    out_ids = torch.empty((c, L), dtype=torch.int32, device=succ.device)
    out_scores = torch.empty((c, L), dtype=torch.float32, device=succ.device)
    if c == 0:
        return Baskets(out_ids, out_scores)
    basket_ids = basket_ids.contiguous()
    basket_scores = basket_scores.contiguous()
    succ = succ.contiguous()
    scale = scale.contiguous()
    # keep the contiguous copies referenced until the launch is enqueued
    opt = [None if x is None else x.contiguous() for x in (rows, self_scores, post_scale)]

    def ptr(x):
        return ctypes.c_void_p(None if x is None else x.data_ptr())

    ties = _tie_counter("gather_merge_topl", c, succ.device)
    with torch.cuda.device(succ.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.ppr_gather_merge_topl(
            ptr(basket_ids), ptr(basket_scores), basket_ids.shape[0],
            basket_ids.shape[1], ptr(succ), d, ptr(opt[0]), ptr(scale),
            ptr(opt[1]), ptr(opt[2]), ptr(out_ids), ptr(out_scores),
            c, L, l_pad, ptr(ties), ctypes.c_void_p(stream),
        )
    w2 = max(next_pow2(w), l_pad)
    _raise_on_error(lib, err, f"gather_merge_topl [{c}, {w}] -> {l_pad}")
    gather_merge_topl.launches[(w2, l_pad)] += 1
    return Baskets(out_ids, out_scores)


# Kernel launches by (W, l_pad), W the row's padded width; callers reset
# them with .clear().
fused_merge_topl.launches = collections.Counter()
gather_merge_topl.launches = collections.Counter()


def launch_count() -> int:
    """Kernel launches of both entries so far, over every shape."""
    return sum(fused_merge_topl.launches.values()) + sum(gather_merge_topl.launches.values())


# While counting is on: by entry, [rows launched, {device: int64[6]}], the
# kernel's counters of the rows that took its prune network (step 4d of
# csrc/merge_topl.cu): the first when the cut split a run of equal totals,
# the second when only survivors repeated a total; then the same rows by
# their live count m (the totals at or above the cut, which the network
# moves), in LIVE_BUCKETS.
_tie_counts: Optional[dict] = None
# The m histogram's buckets.
LIVE_BUCKETS = ("m<=128", "m<=512", "m<=2048", "m>2048")


def count_tied_rows(on: bool = True) -> None:
    """Start counting the kernel's tied rows from zero (``on``), or stop.
    Off by default: on, each launch passes the kernel its counters, and
    each tied row adds one atomically."""
    global _tie_counts
    _tie_counts = {} if on else None


def tied_row_counts() -> dict:
    """By entry, since :func:`count_tied_rows`: ``rows`` launched,
    ``split`` (tied rows whose cut split a run of equal totals),
    ``repeat_only`` (tied rows whose survivors alone repeated a total) and
    ``live_hist``, the tied rows by their live count m (:data:`LIVE_BUCKETS`).
    Reads the card's counters, so it waits for their launches."""
    out = {}
    for name, (rows, counters) in (_tie_counts or {}).items():
        if rows == 0:  # counters made for a capture whose graph never ran
            continue
        total = [sum(x) for x in zip(*(buf.tolist() for buf in counters.values()))]
        out[name] = {"rows": rows, "split": total[0], "repeat_only": total[1],
                     "live_hist": dict(zip(LIVE_BUCKETS, total[2:]))}
    return out


def _tie_counter(entry: str, rows: int, device: torch.device) -> Optional[torch.Tensor]:
    """The counters a launch of ``rows`` rows passes its kernel, or None
    when counting is off."""
    if _tie_counts is None:
        return None
    seen = _tie_counts.setdefault(entry, [0, {}])
    seen[0] += rows
    if device not in seen[1]:
        seen[1][device] = torch.zeros(2 + len(LIVE_BUCKETS), dtype=torch.int64, device=device)
    return seen[1][device]


_ENTRIES = {"fused_merge_topl": fused_merge_topl, "gather_merge_topl": gather_merge_topl}


def _counts() -> dict:
    """By entry: its launches by shape, and its rows counted for ties."""
    return {name: (collections.Counter(f.launches),
                   _tie_counts[name][0] if _tie_counts and name in _tie_counts else 0)
            for name, f in _ENTRIES.items()}


@contextlib.contextmanager
def capture_counts(device: torch.device):
    """Around a CUDA graph's capture on ``device``.  A capture launches
    nothing, so on exit what it added to the launch counters and to the
    tied rows is taken back and left in the yielded dict, for
    :func:`replay_counts` to add at each replay.  While tied rows are
    counted, their counters on ``device`` are made here, before the
    capture: the graph's kernels then add into them at every replay."""
    if _tie_counts is not None:
        for name in _ENTRIES:
            _tie_counter(name, 0, device)
    before = _counts()
    rise = {}
    try:
        yield rise
    finally:
        for name, now in _counts().items():
            launches, rows = before[name]
            rise[name] = (now[0] - launches, now[1] - rows)
            _ENTRIES[name].launches.clear()
            _ENTRIES[name].launches.update(launches)
            if _tie_counts is not None and name in _tie_counts:
                _tie_counts[name][0] = rows


def replay_counts(rise: dict) -> None:
    """Count one replay of a graph whose capture yielded ``rise``."""
    for name, (launches, rows) in rise.items():
        _ENTRIES[name].launches.update(launches)
        if rows and _tie_counts is not None:
            _tie_counts.setdefault(name, [0, {}])[0] += rows
