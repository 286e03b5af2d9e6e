"""The walk cohort kernel: one launch walks a whole source chunk of the
trace engine on the card.

``csrc/walk_cohort.cu`` (``sm_90a``) is built with ``nvcc`` at its first
use into ``build/kernels/`` (``ops/_cuda_build.py``) and bound
through ``ctypes``; importing this module builds and loads nothing.  It
computes ``ops/walk.py::walk_trace_chunk``'s plain loop bit for bit (the
same threefry draws, the same hops, the same trace and abandoned walks);
a warp walks a source row, its slots on the lanes, and a row whose walks
are all done stops early (the source's notes).  ``walk_trace_chunk``
launches it for a CUDA tensor and runs the plain loop for a CPU tensor.

:func:`walk_cohort` counts its launches in its ``launches`` attribute.
"""

from __future__ import annotations

import ctypes
import os
from typing import Tuple

import torch

from ..utils.prng import Key, _words
from ._cuda_build import PKG_DIR, build_shared_object

KERNEL_SOURCE = os.path.join(PKG_DIR, "csrc", "walk_cohort.cu")
# Lanes of a warp: a source row's slots.
MAX_SLOTS = 32

_LIB = None


def load_library() -> ctypes.CDLL:
    """Build (once per source version) and load the kernel library."""
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = ctypes.CDLL(build_shared_object(KERNEL_SOURCE, "libppr_walk_cohort"))
    lib.ppr_walk_cohort.restype = ctypes.c_int
    lib.ppr_walk_cohort.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_uint32,
        ctypes.c_uint32, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.ppr_walk_error_string.restype = ctypes.c_char_p
    lib.ppr_walk_error_string.argtypes = [ctypes.c_int]
    _LIB = lib
    return lib


def _check(start_deg, indices, sources, damping, slots: int, macro_steps: int,
           unroll: int) -> None:
    dev = sources.device
    if dev.type != "cuda":
        raise ValueError(f"the walk kernel runs on a CUDA device, got {dev}")
    for name, x in (("start_deg", start_deg), ("indices", indices), ("damping", damping)):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, the sources on {dev}")
    for name, x in (("start_deg", start_deg), ("indices", indices), ("sources", sources)):
        if x.dtype != torch.int64:
            raise TypeError(f"{name} must be int64, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if start_deg.dim() != 2 or start_deg.shape[1] != 2:
        raise ValueError(f"start_deg must be [n, 2], got {tuple(start_deg.shape)}")
    if indices.dim() != 1 or sources.dim() != 1:
        raise ValueError("indices and sources must be 1-d")
    if damping.dtype != torch.float32 or damping.dim() != 0:
        raise TypeError(f"damping must be a float32 0-d tensor, got {damping.dtype} "
                        f"of shape {tuple(damping.shape)}")
    if not 1 <= slots <= MAX_SLOTS:
        raise ValueError(f"the walk kernel takes 1 to {MAX_SLOTS} slots, got {slots}")
    if macro_steps < 0 or unroll < 1:
        raise ValueError(f"need macro_steps >= 0 and unroll >= 1, got {macro_steps}, {unroll}")


def walk_cohort(
    start_deg: torch.Tensor,  # int64[n, 2]: (indptr[v], out_degree[v])
    indices: torch.Tensor,  # int64[E], E > 0
    sources: torch.Tensor,  # int64[C]
    key: Key,
    damping: torch.Tensor,  # float32 0-d
    total: int,
    slots: int,
    macro_steps: int,
    unroll: int,
    stratified: bool = False,
    rows: Tuple[int, int] | None = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``walk_trace_chunk``'s ``(trace, abandoned)`` for a chunk on the
    card, and the most macro steps any of its rows began (an int64 0-d
    tensor on the device: the plain loop's count of macro steps walked).
    Arguments as ``walk_trace_chunk``'s; enqueued on the current stream,
    nothing is read back."""
    _check(start_deg, indices, sources, damping, slots, macro_steps, unroll)
    c = sources.shape[0]
    offset, row_total = rows if rows is not None else (0, c)
    k1, k2 = (int(w) for w in _words(key))
    lib = load_library()
    dev = sources.device
    trace = torch.empty((c, macro_steps * unroll * slots), dtype=torch.int32, device=dev)
    info = torch.empty(c + 1, dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.ppr_walk_cohort(
            ctypes.c_void_p(start_deg.data_ptr()), ctypes.c_void_p(indices.data_ptr()),
            ctypes.c_void_p(sources.data_ptr()), ctypes.c_void_p(damping.data_ptr()),
            c, slots, macro_steps, unroll, total, int(stratified), offset, row_total,
            k1, k2, ctypes.c_void_p(trace.data_ptr()), ctypes.c_void_p(info.data_ptr()),
            ctypes.c_void_p(stream),
        )
    if err != 0:
        raise RuntimeError(
            f"walk_cohort [{c}, {slots}] x {macro_steps * unroll}: launch failed: "
            f"{lib.ppr_walk_error_string(err).decode()} (CUDA error {err})"
        )
    walk_cohort.launches += 1
    return trace, info[:c], info[c]


# Kernel launches so far; callers reset it with ``walk_cohort.launches = 0``.
walk_cohort.launches = 0
