"""The fused basket merge: per row, sort by id, sum equal-id runs, keep the
top ``l_pad`` by score.

The port of the TPU kernel ``fused_merge_topl`` of the JAX package
(``ops/pallas/merge_kernel.py``).  Two implementations of one contract:

* :func:`merge_topl_plain`, plain PyTorch (stable sort, segment sums,
  -inf masking, ``topk``): what runs for CPU tensors, and what the CUDA
  kernel is held against on the card;
* ``csrc/merge_topl.cu``, a CUDA C++ kernel for Hopper (``sm_90a``), built
  with ``nvcc`` at first use into ``build/kernels/`` beside the package and
  bound through ``ctypes``.

:func:`fused_merge_topl` picks by the device of its input: the plain
version for a CPU tensor, the kernel for a CUDA tensor (a failed build or
launch raises; nothing falls back).  It counts its kernel launches by
``(W, l_pad)`` in ``fused_merge_topl.launches``.

Contract: ``ids``/``scores`` are ``[C, W]``, W a power of two in
[2, 8192], ids int32 with dead slots ``PAD_ID`` (no negative ids), scores
float32.  Returns ``[C, l_pad]`` ids (-1 padding) and scores (0 padding),
rows sorted by descending score; ``l_pad`` is a power of two ``<= W``.  A
run of PAD ids is dropped, and dead slots rank below every live one, so a
live score of 0 (damping 1) survives.  Ties (equal scores at the cut, and
the summation order inside a run) may resolve differently in the two
implementations.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from typing import Tuple

import torch

from .basket import run_index, sort_rows_by_id

# Id of a dead slot: sorts after every live id.
PAD_ID = 2**31 - 1
# Widest row the kernel takes: W (id, score) pairs fill 8*W bytes of
# shared memory, 64 KB at 8192.  Fixes the plan layout too
# (ops/merge.net_max_width), so it equals the JAX package's width cap.
MAX_KERNEL_WIDTH = 8192

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNEL_SOURCE = os.path.join(_PKG_DIR, "csrc", "merge_topl.cu")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "kernels")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_LIB = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the merge kernel cannot be built")
    return path


def load_library() -> ctypes.CDLL:
    """Build (once per source version) and load the kernel library.

    The shared object is named after a digest of the source and flags, so
    an edited source is rebuilt; the build writes a temporary file and
    renames it, so a concurrent loader never sees half a library.
    """
    global _LIB
    if _LIB is not None:
        return _LIB
    with open(KERNEL_SOURCE, "rb") as f:
        src = f.read()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    so_path = os.path.join(BUILD_DIR, f"libppr_merge_topl_{digest}.so")
    if not os.path.exists(so_path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", tmp, KERNEL_SOURCE],
                capture_output=True, text=True,
            )
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}) on {KERNEL_SOURCE}:\n"
                    f"{proc.stdout}{proc.stderr}"
                )
            os.replace(tmp, so_path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    lib = ctypes.CDLL(so_path)
    lib.ppr_merge_topl.restype = ctypes.c_int
    lib.ppr_merge_topl.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.ppr_cuda_error_string.restype = ctypes.c_char_p
    lib.ppr_cuda_error_string.argtypes = [ctypes.c_int]
    _LIB = lib
    return lib


def merge_topl_plain(
    ids: torch.Tensor, scores: torch.Tensor, l_pad: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch (same contract)."""
    ids_s, sc_s = sort_rows_by_id(ids, scores)
    run = run_index(ids_s)
    # one slot per run, in id order; slots past the row's run count stay PAD
    run_ids = torch.full_like(ids_s, PAD_ID).scatter_(-1, run, ids_s)
    run_sc = torch.zeros_like(sc_s).scatter_add_(-1, run, sc_s)
    live = (run_ids >= 0) & (run_ids != PAD_ID)
    key = torch.where(live, run_sc, torch.full_like(run_sc, float("-inf")))
    top_key, top_pos = torch.topk(key, l_pad, dim=-1, largest=True, sorted=True)
    top_live = top_key > float("-inf")
    out_ids = torch.where(
        top_live, torch.gather(run_ids, -1, top_pos), torch.full_like(top_pos, -1)
    ).to(torch.int32)
    out_scores = torch.where(top_live, top_key, torch.zeros_like(top_key))
    return out_ids, out_scores


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
    with torch.cuda.device(ids.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.ppr_merge_topl(
            ctypes.c_void_p(ids.data_ptr()),
            ctypes.c_void_p(scores.data_ptr()),
            ctypes.c_void_p(out_ids.data_ptr()),
            ctypes.c_void_p(out_scores.data_ptr()),
            c, w, l_pad, ctypes.c_void_p(stream),
        )
    if err != 0:
        raise RuntimeError(
            f"merge_topl launch failed for [{c}, {w}] -> {l_pad}: "
            f"{lib.ppr_cuda_error_string(err).decode()} (CUDA error {err})"
        )
    fused_merge_topl.launches[(w, l_pad)] += 1
    return out_ids, out_scores


# Kernel launches by (W, l_pad); callers reset it with .clear().
fused_merge_topl.launches = collections.Counter()
