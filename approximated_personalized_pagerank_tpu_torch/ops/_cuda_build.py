"""Building the port's CUDA C++ sources: ``nvcc`` for Hopper (``sm_90a``)
into ``build/kernels/`` beside the package, one shared object per source
version, which each kernel's wrapper loads through ``ctypes`` at its first
use (``ops/merge_kernel.py``, ``ops/walk_kernel.py``)."""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import tempfile

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), "build", "kernels")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def build_shared_object(source: str, stem: str) -> str:
    """Build ``source`` with ``NVCC_FLAGS`` into ``BUILD_DIR`` (once per
    source version) and return the shared object's path.

    The shared object is named ``stem`` and a digest of the source and
    flags, so an edited source is rebuilt; the build writes a temporary
    file and renames it, so a concurrent loader never sees half a library.
    """
    with open(source, "rb") as f:
        src = f.read()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    so_path = os.path.join(BUILD_DIR, f"{stem}_{digest}.so")
    if not os.path.exists(so_path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            proc = subprocess.run(
                [nvcc(), *NVCC_FLAGS, "-o", tmp, source],
                capture_output=True, text=True,
            )
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}) on {source}:\n"
                    f"{proc.stdout}{proc.stderr}"
                )
            os.replace(tmp, so_path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    return so_path
