"""Edge-list CSV parsing and the native host helpers.

The reference driver's ``importGraph`` input format (src/main.cc:78-112):
one ``node1,node2`` integer pair per line, tolerant of ``\\r\\n`` endings.

Plain files go through the native parser ``ppr_parse_edge_csv`` of
``native/ingest.cc``, which g++ builds at first use into ``build/native/``
beside the package (named after a digest of the source, so an edited source
is rebuilt) and ctypes loads; the same library holds the 2-colouring that
``Graph.partition`` runs (``ppr_bfs_bipartition``).  Gzipped (``.gz``)
files are parsed by one vectorised numpy pass, :func:`_parse_bytes`, which
is also the native parse's plain version.

Where the library cannot be built, both fall back to their numpy versions
with a warning; :func:`native_available` says whether it loads, and
:func:`paths_ran` which path the last parse and the last colouring took.
"""

from __future__ import annotations

import ctypes
import gzip
import hashlib
import os
import shutil
import subprocess
import tempfile
import warnings
from typing import Dict, Optional, Tuple

import numpy as np

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE_SOURCE = os.path.join(_PKG_DIR, "native", "ingest.cc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "native")
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-Wall")

# ppr_parse_edge_csv's error codes: the exception and its message
_PARSE_ERRORS = {
    -1: (OSError, "{path!r}: cannot be read"),
    -2: (ValueError, "{path!r}: more edges than the parse buffer holds"),
    -3: (ValueError, "{path!r}: odd number of integers in edge CSV"),
    -4: (ValueError, "{path!r}: a token is not an int64"),
}

_LIB: Optional[ctypes.CDLL] = None
_BUILD_ERROR: Optional[str] = None
_RAN: Dict[str, Optional[str]] = {"parse_edge_csv": None, "bfs_bipartition": None}


def load_native() -> ctypes.CDLL:
    """Build (once per source version) and load the native library; raises
    RuntimeError when it cannot be built."""
    global _LIB
    if _LIB is not None:
        return _LIB
    with open(NATIVE_SOURCE, "rb") as f:
        src = f.read()
    digest = hashlib.sha256(src + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    so_path = os.path.join(BUILD_DIR, f"libppr_ingest_{digest}.so")
    if not os.path.exists(so_path):
        cxx = os.environ.get("CXX") or shutil.which("g++")
        if cxx is None:
            raise RuntimeError("g++ not found: the native loader cannot be built")
        os.makedirs(BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            proc = subprocess.run(
                [cxx, *CXX_FLAGS, "-o", tmp, NATIVE_SOURCE],
                capture_output=True, text=True,
            )
            if proc.returncode != 0:
                raise RuntimeError(
                    f"{cxx} failed ({proc.returncode}) on {NATIVE_SOURCE}:\n"
                    f"{proc.stdout}{proc.stderr}"
                )
            os.replace(tmp, so_path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    lib = ctypes.CDLL(so_path)
    lib.ppr_parse_edge_csv.restype = ctypes.c_longlong
    lib.ppr_parse_edge_csv.argtypes = [
        ctypes.c_char_p, ctypes.c_void_p, ctypes.c_longlong,
    ]
    lib.ppr_bfs_bipartition.restype = None
    lib.ppr_bfs_bipartition.argtypes = [ctypes.c_int64] + [ctypes.c_void_p] * 5
    _LIB = lib
    return lib


def native_available() -> bool:
    """Whether the native library builds and loads.  The first failure is
    kept and warned about once; later calls do not retry the build."""
    global _BUILD_ERROR
    if _LIB is not None:
        return True
    if _BUILD_ERROR is not None:
        return False
    try:
        load_native()
        return True
    except (RuntimeError, OSError) as e:
        _BUILD_ERROR = str(e)
        warnings.warn(
            f"native loader unavailable, the numpy versions run: {e}",
            RuntimeWarning, stacklevel=2,
        )
        return False


def paths_ran() -> Dict[str, Optional[str]]:
    """Which path the last edge-list parse and the last 2-colouring took:
    ``"native"``, ``"numpy"``, or None before the first."""
    return dict(_RAN)


def note_path(kind: str, path: str) -> None:
    """Record that ``path`` ran for ``kind`` (see :func:`paths_ran`)."""
    _RAN[kind] = path


def native_bfs_bipartition(
    indptr: np.ndarray, indices: np.ndarray, cindptr: np.ndarray, cindices: np.ndarray
) -> np.ndarray:
    """The 2-colouring through ``ppr_bfs_bipartition`` (int32 CSR and CSC);
    the library must be available."""
    lib = load_native()
    n = indptr.shape[0] - 1
    color = np.empty(n, dtype=np.uint8)
    arrays = [np.ascontiguousarray(a, dtype=np.int32)
              for a in (indptr, indices, cindptr, cindices)]
    lib.ppr_bfs_bipartition(n, *(a.ctypes.data for a in arrays), color.ctypes.data)
    note_path("bfs_bipartition", "native")
    return color


def parse_edge_csv(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Parse ``n1,n2`` lines into (src, dst) int64 arrays (duplicates kept).

    ``.gz`` paths are decompressed in memory (the bundled Eat dataset ships
    gzipped) and parsed by numpy; plain files by the native parser.
    """
    if path.endswith(".gz"):
        with gzip.open(path, "rb") as f:
            data = f.read()
    elif native_available():
        return _parse_native(path)
    else:
        with open(path, "rb") as f:
            data = f.read()
    note_path("parse_edge_csv", "numpy")
    return _parse_bytes(data, path)


def _parse_native(path: str) -> Tuple[np.ndarray, np.ndarray]:
    # A record takes at least 4 bytes ("a,b" and a separator), the last 3.
    cap = os.path.getsize(path) // 4 + 1
    buf = np.empty((cap, 2), dtype=np.int64)
    n = load_native().ppr_parse_edge_csv(os.fsencode(path), buf.ctypes.data, cap)
    if n < 0:
        exc, msg = _PARSE_ERRORS[n]
        raise exc(msg.format(path=path))
    note_path("parse_edge_csv", "native")
    return buf[:n, 0].copy(), buf[:n, 1].copy()


def _parse_bytes(data: bytes, path: str) -> Tuple[np.ndarray, np.ndarray]:
    if not data:
        return np.empty(0, dtype=np.int64), np.empty(0, dtype=np.int64)
    # Commas and CR become whitespace, then one split yields all integers.
    table = bytes.maketrans(b",\r", b"  ")
    vals = np.array(data.translate(table).split(), dtype=np.int64)
    if vals.size % 2 != 0:
        raise ValueError(f"{path!r}: odd number of integers in edge CSV")
    pairs = vals.reshape(-1, 2)
    return pairs[:, 0].copy(), pairs[:, 1].copy()
