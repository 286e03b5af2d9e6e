"""Edge-list CSV parsing.

The reference driver's ``importGraph`` input format (src/main.cc:78-112):
one ``node1,node2`` integer pair per line, tolerant of ``\\r\\n`` endings.
Plain and gzipped (``.gz``) files are parsed by one vectorised numpy pass,
with no per-line Python loop.
"""

from __future__ import annotations

import gzip
from typing import Tuple

import numpy as np


def parse_edge_csv(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Parse ``n1,n2`` lines into (src, dst) int64 arrays (duplicates kept).

    ``.gz`` paths are decompressed in memory (the bundled Eat dataset ships
    gzipped).
    """
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        return _parse_bytes(f.read(), path)


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
