"""The Edinburgh Associative Thesaurus, read from the bundled edge list.

The file is parsed here as the reference driver's ``importGraph`` reads it
(src/main.cc:78-112): one ``a,b`` pair of integers a line, duplicate edges
dropped (first occurrence kept), nodes numbered by first appearance (the
source before the target on a line).  Seed 0 keeps those labels; any other
seed moves every label but the lowest by a permutation drawn from it: the
same graph up to isomorphism, under ids that change the order of every
tie and of the rows in each bucket, and the same work.  The program's
2-colouring is BFS-level parity from the lowest id of each weakly
connected component; Eat is one component, and its lowest id stays on the
same node, so every seed gets the same partition, buckets and launches.
"""

from __future__ import annotations

import gzip

import numpy as np
import torch

from . import Edges, seed64


def parse(data: bytes):
    """(src, dst) int64 arrays, deduplicated and densified (module doc)."""
    vals = np.array(data.translate(bytes.maketrans(b",\r", b"  ")).split(), dtype=np.int64)
    if vals.size % 2:
        raise ValueError("odd number of integers in the edge list")
    pairs = np.ascontiguousarray(vals.reshape(-1, 2))
    view = pairs.view([("s", np.int64), ("d", np.int64)]).reshape(-1)
    _, first = np.unique(view, return_index=True)
    pairs = pairs[np.sort(first)]
    flat = pairs.reshape(-1)  # source before target on each line
    uniq, first_at = np.unique(flat, return_index=True)
    rank = np.empty(uniq.size, dtype=np.int64)
    rank[np.argsort(first_at, kind="stable")] = np.arange(uniq.size)
    dense = rank[np.searchsorted(uniq, flat)].reshape(-1, 2)
    return int(uniq.size), dense[:, 0].copy(), dense[:, 1].copy()


def data_path() -> str:
    from approximated_personalized_pagerank_tpu_torch import eat_graph_path

    return eat_graph_path()


def make(spec: dict, seed: int, device) -> Edges:
    with gzip.open(data_path(), "rb") as f:
        n, src, dst = parse(f.read())
    if (spec.get("nodes"), spec.get("edges")) != (n, src.size):
        raise ValueError(f"the edge list has {n} nodes and {src.size} edges, "
                         f"the configuration says {spec.get('nodes')} and {spec.get('edges')}")
    src_t, dst_t = torch.from_numpy(src), torch.from_numpy(dst)
    if seed:
        gen = torch.Generator().manual_seed(seed64(seed))
        perm = torch.cat([torch.zeros(1, dtype=torch.int64),
                          1 + torch.randperm(n - 1, generator=gen)])
        src_t, dst_t = perm[src_t], perm[dst_t]
    return Edges(n, src_t, dst_t)
