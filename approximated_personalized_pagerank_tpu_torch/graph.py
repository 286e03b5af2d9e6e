"""Graph representation: CSR adjacency plus the host-side merge plans.

A graph is a CSR adjacency over dense internal ids ``[0, N)``:

* ``indptr  : int32[N+1]`` row offsets
* ``indices : int32[E]``   successor (column) ids

External node keys (any hashable, the reference library's templated
``Key``) are densified to internal ids at ingest; the vocabulary is kept so
results can be mapped back.

Also computed here, once per graph and on the host (numpy):

* the approximate 2-colouring used by GRank's partition-alternating sweeps
  (semantics of the reference's ``findPartitions``,
  include/internal/pprInternal.h:30-99): BFS over the undirected closure,
  component roots in partition 0, each BFS frontier alternating partitions;
* a degree-bucketed ELL plan per partition for the batched basket merge:
  nodes grouped by rounded-up out-degree, successors padded into dense
  ``[rows, cap]`` matrices.

The graph also caches its CSR on each device it is asked for, in the
walker's layout (:meth:`Graph.device_graph`).

Plans and partitions are byte-equal to those of the JAX package, so both
packages sweep the same rows in the same buckets.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import (
    Any, Dict, Hashable, Iterable, List, Mapping, NamedTuple, Sequence, Tuple,
)

import numpy as np
import torch

__all__ = [
    "Graph", "DeviceGraph", "EllBucket", "MergePlan", "load_csv_graph",
    "MAX_BUCKET_ROWS",
]

# Sentinel for "no node" in padded index matrices / basket slots.
SENTINEL = -1

# Max rows per ELL bucket.  A bucket's merged [rows, L] output exists in
# full before it is scattered into the basket tensors (ops/merge.merge_sweep);
# 2^18 rows bound that buffer at ~2 * L * 2^18 * 4 B (~210 MB at L=100).
# Part of the plan layout, so it matches the JAX package's value.
MAX_BUCKET_ROWS = 1 << 18


class DeviceGraph(NamedTuple):
    """The CSR adjacency on one device, in the walker's layout."""

    start_deg: torch.Tensor  # int64[N, 2]: (indptr[v], out_degree[v])
    indices: torch.Tensor  # int64[E]


@dataclasses.dataclass(frozen=True)
class EllBucket:
    """A group of nodes with out-degree in (cap/2, cap], successors padded to cap.

    ``rows`` holds internal node ids; ``succ`` is ``int32[len(rows), cap]``
    padded with ``SENTINEL``.
    """

    cap: int
    rows: np.ndarray  # int32[C]
    succ: np.ndarray  # int32[C, cap]


@dataclasses.dataclass(frozen=True)
class MergePlan:
    """Degree-bucketed ELL layout for one partition of the graph.

    ``dangling_rows`` are the partition's out-degree-0 nodes: their merged
    basket is always exactly ``{v: 1 - damping}`` (reference
    include/grank.h:100-101 with an empty successor loop).
    """

    buckets: Tuple[EllBucket, ...]
    dangling_rows: np.ndarray  # int32[D]


def _bucket_cap(x: np.ndarray) -> np.ndarray:
    """Elementwise bucket capacity: quarter-octave rounding.

    Degrees are rounded up to {1, 2, 3, 4, 5, 6, 7, 8, 10, 12, 14, 16, 20,
    24, 28, 32, ...}: the next multiple of 2^(k-2) within each octave
    [2^k, 2^(k+1)).  Bounds ELL padding waste at ~20% while keeping the
    bucket count O(4 log maxdeg).
    """
    x = np.maximum(x.astype(np.int64), 1)
    k = np.floor(np.log2(x)).astype(np.int64)
    quarter = np.maximum(1 << np.maximum(k - 2, 0), 1)
    return ((x + quarter - 1) // quarter) * quarter


def _width_aligned_cap_table(
    L: int, min_width: int = 256, max_width: int = 8192
) -> np.ndarray:
    """Bucket caps aligned to the merge kernel's power-of-two widths.

    The kernel pipeline pads each candidate row of width ``cap*L+1`` up to a
    power of two (ops/merge.py).  When ``L`` is known, caps are chosen so
    ``cap*L+1`` lands just under each power of two: no pow2 waste and one
    bucket per octave.  Returns the ascending cap table covering degrees up
    to ``(max_width-1)//L``; below the network threshold the caps follow
    quarter-octave rounding.
    """
    caps: List[int] = []
    c = 1
    while c * L + 1 < min_width:  # below the network threshold: sort path
        caps.append(c)
        c = int(_bucket_cap(np.asarray([c + 1]))[0])
    wpow = min_width
    while wpow <= max_width:
        cap = (wpow - 1) // L
        if cap >= 1 and (not caps or cap > caps[-1]):
            caps.append(cap)
        wpow *= 2
    return np.asarray(caps, dtype=np.int64)


def _assign_caps(
    deg: np.ndarray, L: int | None, net_width: int | None = None
) -> np.ndarray:
    """Per-node bucket capacity: width-aligned when the merge width L is
    known (see _width_aligned_cap_table), quarter-octave otherwise.

    With ``net_width`` (the kernel's width cap, ops/merge.net_max_width),
    degrees beyond the largest aligned cap ``sub`` get caps that are
    multiples of ``sub``: such buckets are merged hierarchically in groups
    of ``sub`` successors (ops/merge._hub_merge_chunk).
    """
    base = _bucket_cap(deg)
    if L is None:
        return base
    table = _width_aligned_cap_table(
        L, max_width=net_width if net_width else 8192
    )
    if not table.size:
        return base
    idx = np.searchsorted(table, deg)
    snapped = table[np.minimum(idx, table.size - 1)]
    if net_width:
        sub = int(table[-1])
        groups = _bucket_cap(-(-deg // max(sub, 1)))
        return np.where(deg <= table[-1], snapped, groups * sub)
    return np.where(deg <= table[-1], snapped, base)


class Graph:
    """Directed graph in CSR form with an external-key vocabulary.

    Every node is present, even one with no outgoing edges.  Parallel edges
    are representable (GRank accumulates them, reference
    include/grank.h:79-80); the CSV loader drops duplicates like the
    reference driver (src/main.cc:101-107).
    """

    def __init__(
        self,
        indptr: np.ndarray,
        indices: np.ndarray,
        keys: Sequence[Hashable] | None = None,
    ):
        indptr = np.asarray(indptr, dtype=np.int32)
        indices = np.asarray(indices, dtype=np.int32)
        if indptr.ndim != 1 or indices.ndim != 1:
            raise ValueError("indptr and indices must be 1-D")
        n = int(indptr.shape[0]) - 1
        if n < 0:
            raise ValueError("indptr must have at least one entry")
        if indptr[0] != 0 or (n > 0 and indptr[-1] != indices.shape[0]):
            raise ValueError("malformed CSR indptr")
        if indices.size and (indices.min() < 0 or indices.max() >= n):
            raise ValueError("CSR indices out of range")
        self.indptr = indptr
        self.indices = indices
        self.num_nodes = n
        self.num_edges = int(indices.shape[0])
        self.out_degree = np.diff(indptr).astype(np.int32)
        if keys is not None:
            if len(keys) != n:
                raise ValueError("keys must have one entry per node")
            self._keys: List[Hashable] | None = list(keys)
            self._key_to_id: Dict[Hashable, int] | None = {
                k: i for i, k in enumerate(self._keys)
            }
        else:
            self._keys = None
            self._key_to_id = None
        self._csc: Tuple[np.ndarray, np.ndarray] | None = None
        self._partition: np.ndarray | None = None
        self._plans: Dict[Any, MergePlan] = {}
        self._device_graphs: Dict[str, DeviceGraph] = {}
        # sparse GRank's captured half-sweeps on the card, kept between
        # calls (models/grank.py::_SweepGraphs); the lock is held for a call
        self._sweep_graphs = None
        self._sweep_lock = threading.Lock()

    # ------------------------------------------------------------------ vocab
    @property
    def keys(self) -> List[Hashable]:
        """External keys by internal id (identity ints if none given)."""
        if self._keys is None:
            return list(range(self.num_nodes))
        return self._keys

    def key_to_id(self, key: Hashable) -> int:
        if self._key_to_id is None:
            i = int(key)
            if not (0 <= i < self.num_nodes):
                raise KeyError(key)
            return i
        return self._key_to_id[key]

    def id_to_key(self, i: int) -> Hashable:
        if self._keys is None:
            return int(i)
        return self._keys[i]

    def __contains__(self, key: Hashable) -> bool:
        if self._key_to_id is None:
            try:
                return 0 <= int(key) < self.num_nodes
            except (TypeError, ValueError):
                return False
        return key in self._key_to_id

    # ------------------------------------------------------------ constructors
    @classmethod
    def from_edges(
        cls,
        src: np.ndarray,
        dst: np.ndarray,
        num_nodes: int | None = None,
        keys: Sequence[Hashable] | None = None,
    ) -> "Graph":
        """Build from parallel (src, dst) internal-id edge arrays."""
        src = np.asarray(src, dtype=np.int64)
        dst = np.asarray(dst, dtype=np.int64)
        if src.shape != dst.shape:
            raise ValueError("src/dst shape mismatch")
        if num_nodes is None:
            num_nodes = int(max(src.max(initial=-1), dst.max(initial=-1)) + 1)
        order = np.argsort(src, kind="stable")
        src_s, dst_s = src[order], dst[order]
        counts = np.bincount(src_s, minlength=num_nodes)
        indptr = np.zeros(num_nodes + 1, dtype=np.int64)
        np.cumsum(counts, out=indptr[1:])
        return cls(indptr.astype(np.int32), dst_s.astype(np.int32), keys=keys)

    @classmethod
    def from_dict(cls, adjacency: Mapping[Hashable, Iterable[Hashable]]) -> "Graph":
        """Build from the reference's graph model: node -> list of successors.

        Successors not present as keys are registered as nodes with no
        outgoing edges (the CSV importer's ``graph[n2];`` behaviour,
        src/main.cc:97-99).
        """
        key_to_id: Dict[Hashable, int] = {}
        keys: List[Hashable] = []

        def intern(k: Hashable) -> int:
            i = key_to_id.get(k)
            if i is None:
                i = len(keys)
                key_to_id[k] = i
                keys.append(k)
            return i

        for k in adjacency:
            intern(k)
        srcs: List[int] = []
        dsts: List[int] = []
        for k, succs in adjacency.items():
            u = key_to_id[k]
            for s in succs:
                srcs.append(u)
                dsts.append(intern(s))
        return cls.from_edges(
            np.asarray(srcs, dtype=np.int64),
            np.asarray(dsts, dtype=np.int64),
            num_nodes=len(keys),
            keys=keys,
        )

    def to_dict(self) -> Dict[Hashable, List[Hashable]]:
        """Back to the reference's adjacency model (external keys)."""
        keys = self.keys
        return {
            keys[v]: [keys[s] for s in self.successors(v)]
            for v in range(self.num_nodes)
        }

    # ---------------------------------------------------------------- queries
    def successors(self, v: int) -> np.ndarray:
        return self.indices[self.indptr[v] : self.indptr[v + 1]]

    @property
    def csc(self) -> Tuple[np.ndarray, np.ndarray]:
        """Predecessor structure (indptr, indices), built lazily."""
        if self._csc is None:
            rev = Graph.from_edges(
                self.indices.astype(np.int64),
                np.repeat(
                    np.arange(self.num_nodes, dtype=np.int64), self.out_degree
                ),
                num_nodes=self.num_nodes,
            )
            self._csc = (rev.indptr, rev.indices)
        return self._csc

    # ------------------------------------------------------------- partitions
    @property
    def partition(self) -> np.ndarray:
        """Approximate 2-colouring: uint8[N], values {0, 1}.

        BFS-level parity over the undirected closure, one BFS per connected
        component; each component's root goes to partition 0.  Odd cycles
        may put neighbours in the same partition, which costs convergence
        speed, not correctness.

        Runs the native BFS (utils/io.py, ``ppr_bfs_bipartition``), or its
        plain version :meth:`_bfs_bipartition` where the native library
        cannot be built; ``utils.io.paths_ran()`` says which ran.
        """
        if self._partition is None:
            from .utils.io import native_available, native_bfs_bipartition, note_path

            if native_available():
                self._partition = native_bfs_bipartition(
                    self.indptr, self.indices, *self.csc
                )
            else:
                self._partition = self._bfs_bipartition()
                note_path("bfs_bipartition", "numpy")
        return self._partition

    def _bfs_bipartition(self) -> np.ndarray:
        """The 2-colouring in numpy, one frontier at a time: the plain
        version of the native BFS."""
        n = self.num_nodes
        color = np.full(n, 255, dtype=np.uint8)  # 255 = unvisited
        if n == 0:
            return color
        indptr, indices = self.indptr, self.indices
        cindptr, cindices = self.csc
        for root in range(n):
            if color[root] != 255:
                continue
            color[root] = 0
            frontier = np.array([root], dtype=np.int64)
            cur = 0
            while frontier.size:
                nbrs = _gather_neighbors(frontier, indptr, indices)
                preds = _gather_neighbors(frontier, cindptr, cindices)
                cand = np.concatenate([nbrs, preds])
                if cand.size:
                    cand = np.unique(cand)
                    cand = cand[color[cand] == 255]
                cur ^= 1
                color[cand] = cur
                frontier = cand
        return color

    # ------------------------------------------------------------- merge plan
    def merge_plan(
        self,
        partition_id: int | None = None,
        L: int | None = None,
        net_width: int | None = None,
    ) -> MergePlan:
        """Degree-bucketed ELL plan for the given partition (or whole graph).

        ``partition_id`` of None means "all nodes".  ``L`` (the merge basket
        width) enables kernel-width-aligned bucket caps (see
        _width_aligned_cap_table); ``net_width`` additionally gives hub
        buckets multiple-of-sub caps for the hierarchical merge (see
        _assign_caps).  Cached per argument.
        """
        cache_key = (partition_id, L, net_width)
        if cache_key in self._plans:
            return self._plans[cache_key]
        if partition_id is None:
            nodes = np.arange(self.num_nodes, dtype=np.int64)
        else:
            nodes = np.nonzero(self.partition == partition_id)[0]
        deg = self.out_degree[nodes].astype(np.int64)
        dangling = nodes[deg == 0].astype(np.int32)
        nodes = nodes[deg > 0]
        deg = self.out_degree[nodes].astype(np.int64)
        buckets: List[EllBucket] = []
        if nodes.size:
            caps = _assign_caps(deg, L, net_width)
            for cap in np.unique(caps):
                all_sel = nodes[caps == cap]
                cap = int(cap)
                for s0 in range(0, all_sel.size, MAX_BUCKET_ROWS):
                    sel = all_sel[s0 : s0 + MAX_BUCKET_ROWS]
                    succ = np.full((sel.size, cap), SENTINEL, dtype=np.int32)
                    starts = self.indptr[sel].astype(np.int64)
                    lens = self.out_degree[sel].astype(np.int64)
                    rows_rep = np.repeat(
                        np.arange(sel.size, dtype=np.int64), lens
                    )
                    col_rep = np.arange(
                        int(lens.sum()), dtype=np.int64
                    ) - np.repeat(
                        np.concatenate([[0], np.cumsum(lens)[:-1]]), lens
                    )
                    succ[rows_rep, col_rep] = self.indices[
                        np.repeat(starts, lens) + col_rep
                    ]
                    buckets.append(
                        EllBucket(cap=cap, rows=sel.astype(np.int32), succ=succ)
                    )
        plan = MergePlan(buckets=tuple(buckets), dangling_rows=dangling)
        self._plans[cache_key] = plan
        return plan

    # ------------------------------------------------------------ device CSR
    def device_graph(self, device) -> "DeviceGraph":
        """The CSR on ``device`` in the walker's layout (ops/walk.py);
        cached per device."""
        dev = torch.device(device)
        if str(dev) not in self._device_graphs:
            start_deg = np.stack([self.indptr[:-1], self.out_degree], axis=-1)
            self._device_graphs[str(dev)] = DeviceGraph(
                start_deg=torch.as_tensor(start_deg.astype(np.int64)).to(dev),
                indices=torch.as_tensor(self.indices.astype(np.int64)).to(dev),
            )
        return self._device_graphs[str(dev)]

    def release_device_state(self) -> None:
        """Free what sparse GRank keeps on the card between calls: its
        captured init-sweep and half-sweep graphs, their two baskets, their
        memory pool and the device plans.  The next call on the card
        captures again.  A no-op where nothing is kept; waits for a call in
        another thread."""
        with self._sweep_lock:
            kept, self._sweep_graphs = self._sweep_graphs, None
            if kept is not None:
                kept.release()

    def __getstate__(self) -> dict:
        # what is kept on the card, and the lock, stay with this object
        state = dict(self.__dict__, _sweep_graphs=None)
        del state["_sweep_lock"]
        return state

    def __setstate__(self, state: dict) -> None:
        self.__dict__.update(state, _sweep_lock=threading.Lock())

    def __repr__(self) -> str:
        return f"Graph(num_nodes={self.num_nodes}, num_edges={self.num_edges})"


def _gather_neighbors(
    frontier: np.ndarray, indptr: np.ndarray, indices: np.ndarray
) -> np.ndarray:
    """Flat neighbour ids of all frontier nodes (with duplicates)."""
    starts = indptr[frontier].astype(np.int64)
    ends = indptr[frontier + 1].astype(np.int64)
    lens = ends - starts
    total = int(lens.sum())
    if total == 0:
        return np.empty(0, dtype=np.int64)
    offs = np.repeat(starts - np.concatenate([[0], np.cumsum(lens)[:-1]]), lens)
    flat = np.arange(total, dtype=np.int64) + offs
    return indices[flat].astype(np.int64)


def load_csv_graph(path: str) -> Graph:
    """Import a directed graph from a ``node1,node2`` CSV edge list.

    Semantics match the reference driver's ``importGraph``
    (src/main.cc:78-112): ``\\r``/``\\n`` are stripped, the destination node
    is registered even if it has no outgoing edges, and duplicate edges are
    skipped.  Keys are ordered by first appearance in the file.
    """
    from .utils.io import parse_edge_csv

    src, dst = parse_edge_csv(path)
    # Dedup, keeping first occurrences.  A compound view avoids packing
    # src*(max+1)+dst, which overflows int64 for ids near 2^32.
    pairs = np.ascontiguousarray(
        np.stack([src.astype(np.int64), dst.astype(np.int64)], axis=1)
    )
    view = pairs.view([("s", np.int64), ("d", np.int64)]).reshape(-1)
    _, first = np.unique(view, return_index=True)
    first.sort()
    src, dst = src[first], dst[first]
    # Densify external ids to [0, N) in order of first appearance
    # (source before target on each line).
    interleaved = np.empty(2 * src.size, dtype=np.int64)
    interleaved[0::2] = src
    interleaved[1::2] = dst
    uniq, inv_first = np.unique(interleaved, return_index=True)
    order = np.argsort(inv_first, kind="stable")
    keys_arr = uniq[order]
    remap = np.empty(uniq.size, dtype=np.int64)
    remap[order] = np.arange(keys_arr.size)
    src_i = remap[np.searchsorted(uniq, src)]
    dst_i = remap[np.searchsorted(uniq, dst)]
    return Graph.from_edges(
        src_i, dst_i, num_nodes=keys_arr.size, keys=[int(k) for k in keys_arr]
    )
