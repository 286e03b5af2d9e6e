"""Synthetic graph generator for scale runs.

A heavy-tailed directed graph with the shape statistics of social graphs
(soc-LiveJournal class): power-law out- and in-degree tails with hub
degrees in the thousands, and optional community locality.  The generator
is the JAX package's, draw for draw, so one seed gives both packages the
same graph.
"""

from __future__ import annotations

import numpy as np

from ..graph import Graph

__all__ = ["powerlaw_graph"]


def powerlaw_graph(
    num_nodes: int,
    num_edges: int,
    seed: int = 7,
    alpha: float = 1.9,
    dedup: bool = False,
    locality: float = 0.0,
    community_size: int = 1024,
) -> Graph:
    """Directed graph with zipf-like out- and in-degree distributions.

    Endpoints are drawn by the inverse-power transform ``floor(n * u**alpha)``
    (density ~ x**(1/alpha - 1), i.e. a power-law rank distribution) and
    decorrelated through independent fixed permutations so hub sources and
    hub sinks are unrelated nodes.  ``alpha=1.9`` puts the maximum degree
    near ``num_edges * (1/n)**(1/alpha)`` — ~20k for the soc-LJ shape —
    matching the "max deg >> mean" regime the merge pipeline's degree
    bucketing exists for (SURVEY §7 hard part 1).

    ``locality`` routes that fraction of each node's edges into its own
    community (a fixed random partition of the nodes into
    ``community_size`` blocks).  ``locality=0`` is a pure configuration
    model: destinations independent of sources, so a source's PPR mass
    diffuses into near-tied global-hub scores — at millions of nodes this
    is an adversarially HARD instance for any truncated top-K method
    (measured: GRank L=100 jaccard ~0.26 at 4.8M nodes; the thesis's
    "hard graphs need L=20x K" regime, p.18).  Social graphs like
    soc-LiveJournal have strong community structure instead, which is what
    makes their top-K concentrated and approximable — ``locality~0.8``
    reproduces that regime while keeping the heavy-tailed degrees.

    ``dedup`` drops duplicate (src, dst) pairs like the reference's CSV
    importer (src/main.cc:101-107); off by default since GRank accumulates
    parallel edges (include/grank.h:79-80) and the duplicate rate at this
    sparsity is negligible.
    """
    if num_nodes <= 0:
        raise ValueError("num_nodes must be positive")
    if not (0.0 <= locality <= 1.0):
        raise ValueError("locality must be in [0, 1]")
    rng = np.random.default_rng(seed)
    src = (num_nodes * rng.random(num_edges) ** alpha).astype(np.int64)
    dst = (num_nodes * rng.random(num_edges) ** alpha).astype(np.int64)
    np.minimum(src, num_nodes - 1, out=src)
    np.minimum(dst, num_nodes - 1, out=dst)
    perm_src = rng.permutation(num_nodes)
    perm_dst = rng.permutation(num_nodes)
    src = perm_src[src]
    dst = perm_dst[dst]
    if locality > 0.0:
        # member[s] = node occupying community slot s; communities are
        # contiguous SLOT blocks, i.e. random node sets (not id ranges, so
        # contiguous-range sharding gets no artificial affinity).
        member = rng.permutation(num_nodes)
        slot_of = np.empty(num_nodes, dtype=np.int64)
        slot_of[member] = np.arange(num_nodes)
        local = rng.random(num_edges) < locality
        # Small-world routing INSIDE the community: each local edge goes a
        # short, skewed slot distance ahead (1..32, density ~ x^-1/2, ring
        # wrap within the block).  A node's local out-neighbourhood is
        # therefore a ~dozen slot-near nodes whose own neighbourhoods
        # overlap heavily (triadic closure, like a Watts-Strogatz lattice)
        # — this is what concentrates a source's PPR mass on a
        # well-determined top-K, the property that makes real social
        # graphs approximable (thesis p.18).  The earlier draft routed
        # local edges near-uniformly over all `community_size` members,
        # which spread every source's mass over ~1000 near-tied scores:
        # measured jaccard at the 4.8M north star was 0.14 — an instance
        # adversarially HARDER than the locality=0 configuration model it
        # was meant to soften, not a model of community concentration.
        hop = 1 + (32 * rng.random(num_edges) ** 2).astype(np.int64)
        rel = slot_of[src] % community_size
        base = slot_of[src] - rel
        block = np.minimum(community_size, num_nodes - base)  # tail block
        local_slot = base + (rel + hop) % np.maximum(block, 1)
        # Inter-community edges follow a fixed per-community fan of 8
        # neighbour communities (popularity-skewed choice of both the
        # neighbour and the member inside it).  Unstructured global zipf
        # targets are NOT a model of social graphs: every source then
        # scores the same pool of global hubs at near-tied values, and at
        # 1M+ nodes the top-50 boundary lands inside that tie pool
        # (measured jaccard 0.20 at 1M with 20% unstructured edges, vs
        # 0.97 at 300k where the lattice still dominated).  With a fixed
        # community fan the non-local candidates are source-specific and
        # distinctly weighted, which is how real community graphs stay
        # top-K approximable while keeping heavy-tailed in-degrees
        # (popular communities x popular members).
        ncomm = -(-num_nodes // community_size)
        fan = 8
        pop = (ncomm * rng.random((ncomm, fan)) ** 2.5).astype(np.int64)
        neigh = rng.permutation(ncomm)[np.minimum(pop, ncomm - 1)]
        j = (fan * rng.random(num_edges) ** 1.5).astype(np.int64)
        src_comm = slot_of[src] // community_size
        tgt_comm = neigh[src_comm, np.minimum(j, fan - 1)]
        rel_t = (community_size * rng.random(num_edges) ** 3).astype(np.int64)
        far_slot = np.minimum(
            tgt_comm * community_size + rel_t, num_nodes - 1
        )
        dst = np.where(local, member[local_slot], member[far_slot])
    if dedup:
        pairs = np.stack([src, dst], axis=1)
        view = np.ascontiguousarray(pairs).view(
            [("s", np.int64), ("d", np.int64)]
        ).reshape(-1)
        _, first = np.unique(view, return_index=True)
        first.sort()
        src, dst = src[first], dst[first]
    return Graph.from_edges(src, dst, num_nodes=num_nodes)
