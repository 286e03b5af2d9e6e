"""A small heavy-tailed directed graph with community structure, drawn on
the device from the seed, for the small cells of the benchmark's tests (no
configuration of BENCHMARK.json stands on it): the structure of the
program's ``powerlaw_graph(nodes, edges, alpha, locality, community_size)``
(utils/synthetic.py), drawn anew here with a ``torch.Generator``.

Endpoints follow ``floor(n * u**alpha)`` (power-law ranks), decorrelated by
two permutations so that hub sources and hub sinks are unrelated nodes.  A
``locality`` share of the edges stays in the source's community (blocks of
``community_size`` slots of a random node order) and goes a short skewed
slot distance ahead (1-32 slots, density ~x^-1/2, wrapping in the block);
the others go to one of 8 neighbour communities fixed per community
(popularity-skewed) and to a popularity-skewed member there.  Parallel
edges are kept: GRank counts each (include/grank.h:79-80).
"""

from __future__ import annotations

import torch

from . import Edges, seed64

FAN = 8  # neighbour communities of each community
MAX_HOP = 32  # longest slot distance of a local edge


def make(spec: dict, seed: int, device) -> Edges:
    n, e = int(spec["nodes"]), int(spec["edges"])
    alpha = float(spec["alpha"])
    locality = float(spec["locality"])
    cs = int(spec["community_size"])
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed64(seed))

    def rand(*shape):
        return torch.rand(*shape, generator=gen, device=dev, dtype=torch.float64)

    def ranks(count, m, power):
        return (m * rand(count) ** power).to(torch.int64).clamp_(max=m - 1)

    src = torch.randperm(n, generator=gen, device=dev)[ranks(e, n, alpha)]
    dst = torch.randperm(n, generator=gen, device=dev)[ranks(e, n, alpha)]
    if locality > 0.0:
        member = torch.randperm(n, generator=gen, device=dev)
        slot_of = torch.empty_like(member)
        slot_of[member] = torch.arange(n, device=dev)
        slot = slot_of[src]
        del slot_of
        rel = slot % cs
        base = slot - rel
        block = (n - base).clamp_(max=cs)
        hop = 1 + ranks(e, MAX_HOP, 2.0)
        local_slot = base + (rel + hop) % block
        del rel, base, block, hop
        ncomm = -(-n // cs)
        neigh = torch.randperm(ncomm, generator=gen, device=dev)[
            ranks(ncomm * FAN, ncomm, 2.5)].reshape(ncomm, FAN)
        tgt_comm = neigh[slot // cs, ranks(e, FAN, 1.5)]
        far_slot = (tgt_comm * cs + ranks(e, cs, 3.0)).clamp_(max=n - 1)
        del tgt_comm, slot
        local = rand(e) < locality
        dst = member[torch.where(local, local_slot, far_slot)]
    return Edges(n, src.cpu(), dst.cpu())
