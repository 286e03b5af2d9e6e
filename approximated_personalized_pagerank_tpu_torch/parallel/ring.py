"""Ring-sharded GRank and MC combine: owner-centric communication over a
1-D mesh (parallel/mesh.py).

The successor of ``grankMulti``'s shared-memory data parallelism
(header-only/grankMulti.h:289-436), laid out so that a shard holds
O(N/D * L) of the baskets:

* the basket tensors ``[N_pad, L]`` are split by rows; shard ``p`` owns
  rows ``[p*S, (p+1)*S)``;
* one half-sweep rotates the *old* basket shards around the ring: at ring
  step ``t`` shard ``p`` holds the shard owned by ``(p - t) mod D`` and
  copies out the candidate baskets of exactly those successors that live in
  it.  Every (row, successor) pair is filled at one step, so the candidate
  matrix is complete and the merge exact: no intermediate truncation;
* after ``D`` steps each shard merges its candidates (``ops/merge.py``'s
  ``_merge_rows``: the fused kernel's matrix entry or the sort pipeline)
  and writes its own rows, so 1 shard and D shards give equal baskets;
* convergence is the max of the shards' L1 diffs, over the processes too
  (``all_reduce``): the maxDiffs reduction of grankMulti.h:406-407.

Buckets are grouped into *rounds* whose candidates fit ``elem_budget``
elements a shard; each round takes one rotation.  A shard's live buffers
are its old basket shard, the one it holds, its out shard and the active
round's candidates (:func:`ring_shard_bytes`).

The loop runs on the host, one read of the half-sweep's max diff each, as
the sparse engine's (models/grank.py).  The rotation is a copy to the next
shard's device (none when both live on one device: a shard only reads what
it holds) and ``torch.distributed`` point-to-point copies across a process
boundary.  The plan is byte-equal to the JAX package's.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import torch

from ..graph import SENTINEL, Graph, _assign_caps
from ..ops.basket import Baskets, keep_top_chunked, norm1_rows
from ..ops.merge import _l_pad, _merge_rows, _scales, _takes_kernel, net_max_width
from ..ops.merge_kernel import next_pow2
from .mesh import Mesh, make_mesh, shard_size

__all__ = [
    "RingBucket", "RingPlan", "build_ring_plan", "ring_grank_baskets",
    "ring_mc_combine", "ring_shard_bytes", "DEFAULT_RING_ELEM_BUDGET",
]

# A shard's element budget for one round's candidate matrices.
DEFAULT_RING_ELEM_BUDGET = 1 << 22


@dataclasses.dataclass(frozen=True)
class RingBucket:
    """One degree bucket, stacked per shard: rows[D, C] (global node ids,
    padded with N_pad), succ[D, C, cap] (padded with SENTINEL).  Every row
    in ``rows[d]`` is owned by shard ``d``."""

    cap: int
    rows: np.ndarray
    succ: np.ndarray


@dataclasses.dataclass(frozen=True)
class RingPlan:
    """Per-partition ring plan: buckets grouped into budget-bounded rounds."""

    rounds: Tuple[Tuple[RingBucket, ...], ...]
    dangling_rows: np.ndarray


def build_ring_plan(
    graph: Graph,
    partition_id: int | None,
    n_shards: int,
    L: int,
    elem_budget: int = DEFAULT_RING_ELEM_BUDGET,
    algo: str = "sort",
) -> RingPlan:
    """Degree-bucketed ELL plan with shard-uniform bucket shapes.

    Like ``Graph.merge_plan``, but rows are grouped by owning shard (owner
    = node // shard size) and padded so every shard's bucket has one shape.
    ``partition_id`` None means every node (the MC combine).  ``algo`` is
    the merge pipeline: the kernel pipeline takes width-aligned caps, with
    no hub caps (a hub row is merged flat, through the sort pipeline when
    it is wider than the kernel).
    """
    n = graph.num_nodes
    s = shard_size(n, n_shards)
    n_pad = s * n_shards
    if partition_id is None:
        nodes = np.arange(n, dtype=np.int64)
    else:
        nodes = np.nonzero(graph.partition == partition_id)[0]
    deg = graph.out_degree[nodes].astype(np.int64)
    dangling = nodes[deg == 0].astype(np.int32)
    nodes = nodes[deg > 0]
    deg = graph.out_degree[nodes].astype(np.int64)
    buckets: List[RingBucket] = []
    if nodes.size:
        caps = _assign_caps(deg, L if net_max_width(algo) is not None else None)
        owner = nodes // s
        for cap in np.unique(caps):
            cap = int(cap)
            sel_mask = caps == cap
            sel = nodes[sel_mask]
            own = owner[sel_mask]
            counts = np.bincount(own, minlength=n_shards)
            c = int(counts.max())
            rows = np.full((n_shards, c), n_pad, dtype=np.int32)
            succ = np.full((n_shards, c, cap), SENTINEL, dtype=np.int32)
            # position of each node within its shard's row list
            order = np.argsort(own, kind="stable")
            sel_o = sel[order]
            own_o = own[order]
            offs = np.concatenate([[0], np.cumsum(counts)[:-1]])
            pos = np.arange(sel_o.size) - offs[own_o]
            rows[own_o, pos] = sel_o.astype(np.int32)
            lens = graph.out_degree[sel_o].astype(np.int64)
            starts = graph.indptr[sel_o].astype(np.int64)
            rep_r = np.repeat(own_o, lens)
            rep_p = np.repeat(pos, lens)
            col = np.arange(int(lens.sum()), dtype=np.int64) - np.repeat(
                np.concatenate([[0], np.cumsum(lens)[:-1]]), lens
            )
            succ[rep_r, rep_p, col] = graph.indices[np.repeat(starts, lens) + col]
            buckets.append(RingBucket(cap=cap, rows=rows, succ=succ))
    # group buckets into rounds: one rotation each, candidates bounded
    rounds: List[List[RingBucket]] = []
    cur: List[RingBucket] = []
    cur_elems = 0
    for b in sorted(buckets, key=lambda b: b.cap):
        elems = b.rows.shape[1] * b.cap * L
        if cur and cur_elems + elems > elem_budget:
            rounds.append(cur)
            cur, cur_elems = [], 0
        cur.append(b)
        cur_elems += elems
    if cur:
        rounds.append(cur)
    return RingPlan(rounds=tuple(tuple(r) for r in rounds), dangling_rows=dangling)


def ring_shard_bytes(plans, n: int, n_shards: int, L: int, algo: str) -> int:
    """Bytes of one shard's live buffers in a ring run of these plans: the
    old basket shard, the held one and the out shard (ids int32 + scores
    float32), the largest round's ``[C, cap, L]`` candidates, and the
    widest bucket's merge rows (``[C, cap*L+1]``, plus their copy padded
    to the kernel's width when the kernel takes them)."""
    s = shard_size(n, n_shards)
    cand = rows = 0
    for plan in plans:
        for rnd in plan.rounds:
            cand = max(cand, sum(b.rows.shape[1] * b.cap * L for b in rnd) * 8)
            for b in rnd:
                c, w = b.rows.shape[1], b.cap * L + 1
                m = c * w * 8
                if _takes_kernel(algo, w):
                    m += c * max(next_pow2(w), _l_pad(L)) * 8
                rows = max(rows, m)
    return 3 * s * L * 8 + cand + rows


class _Bucket(NamedTuple):
    """A bucket's rows on one shard, on its device (no padding rows)."""

    rows: torch.Tensor  # int64[c] global node ids
    succ: torch.Tensor  # int64[c, cap], -1 padded
    owner: torch.Tensor  # int64[c, cap] shard owning each successor, -1 padded


def _shard_rounds(plan: RingPlan, p: int, dev, s: int, n_pad: int) -> List[List[_Bucket]]:
    out = []
    for rnd in plan.rounds:
        bs = []
        for b in rnd:
            real = int((b.rows[p] < n_pad).sum())  # padding rows come last
            rows = torch.as_tensor(b.rows[p, :real].astype(np.int64)).to(dev)
            succ = torch.as_tensor(b.succ[p, :real].astype(np.int64)).to(dev)
            owner = torch.where(succ >= 0, torch.div(succ, s, rounding_mode="floor"), -1)
            bs.append(_Bucket(rows, succ, owner))
        out.append(bs)
    return out


def _ring_fill(held: Baskets, b: _Bucket, cand: Baskets, r: int, s: int) -> Baskets:
    """Copy into ``cand`` ([c, cap, L]) the baskets of the successors that
    live in ``held``, the shard owned by ``r``."""
    mask = b.owner == r
    safe = torch.where(mask, b.succ - r * s, 0)
    got_ids = held.ids[safe]
    got_scores = held.scores[safe]
    sel = mask[..., None] & (got_ids >= 0)
    return Baskets(torch.where(sel, got_ids, cand.ids),
                   torch.where(sel, got_scores, cand.scores))


def _merge_and_scatter(
    b: _Bucket,
    cand: Baskets | None,
    old: Baskets | None,
    out: Baskets,
    damping: torch.Tensor,
    lo: int,
    L: int,
    algo: str,
    mode: str = "grank",
) -> torch.Tensor | None:
    """Merge one bucket's rows and write them into ``out`` (rows ``lo..``
    of the shard).  ``mode`` as in ``ops/merge.py``: ``"grank"`` scales the
    candidates by damping/outdeg with a self entry 1-damping
    (include/grank.h:100-116); ``"mc_combine"`` keeps them unscaled, with a
    self entry 1/factor, and scales the merged row by factor
    (include/mccompletepathv2.h:213-249).  ``cand`` None is GRank's init:
    each successor contributes ``{s: 1}`` (include/grank.h:64-83).  With
    ``old`` returns the rows' max L1 diff against it."""
    c, cap = b.succ.shape
    deg = (b.succ >= 0).sum(dim=-1).to(torch.float32)
    scale, self_scores, post = _scales(deg, damping, mode)
    if cand is None:
        valid = b.succ >= 0
        cand_ids = torch.where(valid, b.succ, SENTINEL).to(torch.int32)
        cand_scores = valid.to(torch.float32)
    else:
        cand_ids = cand.ids.reshape(c, cap * L)
        cand_scores = cand.scores.reshape(c, cap * L)
    ids = torch.cat([cand_ids, b.rows[:, None].to(torch.int32)], dim=-1)
    scores = torch.cat([cand_scores * scale[:, None], self_scores[:, None]], dim=-1)
    merged = _merge_rows(ids, scores, L, algo, lists=cap + 1)
    merged = Baskets(merged.ids, merged.scores * post[:, None])
    local = b.rows - lo
    diff = None
    if old is not None:
        diff = norm1_rows(merged, Baskets(old.ids[local], old.scores[local])).max()
    out.ids.index_copy_(0, local, merged.ids)
    out.scores.index_copy_(0, local, merged.scores)
    return diff


def _rotate(mesh: Mesh, held: List[Baskets]) -> List[Baskets]:
    """Pass every held shard on to the next shard of the ring: shard ``k``
    of this process takes shard ``k-1``'s; the first takes the last local
    one, or, across processes, the previous process's last."""
    devs = mesh.devices
    last = held[-1]
    new = [Baskets(h.ids.to(d), h.scores.to(d))
           for h, d in zip(held[:-1], devs[1:])]
    import torch.distributed as dist

    if mesh.group is None or dist.get_world_size(mesh.group) == 1:
        new.insert(0, Baskets(last.ids.to(devs[0]), last.scores.to(devs[0])))
    else:
        rank, world = dist.get_rank(mesh.group), dist.get_world_size(mesh.group)
        recv = Baskets(torch.empty_like(last.ids, device=devs[0]),
                       torch.empty_like(last.scores, device=devs[0]))
        nxt = dist.get_global_rank(mesh.group, (rank + 1) % world)
        prv = dist.get_global_rank(mesh.group, (rank - 1) % world)
        ops = [
            dist.P2POp(dist.isend, last.ids.contiguous(), nxt, mesh.group),
            dist.P2POp(dist.isend, last.scores.contiguous(), nxt, mesh.group),
            dist.P2POp(dist.irecv, recv.ids, prv, mesh.group),
            dist.P2POp(dist.irecv, recv.scores, prv, mesh.group),
        ]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        new.insert(0, recv)
    return new


def _global_max(mesh: Mesh, diffs: List[torch.Tensor]) -> torch.Tensor:
    """The max of the shards' diffs, over every process of the mesh."""
    dev0 = mesh.devices[0]
    m = torch.zeros((), dtype=torch.float32, device=dev0)
    for d in diffs:
        m = torch.maximum(m, d.to(dev0))
    if mesh.group is not None:
        import torch.distributed as dist

        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=mesh.group)
    return m


def _sweep(
    mesh: Mesh,
    baskets: List[Baskets],
    rounds: List[List[List[_Bucket]]],
    damping: Dict[torch.device, torch.Tensor],
    s: int,
    L: int,
    algo: str,
    compute_diff: bool,
    mode: str = "grank",
) -> Tuple[List[Baskets], torch.Tensor | None]:
    """One ring sweep over this process's shards: ``baskets[k]`` is shard
    ``k``'s old basket shard, ``rounds[k]`` its buckets by round.  Rows
    not in the plan keep their old values.  Returns the new shards and,
    with ``compute_diff``, the global max L1 diff."""
    d = mesh.n_shards
    outs = [Baskets(b.ids.clone(), b.scores.clone()) for b in baskets]
    diffs = []
    for i in range(len(rounds[0])):
        cands = [
            [Baskets(torch.full(b.succ.shape + (L,), SENTINEL, dtype=torch.int32, device=dev),
                     torch.zeros(b.succ.shape + (L,), dtype=torch.float32, device=dev))
             for b in rounds[k][i]]
            for k, dev in enumerate(mesh.devices)
        ]
        held = list(baskets)
        for t in range(d):
            for k, (p, _) in enumerate(mesh.shards):
                r = (p - t) % d
                cands[k] = [c if b.rows.numel() == 0 else _ring_fill(held[k], b, c, r, s)
                            for b, c in zip(rounds[k][i], cands[k])]
            if t + 1 < d:
                held = _rotate(mesh, held)
        for k, (p, dev) in enumerate(mesh.shards):
            for b, c in zip(rounds[k][i], cands[k]):
                if b.rows.numel() == 0:
                    continue
                diff = _merge_and_scatter(
                    b, c, baskets[k] if compute_diff else None, outs[k],
                    damping[dev], p * s, L, algo, mode,
                )
                if diff is not None:
                    diffs.append(diff)
    return outs, _global_max(mesh, diffs) if compute_diff else None


def _local_rows(mesh: Mesh, parts: List[Baskets], n: int) -> Baskets:
    """This process's rows of the result, trimmed to the graph, on its
    first shard's device."""
    dev0 = mesh.devices[0]
    start, stop = mesh.row_range(n)
    ids = torch.cat([p.ids.to(dev0) for p in parts], dim=0)[: stop - start]
    scores = torch.cat([p.scores.to(dev0) for p in parts], dim=0)[: stop - start]
    return Baskets(ids, scores)


def _resolve(mesh: Mesh | None, n_shards: int | None, merge_algo: str | None):
    from ..ops.merge import resolve_merge_algo

    if mesh is None:
        mesh = make_mesh(n_shards)
    return mesh, resolve_merge_algo(merge_algo, mesh.devices[0])


def _dampings(mesh: Mesh, damping: float) -> Dict[torch.device, torch.Tensor]:
    return {dev: torch.tensor(damping, dtype=torch.float32, device=dev)
            for dev in set(mesh.devices)}


def ring_grank_baskets(
    graph: Graph,
    K: int,
    L: int,
    iterations: int,
    damping: float,
    tolerance: float,
    n_shards: int | None = None,
    mesh: Mesh | None = None,
    elem_budget: int = DEFAULT_RING_ELEM_BUDGET,
    merge_algo: str | None = None,
    return_info: bool = False,
    analyze_memory: bool = False,
):
    """Sharded GRank over the ring (module doc), with the semantics of the
    serial grank (include/grank.h:42-150): half-sweep accounting, one
    maxDiff slot per partition, a negative tolerance never stops early, a
    final keepTop(K).  Dangling rows are ``{v: 1-damping}``.

    ``mesh`` defaults to ``make_mesh(n_shards)`` (the cards).  Returns
    ``[N, K]`` baskets on the first shard's device; in a multi-process run
    this process's rows, ``mesh.row_range(N)``.  ``return_info=True``
    returns ``(baskets, info)`` with ``iterations_ran`` and ``row_range``;
    ``analyze_memory=True`` (implies it) adds ``info["memory"]``: the
    plan's bytes for one shard's live buffers (:func:`ring_shard_bytes`),
    the full basket's bytes and, on CUDA, each card's peak allocation.
    """
    mesh, algo = _resolve(mesh, n_shards, merge_algo)
    d = mesh.n_shards
    n = graph.num_nodes
    s = shard_size(n, d)
    n_pad = s * d
    plans = [build_ring_plan(graph, p, d, L, elem_budget, algo=algo) for p in (0, 1)]
    cuda_devs = sorted({str(dev) for dev in mesh.devices if dev.type == "cuda"})
    if analyze_memory:
        for dev in cuda_devs:
            torch.cuda.reset_peak_memory_stats(dev)
    rounds = [[_shard_rounds(plan, p, dev, s, n_pad) for p, dev in mesh.shards]
              for plan in plans]
    dampings = _dampings(mesh, damping)

    dang = np.concatenate([plans[0].dangling_rows, plans[1].dangling_rows]).astype(np.int64)
    baskets = []
    for p, dev in mesh.shards:
        ids = torch.full((s, L), SENTINEL, dtype=torch.int32, device=dev)
        scores = torch.zeros((s, L), dtype=torch.float32, device=dev)
        mine = torch.as_tensor(dang[(dang >= p * s) & (dang < (p + 1) * s)]).to(dev)
        ids[mine - p * s, 0] = mine.to(torch.int32)
        scores[mine - p * s, 0] = 1.0 - float(damping)
        baskets.append(Baskets(ids, scores))
    # init sweep (include/grank.h:64-83): no basket reads, no ring
    for part in rounds:
        for k, (p, dev) in enumerate(mesh.shards):
            for rnd in part[k]:
                for b in rnd:
                    if b.rows.numel():
                        _merge_and_scatter(b, None, None, baskets[k], dampings[dev],
                                           p * s, L, algo)

    compute_diff = tolerance >= 0
    # per-partition maxDiff slots, initialised to the tolerance so each
    # partition gets at least one sweep (include/grank.h:87-92)
    max_diff = [tolerance, tolerance]
    active = 0
    i = 0
    while i < iterations and max(max_diff) >= tolerance:
        baskets, diff = _sweep(mesh, baskets, rounds[active], dampings, s, L, algo,
                               compute_diff)
        max_diff[0] = float(diff) if compute_diff else 0.0
        active = 1 - active
        max_diff[0], max_diff[1] = max_diff[1], max_diff[0]
        i += 1

    out = _local_rows(mesh, [keep_top_chunked(b.ids, b.scores, K) for b in baskets], n)
    if not (return_info or analyze_memory):
        return out
    info = {"iterations_ran": i, "row_range": mesh.row_range(n)}
    if analyze_memory:
        info["memory"] = {
            "shard_bytes": ring_shard_bytes(plans, n, d, L, algo),
            "full_basket_bytes": n * L * 8,
            "device_peak_bytes": {dev: torch.cuda.max_memory_allocated(dev)
                                  for dev in cuda_devs},
        }
    return out, info


def ring_mc_combine(
    graph: Graph,
    walk: Baskets,
    K: int,
    L: int,
    damping: float,
    combine_passes: int,
    mesh: Mesh | None = None,
    n_shards: int | None = None,
    elem_budget: int = DEFAULT_RING_ELEM_BUDGET,
    merge_algo: str | None = None,
) -> Baskets:
    """MCCompletePathV2's combine over the ring: every node merges its
    successors' baskets with the ``{v: 1/factor} ... *factor`` scaling
    (include/mccompletepathv2.h:211-250), ``combine_passes`` times.
    ``walk`` is the ``[N, L]`` walk baskets.  Dangling nodes keep their
    walk basket ({v: 1.0}, mccompletepathv2.h:213-214): they are not in the
    plan.  The ring's merge is exact, so D shards equal 1.  Returns as
    :func:`ring_grank_baskets`."""
    mesh, algo = _resolve(mesh, n_shards, merge_algo)
    d = mesh.n_shards
    n = graph.num_nodes
    s = shard_size(n, d)
    plan = build_ring_plan(graph, None, d, L, elem_budget, algo=algo)
    rounds = [_shard_rounds(plan, p, dev, s, s * d) for p, dev in mesh.shards]
    dampings = _dampings(mesh, damping)
    pad = s * d - n
    w_ids = torch.nn.functional.pad(walk.ids, (0, 0, 0, pad), value=SENTINEL)
    w_scores = torch.nn.functional.pad(walk.scores, (0, 0, 0, pad))
    baskets = [Baskets(w_ids[p * s : (p + 1) * s].to(dev), w_scores[p * s : (p + 1) * s].to(dev))
               for p, dev in mesh.shards]
    for _ in range(combine_passes):
        baskets, _ = _sweep(mesh, baskets, rounds, dampings, s, L, algo, False,
                            mode="mc_combine")
    return _local_rows(mesh, [keep_top_chunked(b.ids, b.scores, K) for b in baskets], n)
