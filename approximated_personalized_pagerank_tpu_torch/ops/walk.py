"""Monte-Carlo random walks for MCCompletePathV2, all sources at once.

The port of the JAX package's ``ops/walk.py``; the walks are bit for bit
the JAX package's for equal arguments.  Reference: include/
mccompletepathv2.h:115-165, where each node runs ``R`` serial walks.  Here a
``[C, S]`` cohort of walkers (C sources x S walker slots) advances one hop
per step:

* the first edge is always taken, and the teleport before it is accounted
  for by thinning to ``floor(R * damping)`` walks per source
  (mccompletepathv2.h:127-132);
* a walk goes on while ``u <= damping`` (mccompletepathv2.h:155), with
  ``u`` drawn from the counter-based threefry stream of ``utils/prng.py``:
  one key per source chunk (``fold_in(root, first source)``), one per
  macro step of ``unroll`` hops (``fold_in(chunk key, step)``, split into
  a successor-choice and a continuation key);
* successors are chosen uniformly, or, with ``stratified``, evenly spaced
  over the cohort on the first hop (:func:`_cohort_hop`);
* a source's walks are a shared pool: a slot whose walk ends claims the
  next unstarted walk (work stealing).

Two engines share the stepping code and so the stream; equal arguments give
equal visit multisets:

* ``trace`` (the default): each hop's destination is recorded in a
  ``[C, macro*unroll*S]`` trace; the visits are counted and cut to the top
  L by the fused merge kernel (:func:`_trace_topl`);
* ``counts``: visits are scatter-added into dense ``[C, N+1]`` rows; the
  cross-check of the trace engine.

On the card the trace engine walks each chunk in one launch of the walk
cohort kernel (``ops/walk_kernel.py``, ``csrc/walk_cohort.cu``): a warp a
source row, the draws in registers, bitwise the plain loop, whose rows
each stop once none of their walks is alive.  The host reads back, once
per chunk, the most macro steps a row began (span ``mc.alive_wait``).
Elsewhere, and always in the counts engine, the per-hop loop is plain
tensor ops on the walk's device, and the host checks once per macro step
whether any walk is alive (the JAX package's ``while_loop`` condition;
span ``mc.alive_wait``); a macro step with no live walk would only record
SENTINEL.  The trace engine counts its chunks (a mesh's shard slices
each), the chunks the kernel walked (``walk_kernel_chunks``) and walked
macro steps on the innermost open span (``mc.walks``;
utils/profiling.py).  Counts are divided by the
original ``R`` (mccompletepathv2.h:158-160); dangling sources yield
``{v: 1.0}`` (mccompletepathv2.h:162-163).

MC's walks-then-combine pipeline lives in models/mccompletepathv2.py: it
calls :func:`walk_rows` once for every engine, then the engine's combine.
"""

from __future__ import annotations

import math
from typing import Iterator, Tuple

import numpy as np
import torch

from ..utils.device import resolve_device
from ..utils.profiling import current, span
from ..utils.prng import fold_in, prng_key, split, uniform_many
from .basket import SENTINEL, Baskets, empty_baskets, keep_top
from .merge import _merge_rows, resolve_merge_algo
from .walk_kernel import walk_cohort

__all__ = [
    "walk_counts_chunk",
    "walk_trace_chunk",
    "walk_trace_plain",
    "walk_trace_basket_chunks",
    "walk_count_chunks",
    "walk_baskets",
    "walk_rows",
    "default_max_steps",
]

# The JAX package caps a trace chunk at MAX_MAP_CHUNKS row chunks of its
# merge (a TPU fault guard over a mapped kernel loop).  The port has no
# such loop, but the cap sets the chunk size, and each chunk's key is
# folded from its first source: the cap is kept as plan arithmetic because
# it fixes the PRNG streams.
MAX_MAP_CHUNKS = 16
# Trace merges run in row chunks of at most this many candidates.
TRACE_MERGE_ELEMS = 1 << 22


def default_max_steps(damping: float, eps: float = 1e-9) -> int:
    """Step cap making the truncated geometric tail < eps of walkers.

    The reference's do-while has no cap (it ends with probability 1); the
    cap is statistically invisible below eps.
    """
    if damping <= 0:
        return 1
    if damping >= 1:
        return 10_000
    return max(1, min(10_000, int(math.ceil(math.log(eps) / math.log(damping)))))


def _cohort_init(start_deg, sources, total: int, slots: int):
    """Initial cohort state for a source chunk.

    Returns (src2, cur0, rem0, alive0): ``rem0[c]`` is the source's count of
    not-yet-started walks (the shared pool), ``alive0[c, s]`` marks slots
    running one of the first ``slots`` walks.  Dangling sources start with
    nothing (their walks die on the first step with no count,
    mccompletepathv2.h:162-163).
    """
    c = sources.shape[0]
    src2 = sources.to(torch.int64)[:, None].expand(c, slots)
    has_edges = start_deg[src2[:, 0], 1] > 0  # [C]
    slot_idx = torch.arange(slots, device=sources.device)[None, :]
    alive0 = has_edges[:, None] & (slot_idx < total)
    rem0 = has_edges.to(torch.int64) * max(total - slots, 0)
    return src2, src2, rem0, alive0


def _cohort_hop(
    start_deg, indices, src2, cur, rem, alive, u, u2, damping,
    stratified: bool = False,
    first_hop: bool = False,
):
    """One hop of the work-stealing cohort (the stepping code of both
    engines; the draws ``u``/``u2`` come from the caller).

    ``stratified`` recovers the quality effect of the reference's rotating
    successor index (include/mccompletepathv2.h:142-151, thesis p.7): on the
    first hop, where the whole cohort row stands at its source, slot ``s``
    takes successor ``(floor(u[c, 0] * deg) + s) mod deg``: one draw per
    row, evenly spaced choices.  Later hops draw independently.
    ``first_hop`` marks that hop.

    ``damping`` is a float32 tensor: ``u2 > damping`` compares in float32,
    and the successor index is ``u * deg`` in float32 truncated toward 0.

    Returns (visit, stepping, cur, rem, alive): ``visit[c, s]`` is the node
    stepped to (undefined where ``stepping`` is False; callers mask it).
    """
    pd = start_deg[cur]
    start, deg = pd[..., 0], pd[..., 1]
    dead_end = deg == 0
    # a slot steps iff its walk is live and not stranded at a dangling node
    stepping = alive & ~dead_end
    degf = deg.to(torch.float32)
    j = torch.minimum((u * degf).to(torch.int64), (deg - 1).clamp(min=0))
    if stratified and first_hop:
        slot_idx = torch.arange(u.shape[-1], device=u.device)[None, :]
        base = (u[..., :1] * degf).to(torch.int64)
        j = (base + slot_idx) % deg.clamp(min=1)
    nxt = indices[(start + j).clamp(0, indices.shape[0] - 1)]
    # geometric continuation: walk on while u2 <= damping; stranding at a
    # dangling node also ends the walk (mccompletepathv2.h:142-155)
    walk_ends = alive & (dead_end | (u2 > damping))
    # work stealing: ending slots claim unstarted walks in slot order
    claim_rank = torch.cumsum(walk_ends, dim=1)
    restart = walk_ends & (claim_rank <= rem[:, None])
    rem = (rem - claim_rank[:, -1]).clamp(min=0)
    alive = (alive & ~walk_ends) | restart
    cur = torch.where(stepping & ~walk_ends, nxt, src2)
    return nxt, stepping, cur, rem, alive


def _macro_draws(key, step: int, shape, device, rows=None) -> torch.Tensor:
    """``[2, unroll, C, S]`` uniforms of one macro step: successor choice
    and continuation, from ``split(fold_in(key, step))``; ``rows=(offset,
    total)``: rows ``offset..`` of a chunk of ``total`` sources."""
    k_choice, k_cont = split(fold_in(key, step))
    return uniform_many([k_choice, k_cont], shape, device, rows=rows)


def walk_trace_chunk(
    start_deg: torch.Tensor,  # int64[n, 2]: (indptr[v], out_degree[v])
    indices: torch.Tensor,  # int64[E]
    sources: torch.Tensor,  # int[C]
    key,
    damping: torch.Tensor,  # float32 0-d
    total: int,  # floor(R * damping) walks per source
    slots: int,
    macro_steps: int,
    unroll: int,
    stratified: bool = False,
    rows: Tuple[int, int] | None = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Visit trace ``int32[C, macro_steps*unroll*slots]`` for a source chunk,
    plus ``abandoned int64[C]``: walks cut off by the step horizon (still
    running at the end, or never started).

    Hop ``h`` of macro step ``t`` records column block ``t*unroll + h``:
    the node each slot stepped to, or SENTINEL for an idle slot.

    ``rows=(offset, total)``: ``sources`` are rows ``offset..`` of a chunk
    of ``total`` sources under ``key`` (a shard of it), and draw that
    chunk's numbers at their rows, so each row walks as in the whole chunk
    (rows never interact).

    A CUDA chunk is walked by the walk cohort kernel
    (:func:`ops.walk_kernel.walk_cohort`), which raises where it cannot
    take the inputs (more than 32 slots, another dtype, a non-contiguous
    tensor); the host's one read is its count of macro steps.  Other
    chunks take the plain loop, :func:`walk_trace_plain`.
    """
    owner = current()  # mc.walks, where the engine opens it
    owner.count("chunks")
    if sources.device.type != "cuda" or slots == 0 or indices.shape[0] == 0:
        return walk_trace_plain(start_deg, indices, sources, key, damping, total,
                                slots, macro_steps, unroll, stratified, rows)
    trace, abandoned, walked = walk_cohort(
        start_deg, indices, sources, key, damping, total, slots, macro_steps,
        unroll, stratified=stratified, rows=rows,
    )
    owner.count("walk_kernel_chunks")
    with span("mc.alive_wait"):
        walked = int(walked)
    owner.count("macro_steps", walked)
    return trace, abandoned


def walk_trace_plain(
    start_deg, indices, sources, key, damping, total: int, slots: int,
    macro_steps: int, unroll: int, stratified: bool = False,
    rows: Tuple[int, int] | None = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`walk_trace_chunk` as plain tensor ops on the tensors' device:
    :func:`_cohort_hop` a hop over the whole ``[C, S]`` cohort, and a host
    check per macro step whether any walk is alive (span
    ``mc.alive_wait``; walked macro steps counted on the innermost open
    span).  What the CPU runs, and what the kernel is held against."""
    c = sources.shape[0]
    dev = sources.device
    width = macro_steps * unroll * slots
    trace = torch.full((c, width), SENTINEL, dtype=torch.int32, device=dev)
    if slots == 0 or indices.shape[0] == 0:
        return trace, torch.zeros(c, dtype=torch.int64, device=dev)

    owner = current()
    src2, cur, rem, alive = _cohort_init(start_deg, sources, total, slots)
    for step in range(macro_steps):
        with span("mc.alive_wait"):
            done = not bool(alive.any())
        if done:
            break
        owner.count("macro_steps")
        u_all, u2_all = _macro_draws(key, step, (unroll, c, slots), dev, rows=rows)
        col = step * unroll * slots
        for hop in range(unroll):
            nxt, stepping, cur, rem, alive = _cohort_hop(
                start_deg, indices, src2, cur, rem, alive,
                u_all[hop], u2_all[hop], damping, stratified=stratified,
                first_hop=step == 0 and hop == 0,
            )
            trace[:, col : col + slots] = torch.where(stepping, nxt, SENTINEL)
            col += slots
    abandoned = alive.sum(dim=1) + rem
    return trace, abandoned


def walk_counts_chunk(
    start_deg: torch.Tensor,
    indices: torch.Tensor,
    sources: torch.Tensor,
    key,
    damping: torch.Tensor,
    r_total: torch.Tensor,  # float32 0-d: R, for the normalisation
    total: int,
    num_nodes: int,
    slots: int,
    macro_steps: int,
    unroll: int = 32,
    stratified: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Normalized visit counts ``float32[C, num_nodes]`` for a source chunk,
    plus ``abandoned`` (see :func:`walk_trace_chunk`).

    ``unroll`` hops advance per macro step, their visits added with one
    scatter-add.  Counts are whole numbers below 2**24, so the float32 sums
    are exact in any order.
    """
    c = sources.shape[0]
    n = num_nodes
    dev = sources.device
    # a dead column at n takes the idle slots' deposits
    counts = torch.zeros((c, n + 1), dtype=torch.float32, device=dev)
    # every walk counts its source once, with the original R
    # (mccompletepathv2.h:124)
    counts[torch.arange(c, device=dev), sources.to(torch.int64)] += r_total
    if slots == 0 or indices.shape[0] == 0:
        return counts[:, :n] / r_total.clamp(min=1.0), torch.zeros(
            c, dtype=torch.int64, device=dev)

    src2, cur, rem, alive = _cohort_init(start_deg, sources, total, slots)
    rows_cat = torch.arange(c, device=dev).repeat_interleave(slots).repeat(unroll)
    for step in range(macro_steps):
        if not bool(alive.any()):
            break
        u_all, u2_all = _macro_draws(key, step, (unroll, c, slots), dev)
        tgts, vals = [], []
        for hop in range(unroll):
            nxt, stepping, cur, rem, alive = _cohort_hop(
                start_deg, indices, src2, cur, rem, alive,
                u_all[hop], u2_all[hop], damping, stratified=stratified,
                first_hop=step == 0 and hop == 0,
            )
            tgts.append(torch.where(stepping, nxt, n).reshape(-1))
            vals.append(stepping.reshape(-1))
        counts.index_put_(
            (rows_cat, torch.cat(tgts)),
            torch.cat(vals).to(torch.float32),
            accumulate=True,
        )
    abandoned = alive.sum(dim=1) + rem
    return counts[:, :n] / r_total.clamp(min=1.0), abandoned


def _trace_topl(
    trace: torch.Tensor,  # int32[C, W]
    sources: torch.Tensor,  # [C]
    r_total: torch.Tensor,  # float32 0-d: R
    L: int,
    row_chunk: int,
    algo: str,
) -> Baskets:
    """Normalized top-L count baskets from a visit trace.

    Appends the source seed (count R: every walk counts its source once,
    mccompletepathv2.h:124) as one more column, then per row: sort by id,
    sum runs (a run's length is a visit count), keep the top L
    (:func:`ops.merge._merge_rows`: the fused kernel's matrix entry, or the
    sort pipeline), divide by R (mccompletepathv2.h:158-160).  Rows go
    through in chunks of ``row_chunk``.
    """
    c = trace.shape[0]
    parts_i, parts_s = [], []
    for s0 in range(0, c, row_chunk):
        tr = trace[s0 : s0 + row_chunk]
        ids = torch.cat([tr, sources[s0 : s0 + row_chunk, None].to(torch.int32)], dim=1)
        scores = torch.cat(
            [(tr >= 0).to(torch.float32), r_total.expand(tr.shape[0], 1)], dim=1
        )
        out = _merge_rows(ids, scores, L, algo)
        parts_i.append(out.ids)
        parts_s.append(out.scores)
    ids = torch.cat(parts_i, dim=0)
    scores = torch.cat(parts_s, dim=0) / r_total.clamp(min=1.0)
    return Baskets(ids, scores)


def _horizon(total: int, slots: int, damping: float, sigmas: float = 1.5) -> int:
    """Step cap for a cohort: mean + ``sigmas``·std of a slot's share of the
    pool (ceil(total/slots) geometric walks back to back).  Walks cut off
    there are counted (``abandoned``) and are a sub-percent share."""
    if damping <= 0:
        return 1
    if damping >= 1:
        return 10_000
    q = -(-total // max(slots, 1))
    mean = q / (1.0 - damping)
    std = math.sqrt(q * damping) / (1.0 - damping)
    return max(4, int(math.ceil(mean + sigmas * std)) + 8)


def _pick_slots(total: int, damping: float, unroll: int) -> int:
    """Slot count minimizing the trace's pow2-padded merge width (the trace
    row is ``macro*unroll*slots`` wide plus one source column).  Shared by
    both engines, so they draw one stream; it fixes the stream, so it is
    the JAX package's choice."""
    cap = int(min(16, max(total, 1)))
    best, best_key = cap, None
    for slots in range(cap, max(cap - 9, 0), -1):
        steps = _horizon(total, slots, damping)
        macro = -(-steps // max(unroll, 1))
        width = macro * unroll * slots
        padded = 1 << width.bit_length()  # next_pow2(width + 1)
        # the narrowest padded row, then the most parallel slots
        key = (padded, -slots, width)
        if best_key is None or key < best_key:
            best, best_key = slots, key
    return best


def _walk_plan(
    n: int,
    iterations: int,
    damping: float,
    source_chunk: int | None,
    max_steps: int | None,
    slots: int | None,
    unroll: int = 32,
):
    """Cohort sizing for the counts engine: (chunk, slots, total, step
    cap).  The ``[C, n+1]`` count buffer is bounded at ~96M elements."""
    total = int(iterations * damping)  # floor(R * damping) thinned walks
    if slots is None:
        slots = _pick_slots(total, damping, unroll)
    slots = max(1, min(slots, max(total, 1)))
    if max_steps is None:
        max_steps = _horizon(total, slots, damping)
    if source_chunk is None:
        source_chunk = int(max(8, min(4096, (96 << 20) // max(n, 1))))
    source_chunk = min(source_chunk, max(n, 1))
    return source_chunk, slots, total, max_steps


def _trace_plan(
    iterations: int,
    damping: float,
    source_chunk: int | None,
    slots: int | None,
    unroll: int,
    num_nodes: int | None = None,
):
    """Cohort sizing for the trace engine: (chunk, slots, total,
    macro_steps, trace width).  The trace buffer is capped at ~64M int32;
    graphs of at most 65,536 nodes take chunks of at most 512 sources (a
    chunk runs until its slowest row is done), larger ones up to 32,768."""
    total = int(iterations * damping)
    if slots is None:
        slots = _pick_slots(total, damping, unroll)
    slots = max(1, min(slots, max(total, 1)))
    max_steps = _horizon(total, slots, damping)
    macro_steps = -(-max_steps // max(unroll, 1))
    width = macro_steps * unroll * slots
    if source_chunk is None:
        cap = 512 if (num_nodes is not None and num_nodes <= 65536) else 32768
        source_chunk = int(max(8, min(cap, (64 << 20) // max(width, 1))))
    return source_chunk, slots, total, macro_steps, width


def _trace_chunks(
    n: int,
    iterations: int,
    damping: float,
    source_chunk: int | None,
    slots: int | None,
    unroll: int,
):
    """The trace engine's (source chunk, merge row chunk, slots, total,
    macro_steps, width) for an ``n``-node graph: :func:`_trace_plan`, then
    the JAX package's clamps (the chunk to the row count, the merge row
    chunk to ``TRACE_MERGE_ELEMS`` candidates rounded down to a multiple of
    8, the chunk to ``MAX_MAP_CHUNKS`` row chunks).  The chunk size fixes
    the PRNG streams."""
    source_chunk, slots, total, macro_steps, width = _trace_plan(
        iterations, damping, source_chunk, slots, unroll, num_nodes=n
    )
    source_chunk = min(source_chunk, max(n, 1))
    row_chunk = int(max(1, min(source_chunk, TRACE_MERGE_ELEMS // max(width + 1, 1))))
    if row_chunk >= 8:
        row_chunk -= row_chunk % 8
    source_chunk = min(source_chunk, MAX_MAP_CHUNKS * row_chunk)
    return source_chunk, row_chunk, slots, total, macro_steps, width


def _sharded_trace_chunks(
    n: int,
    iterations: int,
    damping: float,
    source_chunk: int | None,
    slots: int | None,
    unroll: int,
    n_shards: int,
):
    """The source-sharded walks' plan, the JAX package's mesh branch
    (its ops/walk.py:510-522): :func:`_trace_plan`, the chunk clamped to
    the row count, *then* rounded up to a multiple of ``n_shards``, with no
    ``MAX_MAP_CHUNKS`` clamp.  So its chunks, and with them the PRNG
    streams, can differ from :func:`_trace_chunks`'."""
    source_chunk, slots, total, macro_steps, width = _trace_plan(
        iterations, damping, source_chunk, slots, unroll, num_nodes=n
    )
    source_chunk = min(source_chunk, max(n, 1))
    source_chunk = -(-source_chunk // n_shards) * n_shards
    return source_chunk, slots, total, macro_steps, width


def _root_key(seed: int | None):
    if seed is None:
        seed = int(np.random.SeedSequence().entropy % (2**31))
    return prng_key(seed)


def _chunk_sources(s: int, n: int, source_chunk: int, dev) -> Tuple[torch.Tensor, int]:
    """Sources ``s..`` of one chunk padded with source 0 to the chunk size
    (pad rows are walked, so the draws of every chunk have one shape), and
    the count of real rows."""
    real = min(source_chunk, n - s)
    padded = np.zeros(source_chunk, dtype=np.int64)
    padded[:real] = np.arange(s, s + real)
    return torch.as_tensor(padded).to(dev), real


def walk_trace_basket_chunks(
    graph,
    L: int,
    iterations: int,
    damping: float,
    seed: int | None = None,
    source_chunk: int | None = None,
    slots: int | None = None,
    unroll: int = 32,
    mesh=None,
    stratified: bool = False,
    merge_algo: str | None = None,
    device=None,
) -> Iterator[Tuple[int, Baskets, torch.Tensor, torch.Tensor]]:
    """Yield ``(start_row, Baskets, visits, abandoned)`` per source chunk:
    normalized top-L walk baskets of the chunk's sources from the trace
    engine, the hops that deposited a visit and the walks cut off by the
    horizon (0-d tensors on the device; pad rows excluded).

    ``merge_algo`` is the trace top-L's pipeline (the JAX package always
    takes its default there).  With ``mesh`` (parallel/mesh.py, one
    process) each chunk's sources are split across the shards, the CSR
    replicated on their devices: shard ``p`` walks its slice under the
    chunk's key and cuts its rows to the top L; the chunks are those of
    :func:`_sharded_trace_chunks`, and the baskets bitwise the unsharded
    engine's at the same ``source_chunk``.  Results live on the first
    shard's device.
    """
    if mesh is not None:
        yield from _sharded_trace_basket_chunks(
            graph, L, iterations, damping, seed, source_chunk, slots, unroll,
            stratified, merge_algo, mesh,
        )
        return
    dev = resolve_device(device)
    algo = resolve_merge_algo(merge_algo, dev)
    n = graph.num_nodes
    dg = graph.device_graph(dev)
    source_chunk, row_chunk, slots, total, macro_steps, _ = _trace_chunks(
        n, iterations, damping, source_chunk, slots, unroll
    )
    root = _root_key(seed)
    damping_t = torch.tensor(damping, dtype=torch.float32, device=dev)
    r_total = torch.tensor(float(iterations), dtype=torch.float32, device=dev)
    for s in range(0, n, source_chunk):
        sources, real = _chunk_sources(s, n, source_chunk, dev)
        trace, abandoned = walk_trace_chunk(
            dg.start_deg, dg.indices, sources, fold_in(root, s), damping_t,
            total, slots, macro_steps, unroll, stratified=stratified,
        )
        # pad rows re-walk source 0: neither merged nor counted
        trace = trace[:real]
        top = _trace_topl(trace, sources[:real], r_total, L, row_chunk, algo)
        yield s, top, (trace >= 0).sum(), abandoned[:real].sum()


def _sharded_trace_basket_chunks(
    graph, L, iterations, damping, seed, source_chunk, slots, unroll,
    stratified, merge_algo, mesh,
):
    """The mesh branch of :func:`walk_trace_basket_chunks`."""
    if mesh.group is not None:
        raise ValueError(
            "source-sharded walks run in one process: every shard's rows "
            "are gathered on the first shard's device"
        )
    devs = mesh.devices
    dev0 = devs[0]
    algo = resolve_merge_algo(merge_algo, dev0)
    n = graph.num_nodes
    source_chunk, slots, total, macro_steps, width = _sharded_trace_chunks(
        n, iterations, damping, source_chunk, slots, unroll, mesh.n_shards
    )
    per_shard = source_chunk // mesh.n_shards
    row_chunk = int(max(1, min(per_shard, TRACE_MERGE_ELEMS // (width + 1))))
    root = _root_key(seed)
    consts = {
        dev: (graph.device_graph(dev),
              torch.tensor(damping, dtype=torch.float32, device=dev),
              torch.tensor(float(iterations), dtype=torch.float32, device=dev))
        for dev in set(devs)
    }
    for s in range(0, n, source_chunk):
        key = fold_in(root, s)
        real = min(source_chunk, n - s)
        ids, scores = [], []
        visits = torch.zeros((), dtype=torch.int64, device=dev0)
        abandoned = torch.zeros((), dtype=torch.int64, device=dev0)
        for p, dev in mesh.shards:
            lo = p * per_shard
            rows = min(per_shard, real - lo)
            if rows <= 0:  # only padding: the unsharded engine drops it
                continue
            dg, damping_t, r_total = consts[dev]
            sources = torch.arange(s + lo, s + lo + rows, dtype=torch.int64, device=dev)
            trace, aband = walk_trace_chunk(
                dg.start_deg, dg.indices, sources, key, damping_t, total, slots,
                macro_steps, unroll, stratified=stratified, rows=(lo, source_chunk),
            )
            top = _trace_topl(trace, sources, r_total, L, row_chunk, algo)
            ids.append(top.ids.to(dev0))
            scores.append(top.scores.to(dev0))
            visits += (trace >= 0).sum().to(dev0)
            abandoned += aband.sum().to(dev0)
        yield s, Baskets(torch.cat(ids), torch.cat(scores)), visits, abandoned


def walk_count_chunks(
    graph,
    iterations: int,
    damping: float,
    seed: int | None = None,
    source_chunk: int | None = None,
    max_steps: int | None = None,
    slots: int | None = None,
    unroll: int = 32,
    stratified: bool = False,
    device=None,
) -> Iterator[Tuple[int, torch.Tensor, torch.Tensor, torch.Tensor]]:
    """Yield ``(start_row, counts[f32 C, N], visits, abandoned)`` per source
    chunk from the counts engine: normalized visit counts of the chunk's
    real rows, the hops that deposited a visit and the walks cut off by the
    horizon (0-d tensors on the device).

    ``unroll`` reaches the plan, so both engines pick one slot count for
    equal arguments (the JAX package's plan ignores it here).
    """
    dev = resolve_device(device)
    n = graph.num_nodes
    dg = graph.device_graph(dev)
    source_chunk, slots, total, max_steps = _walk_plan(
        n, iterations, damping, source_chunk, max_steps, slots, unroll
    )
    macro_steps = -(-max_steps // max(unroll, 1))
    root = _root_key(seed)
    damping_t = torch.tensor(damping, dtype=torch.float32, device=dev)
    r_total = torch.tensor(float(iterations), dtype=torch.float32, device=dev)
    for s in range(0, n, source_chunk):
        sources, real = _chunk_sources(s, n, source_chunk, dev)
        counts, abandoned = walk_counts_chunk(
            dg.start_deg, dg.indices, sources, fold_in(root, s), damping_t,
            r_total, total, n, slots, macro_steps, unroll,
            stratified=stratified,
        )
        counts = counts[:real]
        # each count is c/R in float32 with c a whole number far below
        # 2**24, so c is recovered exactly by rounding
        hops = (counts.to(torch.float64) * float(iterations)).round().sum()
        visits = hops.to(torch.int64) - real * iterations
        yield s, counts, visits, abandoned[:real].sum()


def walk_baskets(
    graph,
    L: int,
    iterations: int,
    damping: float,
    seed: int | None = None,
    source_chunk: int | None = None,
    max_steps: int | None = None,
    slots: int | None = None,
    return_info: bool = False,
    engine: str = "auto",
    mesh=None,
    stratified: bool = False,
    merge_algo: str | None = None,
    device=None,
):
    """Top-L walk baskets ``[N, L]`` for every node of the graph.

    ``iterations`` is R, the worst-case walks per node
    (include/mccompletepathv2.h:186).  ``return_info=True`` also returns
    ``{"walk_steps": v, "abandoned_walks": a, "total_walks": t}``: hops that
    deposited a visit, walks cut off by the step horizon, and the walks
    launched (``floor(R*damping)`` per non-dangling source; the
    reference's do-while never truncates, mccompletepathv2.h:142-155, so
    ``a/t`` is the divergence).

    ``engine``: ``"trace"`` (``"auto"``) or ``"counts"`` (see the module
    doc); ``max_steps`` applies to the counts engine.  ``merge_algo`` is
    the trace top-L's pipeline (None: the kernel on CUDA).  ``device``:
    None means ``"cuda"``.  ``mesh`` shards the sources
    (:func:`walk_trace_basket_chunks`; the trace engine) and puts the
    result on its first shard's device.
    """
    baskets, read_info = walk_rows(graph, L, iterations, damping, seed, source_chunk,
                                   max_steps, slots, engine, mesh, stratified,
                                   merge_algo, device)
    return (baskets, read_info()) if return_info else baskets


def walk_rows(graph, L, iterations, damping, seed, source_chunk, max_steps, slots,
              engine, mesh, stratified, merge_algo, device):
    """:func:`walk_baskets`' walks: returns the baskets and a function that
    reads their counters, ``walk_baskets``' info, in one transfer.  MC's
    pipeline (models/mccompletepathv2.py) reads them after its combine, so
    that transfer's wait does not stand between the walks and the combine."""
    dev = resolve_device(device) if mesh is None else mesh.devices[0]
    n = graph.num_nodes
    if engine == "auto" or mesh is not None:
        engine = "trace"
    if engine not in ("counts", "trace"):
        raise ValueError(f"unknown walk engine {engine!r}")
    ids_parts, score_parts = [], []
    # per-chunk counters stay on the device until one transfer at the end
    visit_parts, abandoned_parts = [], []
    if engine == "trace":
        for _, top, v, a in walk_trace_basket_chunks(
            graph, L, iterations, damping, seed=seed,
            source_chunk=source_chunk, slots=slots, stratified=stratified,
            merge_algo=merge_algo, device=dev, mesh=mesh,
        ):
            visit_parts.append(v)
            abandoned_parts.append(a)
            ids_parts.append(top.ids)
            score_parts.append(top.scores)
    else:
        for _, counts, v, a in walk_count_chunks(
            graph, iterations, damping, seed=seed, source_chunk=source_chunk,
            max_steps=max_steps, slots=slots, stratified=stratified,
            device=dev,
        ):
            visit_parts.append(v)
            abandoned_parts.append(a)
            ids = torch.arange(n, dtype=torch.int32, device=dev).expand(counts.shape)
            ids = torch.where(counts > 0, ids, SENTINEL)
            top = keep_top(ids, counts, L)
            ids_parts.append(top.ids)
            score_parts.append(top.scores)

    if not ids_parts:
        return empty_baskets(0, L, dev), lambda: {
            "walk_steps": 0, "abandoned_walks": 0, "total_walks": 0}
    # dangling sources: exactly {v: 1.0} (mccompletepathv2.h:162-163), from
    # the count normalisation, since their only count is R at themselves
    baskets = Baskets(torch.cat(ids_parts, dim=0), torch.cat(score_parts, dim=0))

    def read_info():
        totals = torch.stack([torch.stack(visit_parts), torch.stack(abandoned_parts)])
        visits, abandoned = (int(x) for x in totals.sum(dim=1).cpu())
        return {
            "walk_steps": visits,
            "abandoned_walks": abandoned,
            "total_walks": int(iterations * damping) * int((graph.out_degree > 0).sum()),
        }

    return baskets, read_info
