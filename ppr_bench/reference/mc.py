"""Plain MCCompletePathV2, the benchmark's reference for MC cells: every
node's top-K from shared Monte-Carlo walks, in plain PyTorch on any device.

The semantics are the reference library's (``ppr::mccompletepathv2``,
include/mccompletepathv2.h:115-258), written out again from the edge
arrays alone.  Nothing here is imported from the program under test.

**The walks** (mccompletepathv2.h:115-165).  A source with successors runs
``total = floor(R * damping)`` walks: the teleport before the first edge is
accounted for by thinning, so a walk always takes its first edge, and after
each edge it goes on while ``u <= damping``.  A successor is chosen as
``floor(u * deg)`` (at most ``deg - 1``), the float32 product truncated.
A source without successors walks nothing.  Every walk counts its source
once, with the original R: a source's row is ``R`` at itself plus one for
every edge taken, divided by R, so a dangling source's row is ``{v: 1.0}``.

The walks of one source are run by a cohort of ``slots`` walkers: slot
``s < min(slots, total)`` starts walk ``s``, and the source's other walks
are a pool.  At each hop every live walker steps (a visit), or, standing
on a node without successors, is stranded (no visit) and its walk ends; a
walker that stepped ends its walk when ``u2 > damping``.  Walkers whose
walk ended claim the pool's walks in slot order and start from the source
at the next hop.  After ``macro_steps * unroll`` hops (the horizon) the
walks still running or never started are abandoned.

**The stream.**  Every number is a threefry-2x32 draw, as ``jax.random``
makes it (:func:`threefry2x32`, :func:`fold_in`, :func:`split`,
:func:`uniform_from_bits`).  The root key is ``(0, seed mod 2**32)``.  The
sources run in chunks of ``chunk`` consecutive ids (:func:`trace_plan`);
chunk ``c``'s key is ``fold_in(root, c * chunk)``.  Macro step ``t`` of
``unroll`` hops draws ``(k_choice, k_cont) = split(fold_in(chunk key,
t))``; the walker in slot ``s`` of the ``r``-th source of its chunk, at
hop ``h`` of the macro step, draws ``u`` and ``u2`` at flat index ``(h *
chunk + r) * slots + s`` under ``k_choice`` and ``k_cont``.

**The combine** (mccompletepathv2.h:211-250), over all nodes at once:
``map_v = {v: 1/factor_v} + sum over successors s (each parallel edge
once) of row_s``, then ``keepTop(L)`` (every entry at or above the row's
L-th largest, ties at the cut kept), then ``* factor_v``, with ``factor_v
= damping / outdeg(v)``, 1 for a node without successors.  The first pass
reads the walks' rows, each cut to its top L (equal counts by lower id);
each later pass reads the pass before.  The result is each row's top L
after the last pass, equal scores by lower id.  Products and sums are
float64; ``dtype`` rounds the products' inputs (the adjacency and the
rows) to a lower dtype first, once a pass: the control.

**Departures from the C++ reference**, the program's own:

* a seeded counter-based stream in place of mt19937 seeded from entropy
  (mccompletepathv2.h:32-34): the same seed gives the same walks;
* uniform successor choice in place of the serial rotating index
  (mccompletepathv2.h:142-151);
* no in-walk L cap: full visit counts are kept, then cut to the top L
  (mccompletepathv2.h:152-153 drops visits past L distinct nodes);
* the combine runs ``passes`` (2) passes over all nodes at once, in place
  of one pass in the reference's execution order (mccompletepathv2.h:
  36-113, 230-234), whose combined successors feed later nodes;
* walks cut at the cohort's horizon (the reference's do-while never
  ends early): a sub-percent share, counted as ``abandoned_walks``.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

SENTINEL = -1
MASK32 = 0xFFFFFFFF
UNROLL = 32  # hops a macro step
# Rows of an [N, N] matrix taken at once by a cut; bounds its temporaries.
BLOCK_ELEMS = 1 << 25


# --------------------------------------------------------------------------
# threefry-2x32 and the jax.random functions built on it, on int64 tensors
# holding 32-bit words.
# --------------------------------------------------------------------------


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32, 20 rounds (Salmon et al., SC'11), of the counter words
    ``(x0, x1)`` under the key ``(k0, k1)``; tensors broadcast together."""

    def rounds(a, b, rotations):
        for r in rotations:
            a = (a + b) & MASK32
            b = (((b << r) | (b >> (32 - r))) & MASK32) ^ a
        return a, b

    k2 = k0 ^ k1 ^ 0x1BD11BDA
    keys = (k0, k1, k2)
    x0 = (x0 + k0) & MASK32
    x1 = (x1 + k1) & MASK32
    for i in range(1, 6):
        x0, x1 = rounds(x0, x1, (13, 15, 26, 6) if i % 2 else (17, 29, 16, 24))
        x0 = (x0 + keys[i % 3]) & MASK32
        x1 = (x1 + keys[(i + 1) % 3] + i) & MASK32
    return x0, x1


def root_key(seed: int, device="cpu") -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.random.PRNGKey(seed)`` without 64-bit mode: ``(0, seed mod
    2**32)``, as two 0-d int64 word tensors."""
    w = lambda v: torch.tensor(v, dtype=torch.int64, device=device)  # noqa: E731
    return w(0), w(int(seed) & MASK32)


def fold_in(key, data):
    """``jax.random.fold_in``: the hash of the counter ``(0, data)``;
    ``data`` an int or an int64 tensor of values below 2**32."""
    k0, k1 = key
    return threefry2x32(k0, k1, torch.zeros_like(torch.as_tensor(data, device=k0.device)),
                        torch.as_tensor(data, device=k0.device))


def split(key, num: int = 2):
    """``jax.random.split`` (partitionable): key ``i`` is the hash of the
    counter ``(i >> 32, i & 0xFFFFFFFF)``; a list of ``num`` keys."""
    k0, k1 = key
    i = torch.arange(num, dtype=torch.int64, device=k0.device)
    shape = (num,) + (1,) * k0.dim()
    a, b = threefry2x32(k0, k1, (i >> 32).reshape(shape), (i & MASK32).reshape(shape))
    return [(a[j], b[j]) for j in range(num)]


def random_bits(key, index: torch.Tensor) -> torch.Tensor:
    """``jax.random.bits`` (partitionable) at flat positions ``index``:
    the two words of the hash of ``(index >> 32, index & 0xFFFFFFFF)``,
    xored."""
    a, b = threefry2x32(key[0], key[1], index >> 32, index & MASK32)
    return a ^ b


def uniform_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """``jax.random.uniform``'s float32 in [0, 1) from 32 bits: the top 23
    as the mantissa of a float in [1, 2), minus 1."""
    return (((bits >> 9) | 0x3F800000).to(torch.int32)).view(torch.float32) - 1.0


# --------------------------------------------------------------------------
# The plan: chunk, slots, total, horizon and macro steps.
# --------------------------------------------------------------------------


class Plan(NamedTuple):
    chunk: int  # sources a chunk (its key is folded from its first source)
    slots: int  # walkers a source
    total: int  # floor(R * damping) walks a source with successors
    macro_steps: int  # macro steps of UNROLL hops: the horizon
    width: int  # macro_steps * UNROLL * slots: hops of a source's cohort


def horizon(total: int, slots: int, damping: float) -> int:
    """Hops a cohort runs: a slot's share of the pool, ``q = ceil(total /
    slots)`` geometric walks back to back, has mean ``q / (1 - d)`` and
    standard deviation ``sqrt(q d) / (1 - d)``; the horizon is the mean
    plus 1.5 deviations, rounded up, plus 8, and at least 4."""
    if damping <= 0:
        return 1
    if damping >= 1:
        return 10_000
    q = -(-total // max(slots, 1))
    mean = q / (1.0 - damping)
    dev = math.sqrt(q * damping) / (1.0 - damping)
    return max(4, int(math.ceil(mean + 1.5 * dev)) + 8)


def trace_plan(num_nodes: int, R: int, damping: float, unroll: int = UNROLL) -> Plan:
    """The walks' plan for an ``num_nodes``-node graph at R walks a node.

    * slots: from 16 (or ``total`` if fewer) down by at most 8, the count
      whose cohort row, ``ceil(horizon / unroll) * unroll * slots`` hops,
      pads to the least power of two above it; among equals the most
      slots, then the narrowest row;
    * chunk: ``64 Mi // width`` sources, between 8 and 512 (up to 32,768
      above 65,536 nodes), at most the node count, and at most 16 merge
      blocks of ``4 Mi // (width + 1)`` rows (a multiple of 8 from 8 up).
    """
    total = int(R * damping)
    best = None
    top = int(min(16, max(total, 1)))
    for slots in range(top, max(top - 9, 0), -1):
        macro = -(-horizon(total, slots, damping) // max(unroll, 1))
        width = macro * unroll * slots
        rank = (1 << width.bit_length(), -slots, width)
        if best is None or rank < best[0]:
            best = (rank, slots)
    slots = max(1, min(best[1], max(total, 1)))
    macro = -(-horizon(total, slots, damping) // max(unroll, 1))
    width = macro * unroll * slots
    cap = 512 if num_nodes <= 65536 else 32768
    chunk = min(int(max(8, min(cap, (64 << 20) // max(width, 1)))), max(num_nodes, 1))
    block = int(max(1, min(chunk, (1 << 22) // (width + 1))))
    if block >= 8:
        block -= block % 8
    return Plan(min(chunk, 16 * block), slots, total, macro, width)


# --------------------------------------------------------------------------
# The walks.
# --------------------------------------------------------------------------


class Walks(NamedTuple):
    counts: torch.Tensor  # int32[N, N]: R at each source plus one a visit
    walk_steps: int  # hops that deposited a visit
    abandoned_walks: int  # walks running or unstarted at the horizon


def csr(num_nodes: int, src: torch.Tensor, dst: torch.Tensor):
    """(first edge int64[N], successors int64[E], out-degree int64[N]); the
    successors of a node keep the order of the edge arrays."""
    order = torch.argsort(src, stable=True)
    deg = torch.bincount(src, minlength=num_nodes)
    first = torch.cumsum(deg, 0) - deg
    return first, dst[order], deg


def walks(num_nodes: int, src: torch.Tensor, dst: torch.Tensor, R: int, damping: float,
          seed: int, unroll: int = UNROLL) -> Walks:
    """Every source's walks (module doc), all sources' cohorts at once, on
    the edges' device."""
    n = num_nodes
    dev = src.device
    plan = trace_plan(n, R, damping, unroll)
    first, succ, deg = csr(n, src, dst)
    counts = torch.zeros((n, n), dtype=torch.int32, device=dev)
    node = torch.arange(n, device=dev)
    counts[node, node] = int(R)
    S, C = plan.slots, plan.chunk
    pos = node % C  # a source's row in its chunk
    home = node[:, None].expand(n, S)
    has = deg > 0
    alive = has[:, None] & (torch.arange(S, device=dev) < plan.total)[None, :]
    pool = has.to(torch.int64) * max(plan.total - S, 0)
    at = home.clone()
    steps = torch.zeros((), dtype=torch.int64, device=dev)
    if succ.numel() == 0:
        return Walks(counts, 0, int(alive.sum() + pool.sum()))
    d32 = torch.tensor(damping, dtype=torch.float32, device=dev)
    chunk_of = node // C
    starts = torch.arange(0, n, C, dtype=torch.int64, device=dev)
    ckey = fold_in(root_key(seed, dev), starts)  # [chunks]
    index = ((torch.arange(unroll, device=dev)[:, None, None] * C + pos[None, :, None]) * S
             + torch.arange(S, device=dev)[None, None, :])  # [unroll, N, S]
    for t in range(plan.macro_steps):
        k_choice, k_cont = split(fold_in(ckey, t))
        u_all, u2_all = (uniform_from_bits(random_bits(
            (k[0][chunk_of][None, :, None], k[1][chunk_of][None, :, None]), index))
            for k in (k_choice, k_cont))
        for h in range(unroll):
            d = deg[at]
            stranded = d == 0
            moving = alive & ~stranded
            j = torch.minimum((u_all[h] * d.to(torch.float32)).to(torch.int64),
                              (d - 1).clamp(min=0))
            to = succ[(first[at] + j).clamp(0, succ.numel() - 1)]
            rows, cols = home[moving], to[moving]
            counts.view(-1).index_add_(0, rows * n + cols,
                                       torch.ones_like(rows, dtype=torch.int32))
            steps += moving.sum()
            ended = alive & (stranded | (u2_all[h] > d32))
            claims = torch.cumsum(ended.to(torch.int64), dim=1)
            again = ended & (claims <= pool[:, None])
            pool = (pool - claims[:, -1]).clamp(min=0)
            alive = (alive & ~ended) | again
            at = torch.where(moving & ~ended, to, home)
    return Walks(counts, int(steps), int(alive.sum() + pool.sum()))


def _row_blocks(n: int, width: int):
    rows = max(1, BLOCK_ELEMS // max(width, 1))
    return ((a, min(n, a + rows)) for a in range(0, n, rows))


def top_rows(values: torch.Tensor, L: int):
    """Each row's top ``L`` positive entries of ``values`` ``[N, M]`` by
    descending value, equal values by lower column: (int32 ids, float64
    scores) ``[N, L]``, -1 / 0 padded.  Exact on integers and floats alike:
    rows are ranked by a stable sort."""
    n, m = values.shape
    L = min(L, m)
    ids = torch.full((n, L), SENTINEL, dtype=torch.int32, device=values.device)
    scores = torch.zeros((n, L), dtype=torch.float64, device=values.device)
    for a, b in _row_blocks(n, m):
        v = values[a:b].to(torch.float64)
        top, col = torch.sort(v, dim=1, descending=True, stable=True)
        top, col = top[:, :L], col[:, :L]
        live = top > 0
        ids[a:b] = torch.where(live, col, SENTINEL).to(torch.int32)
        scores[a:b] = torch.where(live, top, 0.0)
    return ids, scores


# --------------------------------------------------------------------------
# The combine.
# --------------------------------------------------------------------------


def _keep_top(C: torch.Tensor, L: int) -> None:
    """``keepTop(L)`` in place: zero every entry below its row's L-th
    largest value (ties at the cut stay)."""
    if L >= C.shape[1]:
        return
    for a, b in _row_blocks(C.shape[0], C.shape[1]):
        block = C[a:b]
        kth = torch.topk(block, L, dim=1).values[:, -1:]
        block.masked_fill_(block < kth, 0.0)


def combine(num_nodes: int, src: torch.Tensor, dst: torch.Tensor, rows: torch.Tensor,
            L: int, damping: float, passes: int, dtype=None) -> torch.Tensor:
    """``passes`` combine passes (module doc) over the walks' rows (float64
    ``[N, N]``, each cut to its top L); returns the last pass's float64
    ``[N, N]`` rows.  ``dtype`` rounds the products' inputs to it."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    n = num_nodes
    dev = rows.device
    A = torch.zeros((n, n), dtype=torch.float64, device=dev)
    A.index_put_((src, dst), torch.ones(src.shape, dtype=torch.float64, device=dev),
                 accumulate=True)
    deg = torch.bincount(src, minlength=n).to(torch.float64)
    factor = torch.where(deg > 0, damping / deg.clamp(min=1), torch.ones_like(deg))
    rnd = (lambda x: x.to(dtype).to(torch.float64)) if dtype is not None else (lambda x: x)
    A = rnd(A)
    node = torch.arange(n, device=dev)
    S = rows
    for _ in range(passes):
        C = A @ rnd(S)
        C[node, node] += 1.0 / factor
        _keep_top(C, L)
        C *= factor[:, None]
        S = C
    return S


class McResult(NamedTuple):
    ids: torch.Tensor  # int32[N, L], rows by descending score, -1 padded
    scores: torch.Tensor  # float64[N, L], 0 in empty slots
    walk_steps: int
    abandoned_walks: int


def walk_rows(w: Walks, R: int, L: int) -> torch.Tensor:
    """The walks' rows for the combine: each source's counts cut to its top
    L (equal counts by lower id), over R, as float64 ``[N, N]``."""
    n = w.counts.shape[0]
    ids, counts = top_rows(w.counts, L)
    rows = torch.zeros((n, n), dtype=torch.float64, device=w.counts.device)
    live = ids >= 0
    r = torch.arange(n, device=ids.device)[:, None].expand_as(ids)
    rows[r[live], ids[live].long()] = counts[live] / float(R)
    return rows


def mccompletepathv2(num_nodes: int, src: torch.Tensor, dst: torch.Tensor, L: int, R: int,
                     damping: float, seed: int, passes: int = 2, dtype=None,
                     w: Walks | None = None) -> McResult:
    """Plain MCCompletePathV2 on the edges' device (module doc): each node's
    top ``L`` (``min(L, N)``) after the combine, so a result's first K
    columns are its top K.  ``w``: walks already run for these arguments
    (the control reuses the reference's); ``dtype``: the combine's product
    inputs rounded to it."""
    n = num_nodes
    L = min(L, n)
    w = walks(n, src, dst, R, damping, seed) if w is None else w
    final = combine(n, src, dst, walk_rows(w, R, L), L, damping, passes, dtype)
    ids, scores = top_rows(final, L)
    return McResult(ids, scores, w.walk_steps, w.abandoned_walks)
