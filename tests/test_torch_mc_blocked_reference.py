"""The benchmark's plain MC reference in blocks
(``ppr_bench/reference/mc_blocked.py``) against the dense one
(``ppr_bench/reference/mc.py``) and the port, on the CPU at small sizes.

The blocked reference walks a chunk of the plan at a time and combines
sparse rows in blocks; on the same edges and seed its walk counters are
the dense reference's exactly, its walk rows bit for bit, and its baskets
the same within float64 rounding (R a power of two, where the dense
reference's sums of ``count / R`` are exact too), blocks smaller than the
graph included.  The port's sparse engine keeps within the
``northstar-mc`` cell's limits of it, and the bfloat16 control the limits
are set against fails one of them.
"""

import json
import os

import numpy as np
import pytest
import torch

import approximated_personalized_pagerank_tpu_torch as pt
from ppr_bench.algorithms import mc_blocked as adapter
from ppr_bench.reference import compare
from ppr_bench.reference import mc as dense
from ppr_bench.reference import mc_blocked as blk

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DAMPING = 0.85


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Both references run many small ops: with one intra-op thread they
    stay fast when the suite's workers share the cores (with a thread a
    core each, seven busy cores make this file ~10x slower)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _graph_edges(seed: int, n: int, e: int):
    """Random edges with self-loops, parallel edges and dangling nodes."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n, e)
    src = np.concatenate([src, [1, 1, 2, 2, 2]])
    dst = np.concatenate([dst, [1, 1, 5, 5, 5]])  # a doubled self-loop, a tripled edge
    keep = src % 5 != 3  # every node = 3 mod 5 has no successors
    return (torch.from_numpy(src[keep].astype(np.int64)),
            torch.from_numpy(dst[keep].astype(np.int64)))


def _dense_rows(rows: blk.Rows, n: int, scale: float) -> torch.Tensor:
    out = torch.zeros((n, n), dtype=torch.float64)
    row = torch.repeat_interleave(torch.arange(n), rows.length)
    out[row, rows.ids] = rows.values / scale
    return out


@pytest.mark.parametrize("seed,n,e,R,L", [(1, 60, 300, 40, 20), (2**31 + 7, 400, 4000, 200, 100)])
def test_the_walks_are_the_dense_references(seed, n, e, R, L):
    src, dst = _graph_edges(seed, n, e)
    w = dense.walks(n, src, dst, R, DAMPING, seed)
    b = blk.walks(n, src, dst, R, DAMPING, seed, L)
    assert (b.walk_steps, b.abandoned_walks) == (w.walk_steps, w.abandoned_walks)
    assert b.walk_steps > 0
    # the counts cut to the top L, equal counts by lower id, over R: bit for bit
    assert torch.equal(_dense_rows(b.rows, n, R), dense.walk_rows(w, R, L))


# (seed, nodes, edges, R, block_elems): R a power of two; the last case
# combines in blocks of a few rows
CASES = [(3, 300, 3000, 128, blk.BLOCK_ELEMS), (2**31 + 9, 500, 6000, 256, blk.BLOCK_ELEMS),
         (4, 400, 4000, 64, 3000)]


@pytest.mark.parametrize("seed,n,e,R,block_elems", CASES)
def test_the_baskets_are_the_dense_references(seed, n, e, R, block_elems, monkeypatch):
    src, dst = _graph_edges(seed, n, e)
    L = 100
    r = dense.mccompletepathv2(n, src, dst, L, R, DAMPING, seed)
    blocks = []
    real = blk._blocks
    monkeypatch.setattr(blk, "_blocks", lambda cost, budget: blocks.append(
        list(real(cost, budget))) or blocks[-1])
    b = blk.mccompletepathv2(n, src, dst, L, R, DAMPING, seed, block_elems=block_elems)
    assert len(blocks) == 2  # a pass each
    assert all(len(p) > 1 for p in blocks) == (block_elems < blk.BLOCK_ELEMS)
    assert (b.walk_steps, b.abandoned_walks) == (r.walk_steps, r.abandoned_walks)
    assert b.ids.shape == r.ids.shape == (n, L) and b.scores.dtype == torch.float64
    assert float((b.scores - r.scores).abs().max()) < 1e-15
    gaps = compare.basket_gaps(b.ids[:, :50].contiguous(), b.scores[:, :50].contiguous(),
                               r.ids, r.scores)
    assert gaps["rank_score_gap"] < 1e-15 and gaps["id_score_gap"] < 1e-15
    # ids differ only where two scores are within rounding of each other
    differ = b.ids != r.ids
    assert float(differ.float().mean()) < 0.01


def test_rows_with_ties_at_the_cut_keep_every_tied_id():
    # node 0 reaches 1..12 once each: twelve equal sums cut at L = 4
    n, L = 13, 4
    src = torch.tensor([0] * 12 + list(range(1, 13)))
    dst = torch.tensor(list(range(1, 13)) + list(range(1, 13)))
    edges = blk.distinct_edges(n, src, dst, DAMPING)
    walk = blk._rows_of(torch.arange(n), torch.arange(n), torch.full((n,), 8.0), n)
    out = blk.combine_pass(edges, walk, L, denominator=8.0)
    assert int(out.length[0]) == 1 + 12  # itself, then all twelve tied ids
    row0 = out.values[:13]
    assert row0[0] == (1.0 / (DAMPING / 12) + 0.0) * (DAMPING / 12)
    assert bool((row0[1:] == row0[1]).all()) and torch.equal(out.ids[1:13], torch.arange(1, 13))


@pytest.fixture(scope="module")
def cell():
    """The ``northstar-mc`` cell's job and limits on a 600-node graph of
    the benchmark's generator (a seventh of its nodes stripped of their
    successors), the blocked reference's result and the port's sparse
    engine's."""
    with open(os.path.join(ROOT, "ppr_bench", "workloads", "northstar-mc.json")) as f:
        wl = json.load(f)
    with open(os.path.join(ROOT, "ppr_bench", "configs", "northstar-mcv2.json")) as f:
        spec = dict(json.load(f)["graph"], nodes=600, edges=8600, community_size=64)
    job, limits = wl["job"], wl["limits"]
    from ppr_bench.graphs import powerlaw

    seed = 2**31 + 21
    edges = powerlaw.make(spec, seed, "cpu")
    keep = edges.src % 7 != 3  # and every node = 3 mod 7 without successors
    edges = powerlaw.Edges(edges.num_nodes, edges.src[keep], edges.dst[keep])
    n = edges.num_nodes
    w = blk.walks(n, edges.src, edges.dst, job["R"], job["damping"], seed, job["L"])
    r = adapter.reference(edges, job, seed, "cpu", walks=w)
    g = pt.Graph.from_edges(edges.src.numpy(), edges.dst.numpy(), num_nodes=n)
    out, info = pt.mccompletepathv2_baskets(g, job["K"], job["L"], job["R"], job["damping"],
                                            seed=seed, combine_passes=job["combine_passes"],
                                            engine="sparse", return_info=True, device="cpu")
    return dict(job=job, limits=limits, n=n, edges=edges, seed=seed, w=w, r=r, out=out,
                info=info, graph=g)


def test_the_ports_sparse_baskets_are_within_the_cells_limits(cell):
    out, job = cell["out"], cell["job"]
    checks = adapter.gaps(out.ids, out.scores, cell["info"], cell["r"], cell["n"], job["K"],
                          cell["limits"])
    assert set(cell["limits"]) < set(checks)
    assert all(v <= lim for v, lim in checks.values()), checks


def test_the_bfloat16_control_fails_a_limit(cell):
    job = cell["job"]
    c = adapter.reference(cell["edges"], job, cell["seed"], "cpu", dtype=torch.bfloat16,
                          walks=cell["w"])
    k = job["K"]
    ids, scores = c.ids[:, :k].contiguous(), c.scores[:, :k].float().contiguous()
    counters = {"walk_steps": c.walk_steps, "abandoned_walks": c.abandoned_walks}
    checks = adapter.gaps(ids, scores, counters, cell["r"], cell["n"], k, cell["limits"])
    # well formed, with the reference's own walks: it fails on the gaps alone
    assert checks["malformed"][0] == checks["walk_steps_gap"][0] == 0.0
    assert any(v > lim for name, (v, lim) in checks.items() if name in cell["limits"]), checks


def test_dangling_nodes_keep_themselves_through_the_combine(cell):
    r, out = cell["r"], cell["out"]
    dangling = torch.from_numpy(cell["graph"].out_degree == 0)
    assert int(dangling.sum()) > 0
    v = torch.arange(cell["n"], dtype=torch.int32)[dangling]
    for ids, scores in ((r.ids, r.scores), (out.ids, out.scores)):
        assert torch.equal(ids[dangling, 0], v) and bool((scores[dangling, 0] == 1.0).all())
        assert bool((ids[dangling, 1:] == -1).all())
