"""The plain reference against the program on the CPU at small sizes, and
the control that the checks' limits must catch."""

import json
import os
import sys

import numpy as np
import pytest
import torch

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(BENCH))

import approximated_personalized_pagerank_tpu_torch as pt  # noqa: E402
from ppr_bench.graphs import eat, powerlaw  # noqa: E402
from ppr_bench.reference import compare  # noqa: E402
from ppr_bench.reference import grank as ref  # noqa: E402

SMALL = {"nodes": 160, "edges": 900, "alpha": 1.9, "locality": 0.8, "community_size": 64}
TINY = {"nodes": 3000, "edges": 30000, "alpha": 1.9, "locality": 0.8, "community_size": 256}


def _graph(edges):
    return pt.Graph.from_edges(edges.src.numpy(), edges.dst.numpy(), num_nodes=edges.num_nodes)


@pytest.mark.parametrize("seed", [1, 2, 2**31 + 11])
def test_partition_is_the_programs(seed):
    e = powerlaw.make(TINY, seed, "cpu")
    assert np.array_equal(ref.partition(e.num_nodes, e.src, e.dst).numpy(), _graph(e).partition)


def test_partition_on_eat_is_the_programs():
    e = eat.make({"nodes": 23132, "edges": 312310}, 3, "cpu")
    assert np.array_equal(ref.partition(e.num_nodes, e.src, e.dst).numpy(), _graph(e).partition)


@pytest.mark.parametrize("seed,iterations,tol", [(1, 30, 1e-4), (2, 7, -1.0), (3, 40, 1e-4)])
def test_untruncated_grank_matches_the_program(seed, iterations, tol):
    """At L >= |V| nothing is cut, so the two agree up to float32 rounding."""
    e = powerlaw.make(SMALL, seed, "cpu")
    n = e.num_nodes
    out, info = pt.grank_baskets(_graph(e), n, n, iterations, 0.85, tol, engine="sparse",
                                 return_info=True, device="cpu")
    r = ref.grank(n, e.src, e.dst, n, n, iterations, 0.85, tol, budget=1 << 12)
    assert r.iterations_ran == info["iterations_ran"]
    gaps = compare.basket_gaps(out.ids, out.scores, r.ids, r.scores)
    assert gaps["rank_score_gap"] < 1e-6 and gaps["id_score_gap"] < 1e-6, gaps


def test_dangling_rows_and_blocks():
    """A node without successors keeps {v: 1-d}; the result does not depend
    on how rows are blocked."""
    src = torch.tensor([0, 0, 1, 2, 2, 2], dtype=torch.int64)
    dst = torch.tensor([1, 2, 2, 0, 3, 3], dtype=torch.int64)
    a = ref.grank(5, src, dst, 5, 5, 20, 0.85, -1.0)
    b = ref.grank(5, src, dst, 5, 5, 20, 0.85, -1.0, budget=1)
    assert torch.equal(a.ids, b.ids) and torch.equal(a.scores, b.scores)
    for v in (3, 4):
        assert a.ids[v, 0] == v and abs(float(a.scores[v, 0]) - 0.15) < 1e-7
        assert (a.ids[v, 1:] == -1).all()


def test_the_control_fails_the_cells_limits():
    """The reference in bfloat16, put in the program's place, reads above
    a limit of every GRank cell (PERF.md has the readings on the card)."""
    e = powerlaw.make(TINY, 4, "cpu")
    args = (e.num_nodes, e.src, e.dst, 50, 100, 30, 0.85, 1e-4)
    r32 = ref.grank(*args)
    r16 = ref.grank(*args, dtype=torch.bfloat16)
    gaps = compare.basket_gaps(r16.ids[:, :50].contiguous(), r16.scores[:, :50].contiguous(),
                               r32.ids, r32.scores)
    for cell in ("eat-grank",):
        with open(os.path.join(BENCH, "workloads", f"{cell}.json")) as f:
            limits = json.load(f)["limits"]
        assert any(gaps[k] > v for k, v in limits.items()), (cell, gaps, limits)


def test_well_formed_rejects_broken_results():
    ids = torch.tensor([[2, 0, -1], [1, 2, 0], [2, -1, -1]], dtype=torch.int32)
    sc = torch.tensor([[0.5, 0.2, 0.0], [0.4, 0.3, 0.1], [0.15, 0.0, 0.0]])
    assert compare.well_formed(ids, sc, 3, 3)
    assert not compare.well_formed(ids, sc.flip(1), 3, 3)
    bad = ids.clone()
    bad[2, 2] = 1  # a live id after padding
    assert not compare.well_formed(bad, sc, 3, 3)
    bad = ids.clone()
    bad[1, 2] = 1  # an id twice in a row
    assert not compare.well_formed(bad, sc, 3, 3)
    bad = ids.clone()
    bad[1, 0] = 3  # out of range
    assert not compare.well_formed(bad, sc, 3, 3)


def test_gaps_see_an_altered_id():
    ids = torch.tensor([[0, 1, 2]], dtype=torch.int32)
    sc = torch.tensor([[0.5, 0.3, 0.1]])
    ref_ids = torch.tensor([[0, 1, 2, 3]], dtype=torch.int32)
    ref_sc = torch.tensor([[0.5, 0.3, 0.1, 0.05]])
    assert compare.basket_gaps(ids, sc, ref_ids, ref_sc)["id_score_gap"] == 0.0
    alt = ids.clone()
    alt[0, 1] = 3
    g = compare.basket_gaps(alt, sc, ref_ids, ref_sc)
    assert g["rank_score_gap"] == 0.0 and abs(g["id_score_gap"] - 0.25) < 1e-7
