"""The port's host layer against the JAX package: graphs, partitions and
merge plans must be byte-equal, so both packages sweep the same rows in the
same buckets.  Everything here is numpy; no tolerance applies."""

import numpy as np
import pytest
import torch

import approximated_personalized_pagerank_tpu as pj
from approximated_personalized_pagerank_tpu.utils import synthetic as j_synth

import approximated_personalized_pagerank_tpu_torch as pt
from approximated_personalized_pagerank_tpu_torch.utils import synthetic as t_synth
from approximated_personalized_pagerank_tpu_torch.utils.convert import (
    baskets_from_numpy,
    graph_from_arrays,
)
from approximated_personalized_pagerank_tpu_torch.utils.io import parse_edge_csv
from approximated_personalized_pagerank_tpu_torch.utils import validation

PLAN_ARGS = [(None, None), (40, 512), (100, 8192)]  # (L, net_width)


def _assert_same_graph(gj, gt):
    assert gt.num_nodes == gj.num_nodes and gt.num_edges == gj.num_edges
    assert np.array_equal(gt.indptr, gj.indptr)
    assert np.array_equal(gt.indices, gj.indices)
    assert gt.keys == gj.keys


def _assert_same_plans(gj, gt):
    assert gt.partition.dtype == gj.partition.dtype
    assert gt.partition.tobytes() == gj.partition.tobytes()
    for L, net in PLAN_ARGS:
        for p in (0, 1, None):
            pj_, pt_ = gj.merge_plan(p, L=L, net_width=net), gt.merge_plan(p, L=L, net_width=net)
            assert pt_.dangling_rows.tobytes() == pj_.dangling_rows.tobytes()
            assert len(pt_.buckets) == len(pj_.buckets)
            for bj, bt in zip(pj_.buckets, pt_.buckets):
                assert bt.cap == bj.cap
                assert bt.rows.dtype == bj.rows.dtype and bt.succ.dtype == bj.succ.dtype
                assert bt.rows.tobytes() == bj.rows.tobytes()
                assert bt.succ.tobytes() == bj.succ.tobytes()


@pytest.fixture(scope="module")
def eat_pair():
    return pj.load_eat_graph(), pt.load_eat_graph()


def test_eat_graph_path_is_the_bundled_file():
    assert pt.eat_graph_path() == pj.eat_graph_path()


def test_eat_graph_partition_and_plans_byte_equal(eat_pair):
    gj, gt = eat_pair
    assert (gt.num_nodes, gt.num_edges) == (23132, 312310)
    _assert_same_graph(gj, gt)
    _assert_same_plans(gj, gt)


def test_powerlaw_graph_bit_equal_and_plans_byte_equal():
    gj = j_synth.powerlaw_graph(3000, 30000, seed=7, locality=0.8)
    gt = t_synth.powerlaw_graph(3000, 30000, seed=7, locality=0.8)
    _assert_same_graph(gj, gt)
    # hub buckets (multiple-of-sub caps) exist at net_width=512, L=40
    assert any(b.cap > 511 // 40 for b in gt.merge_plan(0, L=40, net_width=512).buckets)
    _assert_same_plans(gj, gt)


@pytest.mark.parametrize("kwargs", [{}, {"dedup": True, "alpha": 1.5}, {"locality": 0.3}])
def test_powerlaw_graph_same_edges_for_seed(kwargs):
    gj = j_synth.powerlaw_graph(500, 4000, seed=3, **kwargs)
    gt = t_synth.powerlaw_graph(500, 4000, seed=3, **kwargs)
    _assert_same_graph(gj, gt)


def test_from_dict_and_csc_equal(rng):
    adj = {f"n{i}": [f"n{j}" for j in rng.integers(0, 30, 4)] for i in range(25)}
    gj, gt = pj.Graph.from_dict(adj), pt.Graph.from_dict(adj)
    _assert_same_graph(gj, gt)
    assert all(np.array_equal(a, b) for a, b in zip(gt.csc, gj.csc))
    assert gt.key_to_id("n7") == gj.key_to_id("n7") and "n99" not in gt


def test_partition_small_cases_equal():
    for adj in ({}, {0: [], 1: []}, {0: [1, 2, 3], 1: [], 2: [], 3: []},
                {i: [(i + 1) % 6] for i in range(6)}):
        gj, gt = pj.Graph.from_dict(adj), pt.Graph.from_dict(adj)
        assert gt.partition.tobytes() == gj.partition.tobytes()


def test_csv_parsing_and_dedup(tmp_path):
    path = tmp_path / "g.csv"
    path.write_bytes(b"1,2\r\n2,3\n1,2\n4294967296,1\n3,7\n")
    gj, gt = pj.load_csv_graph(str(path)), pt.load_csv_graph(str(path))
    _assert_same_graph(gj, gt)
    assert gt.num_edges == 4 and gt.keys == [1, 2, 3, 4294967296, 7]
    src, dst = parse_edge_csv(str(path))
    assert src.tolist() == [1, 2, 1, 4294967296, 3] and dst.tolist() == [2, 3, 2, 1, 7]
    bad = tmp_path / "bad.csv"
    bad.write_bytes(b"1,2\n3\n")
    with pytest.raises(ValueError, match="odd number"):
        parse_edge_csv(str(bad))


def test_graph_rejects_malformed_csr():
    with pytest.raises(ValueError, match="out of range"):
        pt.Graph(np.array([0, 1]), np.array([5]))
    with pytest.raises(ValueError, match="malformed"):
        pt.Graph(np.array([1, 1]), np.array([0]))


def test_validation_messages():
    cases = [
        (lambda: validation.check_basket_params(0, 0), "K must be positive"),
        (lambda: validation.check_basket_params(1, 0), "L must be positive"),
        (lambda: validation.check_basket_params(5, 3), "K must be <= L"),
        (lambda: validation.check_iterations(0), "iterations must be positive"),
        (lambda: validation.check_damping(1.5), r"damping must be \[0,1\]"),
        (lambda: validation.check_test_nodes(0), "testNodes must be positive"),
    ]
    for fn, msg in cases:
        with pytest.raises(ValueError, match=msg):
            fn()


def test_convert_helpers(rng):
    gj = j_synth.powerlaw_graph(200, 1500, seed=1)
    _assert_same_graph(gj, graph_from_arrays(gj.indptr, gj.indices))
    ids = rng.integers(-1, 200, (200, 8)).astype(np.int64)
    scores = rng.random((200, 8))
    b = baskets_from_numpy(ids, scores, "cpu")
    assert b.ids.dtype == torch.int32 and b.scores.dtype == torch.float32
    assert np.array_equal(b.ids.numpy(), ids) and b.width == 8
    with pytest.raises(ValueError, match="one shape"):
        baskets_from_numpy(ids, scores[:, :4], "cpu")
