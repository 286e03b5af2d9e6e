"""The port's public surface against the JAX package's: ``Graph.to_dict``,
the top-level ``device_graph`` and ``grank_baskets(host_loop=)``."""

import inspect

import numpy as np
import torch

import approximated_personalized_pagerank_tpu as pj

import approximated_personalized_pagerank_tpu_torch as pt

ADJ = {"a": ["b", "c"], "b": ["c"], "c": ["a", "d"], "d": [], "e": ["a", "a", "c"]}


def test_to_dict_equals_jax(rng):
    gj, gt = pj.Graph.from_dict(ADJ), pt.Graph.from_dict(ADJ)
    assert gt.to_dict() == gj.to_dict()
    assert gt.to_dict()["e"] == ["a", "a", "c"] and gt.to_dict()["d"] == []
    src, dst = rng.integers(0, 50, 300), rng.integers(0, 50, 300)
    gj, gt = pj.Graph.from_edges(src, dst, num_nodes=60), pt.Graph.from_edges(src, dst, num_nodes=60)
    assert gt.to_dict() == gj.to_dict()
    assert pt.Graph.from_dict(gt.to_dict()).to_dict() == gt.to_dict()


def test_device_graph_exported_and_equal_to_jax(rng):
    assert "device_graph" in pt.__all__ and "device_graph" in pj.__all__
    assert inspect.signature(pt.device_graph).parameters["device"].default == "cuda"
    src, dst = rng.integers(0, 40, 200), rng.integers(0, 40, 200)
    gj, gt = pj.Graph.from_edges(src, dst, num_nodes=45), pt.Graph.from_edges(src, dst, num_nodes=45)
    dt, dj = pt.device_graph(gt, "cpu"), pj.device_graph(gj)
    assert dt is gt.device_graph("cpu")  # cached on the graph
    assert np.array_equal(dt.start_deg[:, 0].numpy(), np.asarray(dj.indptr)[:-1])
    assert np.array_equal(dt.start_deg[:, 1].numpy(), np.asarray(dj.out_degree))
    assert np.array_equal(dt.indices.numpy(), np.asarray(dj.indices))


def test_grank_host_loop_means_sparse_under_auto():
    gj, gt = pj.Graph.from_dict(ADJ), pt.Graph.from_dict(ADJ)
    args = (5, 5, 6, 0.85, 1e-4)
    params = list(inspect.signature(pt.grank_baskets).parameters)
    assert params[:6] == ["graph", "K", "L", "iterations", "damping", "tolerance"]
    host, info = pt.grank_baskets(gt, *args, host_loop=True, device="cpu", return_info=True)
    sparse, s_info = pt.grank_baskets(gt, *args, engine="sparse", device="cpu",
                                      return_info=True)
    assert torch.equal(host.ids, sparse.ids) and torch.equal(host.scores, sparse.scores)
    assert info == s_info
    dense = pt.grank_baskets(gt, *args, engine="dense", device="cpu")
    auto = pt.grank_baskets(gt, *args, host_loop=False, device="cpu")
    assert torch.equal(auto.ids, dense.ids) and torch.equal(auto.scores, dense.scores)
    ref = pj.grank_baskets(gj, *args, host_loop=True, merge_algo="sort")
    ref_ids, ref_sc = np.asarray(ref.ids), np.asarray(ref.scores)
    for r in range(gt.num_nodes):
        live = ref_ids[r] >= 0
        got = dict(zip(host.ids[r].tolist(), host.scores[r].tolist()))
        assert set(got) - {-1} == set(ref_ids[r][live].tolist())
        for i, s in zip(ref_ids[r][live].tolist(), ref_sc[r][live].tolist()):
            assert abs(got[i] - s) <= 1e-6
