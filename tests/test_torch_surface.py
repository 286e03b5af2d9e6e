"""The port's public surface against the JAX package's: ``Graph.to_dict``,
the top-level ``device_graph``, ``grank_baskets(host_loop=)``, the
entry points' positional order and ``Baskets.sizes()``."""

import inspect

import numpy as np
import pytest
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


def _positional(fn):
    return [(p.name, p.default) for p in inspect.signature(fn).parameters.values()
            if p.kind == p.POSITIONAL_OR_KEYWORD]


def _surface():
    """Every callable both packages export, and the walk entry points."""
    from approximated_personalized_pagerank_tpu.ops import walk as j_walk

    from approximated_personalized_pagerank_tpu_torch.ops import walk as t_walk

    pairs = [(n, getattr(pj, n), getattr(pt, n)) for n in sorted(set(pj.__all__) & set(pt.__all__))
             if callable(getattr(pj, n))]
    pairs += [(f"ops.walk.{n}", getattr(j_walk, n), getattr(t_walk, n))
              for n in ("walk_baskets", "walk_trace_basket_chunks")]
    return pairs


SURFACE = _surface()


@pytest.mark.parametrize("name,jax_fn,port_fn", SURFACE, ids=[s[0] for s in SURFACE])
def test_jax_positional_order_is_a_prefix_of_the_port(name, jax_fn, port_fn):
    """A call valid in the JAX package, positional arguments included, is
    valid in the port: JAX's positional-or-keyword parameters, in order and
    with their defaults, lead the port's; port-only ones come after."""
    jax_params = _positional(jax_fn)
    assert _positional(port_fn)[:len(jax_params)] == jax_params


POSITIONAL_CALLS = {
    # grank(..., elem_budget, engine)
    "grank": (lambda g: pt.grank(g, 5, 5, 6, 0.85, 1e-4, 1 << 22, "sparse", device="cpu"),
              lambda g: pt.grank(g, 5, 5, 6, 0.85, 1e-4, elem_budget=1 << 22, engine="sparse",
                                 device="cpu")),
    # grank_baskets(..., elem_budget, mesh, host_loop)
    "grank_baskets": (
        lambda g: pt.grank_baskets(g, 5, 5, 6, 0.85, 1e-4, 1 << 22, None, True, device="cpu"),
        lambda g: pt.grank_baskets(g, 5, 5, 6, 0.85, 1e-4, elem_budget=1 << 22, mesh=None,
                                   host_loop=True, device="cpu")),
}


@pytest.mark.parametrize("name", sorted(POSITIONAL_CALLS))
def test_jax_positional_calls_run_on_the_port(name):
    gt = pt.Graph.from_dict(ADJ)
    positional, keyword = POSITIONAL_CALLS[name]
    a, b = positional(gt), keyword(gt)
    if name == "grank":
        assert a == b and a
        return
    assert torch.equal(a.ids, b.ids) and torch.equal(a.scores, b.scores)
    sparse = pt.grank_baskets(gt, 5, 5, 6, 0.85, 1e-4, engine="sparse", device="cpu")
    assert torch.equal(a.ids, sparse.ids) and torch.equal(a.scores, sparse.scores)


@pytest.mark.parametrize("shape", [(7, 5), (3, 4, 6), (2, 1)])
def test_basket_sizes_equal_jax(rng, shape):
    from approximated_personalized_pagerank_tpu.ops.basket import Baskets as JBaskets

    ids = rng.integers(-1, 9, shape).astype(np.int32)
    ids[0] = -1  # an empty row
    scores = rng.random(shape).astype(np.float32)
    got = pt.Baskets(torch.as_tensor(ids), torch.as_tensor(scores)).sizes()
    want = np.asarray(JBaskets(ids, scores).sizes())
    assert got.shape == want.shape and np.array_equal(got.numpy(), want)
