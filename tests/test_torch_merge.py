"""One merge sweep of the port against the JAX package from one shared state.

The JAX package runs GRank's init and its half-sweeps; its basket state
goes through ``utils/convert.py`` into the port, and both run the same next
half-sweep.  Starting both from one state removes the tie propagation that
a whole run accumulates, so the check is tight: ids equal up to equal
scores at the truncation boundary, scores within 1e-6 (summation order of
equal-id runs, rows of at most unit mass).  A small element budget splits
buckets into several chunks, the last one ragged.
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import approximated_personalized_pagerank_tpu as pj
from approximated_personalized_pagerank_tpu.ops import basket as jb
from approximated_personalized_pagerank_tpu.ops import merge as jm

import approximated_personalized_pagerank_tpu_torch as pt
from approximated_personalized_pagerank_tpu_torch.models.grank import _set_dangling
from approximated_personalized_pagerank_tpu_torch.ops import basket as tb
from approximated_personalized_pagerank_tpu_torch.ops import merge as tm
from approximated_personalized_pagerank_tpu_torch.utils.compare import topl_max_error
from approximated_personalized_pagerank_tpu_torch.utils.convert import (
    baskets_from_numpy,
    graph_from_arrays,
)

jg = importlib.import_module("approximated_personalized_pagerank_tpu.models.grank")

ATOL = 1e-6
DAMPING = 0.85
BUDGET = 3000


def _graph(seed, hub):
    """200 nodes of out-degree ~7; with ``hub``, node 0 also has 120
    out-edges (a hub row at L=40, sub=12)."""
    rng = np.random.default_rng(seed)
    n = 200
    src = rng.integers(1 if hub else 0, n, 1400)
    if hub:
        src = np.concatenate([np.zeros(120, np.int64), src])
    dst = rng.integers(0, n, src.size)
    return pj.Graph.from_edges(src, dst, num_nodes=n)


def _random_state(n, L, seed):
    """A tie-free basket state: distinct ids per row, random scores."""
    rng = np.random.default_rng(seed)
    ids = np.stack([rng.permutation(n)[:L] for _ in range(n)]).astype(np.int32)
    ids[rng.random((n, L)) < 0.3] = -1
    sc = np.where(ids >= 0, rng.random((n, L)) / L, 0.0).astype(np.float32)
    order = np.argsort(-sc, axis=1, kind="stable")
    return np.take_along_axis(ids, order, 1), np.take_along_axis(sc, order, 1)


# (port merge_algo, JAX merge_algo, L, hub).  The hub configuration sweeps
# from a tie-free state: its intermediate per-group top-M cuts would
# otherwise break GRank's many exact score ties differently in the two
# packages, and a tie cut inside a group moves an id's final sum.
CONFIGS = [
    ("sort", "sort", 24, True),
    ("kernel", "bitonic", 40, False),
    ("kernel:512", "bitonic:512", 40, True),
]


@pytest.mark.parametrize("algo_t,algo_j,L,hub", CONFIGS)
def test_half_sweeps_match_from_shared_state(algo_t, algo_j, L, hub):
    gj = _graph(5, hub)
    gt = graph_from_arrays(gj.indptr, gj.indices)
    n = gj.num_nodes
    net = jm.net_max_width(algo_j)
    assert net == tm.net_max_width(algo_t)
    plan_L = L if net else None
    hub_sub = max((net - 1) // L, 1) if net else None
    plans_j = [gj.merge_plan(p, L=plan_L, net_width=net) for p in (0, 1)]
    plans_t = [gt.merge_plan(p, L=plan_L, net_width=net) for p in (0, 1)]
    hub_rows = net == 512
    if hub_rows:
        assert any(b.cap > hub_sub for b in plans_t[0].buckets + plans_t[1].buckets)
    dbj = [jm.device_plan(p, n) for p in plans_j]
    dbt = [tm.device_plan(p, "cpu") for p in plans_t]
    damp_j = jnp.float32(DAMPING)
    damp_t = torch.tensor(DAMPING, dtype=torch.float32)
    dangling = np.concatenate([p.dangling_rows for p in plans_j])

    # init sweep
    bj = jg._set_dangling(jb.empty_baskets(n, L), dangling, DAMPING)
    bj = jg._init_step(bj, dbj[0] + dbj[1], damp_j, L, n, BUDGET, algo=algo_j,
                       hub_sub=hub_sub)
    bt = _set_dangling(tb.empty_baskets(n, L), dangling, DAMPING)
    bt, _ = tm.merge_sweep(None, dbt[0] + dbt[1], damp_t, L, algo_t,
                           out_basket=bt, elem_budget=BUDGET, hub_sub=hub_sub)
    topl_max_error(np.asarray(bj.ids), np.asarray(bj.scores), bt.ids, bt.scores, ATOL)

    if hub_rows:
        ids_np, sc_np = _random_state(n, L, 7)
        bj = jb.Baskets(jnp.asarray(ids_np), jnp.asarray(sc_np))
    # one half-sweep of each partition, each started from the JAX state
    for t in range(2):
        ids_np, sc_np = np.asarray(bj.ids), np.asarray(bj.scores)
        state = baskets_from_numpy(ids_np, sc_np, "cpu")
        bj, dj = jg._half_sweep(bj, dbj[t], damp_j, L, n, True, BUDGET,
                                algo=algo_j, hub_sub=hub_sub)
        new, dt = tm.merge_sweep(state, dbt[t], damp_t, L, algo_t,
                                 compute_diff=True, elem_budget=BUDGET,
                                 hub_sub=hub_sub)
        # read-old/write-new: the input state is untouched
        assert np.array_equal(state.ids.numpy(), ids_np)
        topl_max_error(np.asarray(bj.ids), np.asarray(bj.scores), new.ids, new.scores, ATOL)
        assert abs(float(dt) - float(dj)) < 1e-5


def _hub_graph(seed, hub_edges):
    """200 nodes of out-degree ~7, and node 0 with ``hub_edges`` out-edges
    (repeats included)."""
    rng = np.random.default_rng(seed)
    n = 200
    src = np.concatenate([np.zeros(hub_edges, np.int64), rng.integers(1, n, 1400)])
    return pj.Graph.from_edges(src, rng.integers(0, n, src.size), num_nodes=n)


# (port merge_algo, JAX merge_algo, hub edges of node 0).  The kernel
# pipeline's plan is built with its network width, so node 0 takes the hub
# path (sub = 31 successors a group at L=16, M = 32): 120 edges make 4
# groups, one final merge; 500 make 17, and 17 * M > sub * L runs the
# tree-reduce loop first.  The flat sort pipeline has no hub path.
MC_COMBINE_CASES = [
    ("sort", "sort", 120),
    ("kernel:512", "bitonic:512", 120),
    ("kernel:512", "bitonic:512", 500),
]


@pytest.mark.parametrize("algo_t,algo_j,hub_edges", MC_COMBINE_CASES)
def test_mc_combine_sweep_matches(algo_t, algo_j, hub_edges):
    """One MC combine pass from a tie-free state (distinct ids a row,
    random scores): the hub path's self entry and post scale, its group cuts
    and its tree reduction against the JAX package's."""
    gj = _graph(9, hub=True) if hub_edges == 120 else _hub_graph(9, hub_edges)
    gt = graph_from_arrays(gj.indptr, gj.indices)
    n, L = gj.num_nodes, 16
    rng = np.random.default_rng(2)
    ids = np.stack([rng.permutation(n)[:L] for _ in range(n)]).astype(np.int32)
    ids[rng.random((n, L)) < 0.2] = -1
    sc = np.where(ids >= 0, rng.random((n, L)) / L, 0).astype(np.float32)
    sc = -np.sort(-sc, axis=1)
    net = jm.net_max_width(algo_j)
    assert net == tm.net_max_width(algo_t)
    hub_sub = max((net - 1) // L, 1) if net else None
    plan_j = gj.merge_plan(None, L=L if net else None, net_width=net)
    plan_t = gt.merge_plan(None, L=L if net else None, net_width=net)
    if net:
        hub_caps = [b.cap for b in plan_t.buckets if b.cap > hub_sub]
        assert len(hub_caps) == 1
        g, m = -(-hub_caps[0] // hub_sub), 2 * L
        assert (g * m > hub_sub * L) == (hub_edges == 500)
    sweep = jax.jit(functools.partial(
        jm.merge_sweep, L=L, num_rows=n, mode="mc_combine", algo=algo_j,
        elem_budget=BUDGET, hub_sub=hub_sub))
    bj, _ = sweep(jb.Baskets(jnp.asarray(ids), jnp.asarray(sc)),
                  jm.device_plan(plan_j, n), jnp.float32(DAMPING))
    bt, _ = tm.merge_sweep(baskets_from_numpy(ids, sc, "cpu"),
                           tm.device_plan(plan_t, "cpu"),
                           torch.tensor(DAMPING), L, algo_t, mode="mc_combine",
                           elem_budget=BUDGET, hub_sub=hub_sub)
    topl_max_error(np.asarray(bj.ids), np.asarray(bj.scores), bt.ids, bt.scores, ATOL)


def test_merge_algo_resolution():
    assert tm.resolve_merge_algo(None, torch.device("cpu")) == "sort"
    assert tm.resolve_merge_algo(None, torch.device("cuda")) == "kernel"
    assert tm.net_max_width("kernel") == 8192 == jm.net_max_width("pallas")
    assert tm.net_max_width("kernel:4096") == 4096
    assert tm.net_max_width("sort") is None
    with pytest.raises(ValueError, match="unknown merge algo"):
        tm.resolve_merge_algo("bitonic", torch.device("cpu"))
    # the plan constants that fix results equal the JAX package's
    assert (tm.MIN_NETWORK_WIDTH, tm.HUB_TOP_M_FACTOR, tm.DEFAULT_ELEM_BUDGET) == (
        jm.MIN_NETWORK_WIDTH, jm.HUB_TOP_M_FACTOR, jm.DEFAULT_ELEM_BUDGET)
    assert pt.graph.MAX_BUCKET_ROWS == pj.graph.MAX_BUCKET_ROWS
