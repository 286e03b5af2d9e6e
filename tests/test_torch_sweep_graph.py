"""GRank's half-sweeps as CUDA graphs (``models/grank.py::_SweepGraphs``).

On the card each partition's half-sweep is captured once and replayed; the
baskets, the half-sweeps run and the kernel's counters (launches, tied
rows) must be those of the eager loop, which this file writes out with
``merge_sweep`` (``_eager``).
On the CPU the loop stays eager: the CPU tests hold ``_eager`` to the
program there, so the card's tests hold the graphs to a loop known to be
the program's.

This file imports neither JAX nor the JAX package; its ``gpu`` tests run on
a card's machine without the suite's ``conftest.py``::

    python -m pytest --noconftest -o addopts= -m gpu tests/test_torch_sweep_graph.py
"""

import collections

import numpy as np
import pytest
import torch

import approximated_personalized_pagerank_tpu_torch as pt
from approximated_personalized_pagerank_tpu_torch.models import grank as grank_mod
from approximated_personalized_pagerank_tpu_torch.ops import merge_kernel
from approximated_personalized_pagerank_tpu_torch.ops.basket import (
    empty_baskets,
    keep_top_chunked,
)
from approximated_personalized_pagerank_tpu_torch.ops.merge import (
    device_plan,
    merge_sweep,
    net_max_width,
    resolve_merge_algo,
)
from approximated_personalized_pagerank_tpu_torch.utils import profiling
from approximated_personalized_pagerank_tpu_torch.utils.synthetic import powerlaw_graph

DAMPING = 0.85
# (iterations, tolerance): one and two half-sweeps (a graph's first turn,
# then each partition's), a full run, and None: a tolerance above the eager
# run's own diffs at half-sweeps 6 and 7, so the loop stops by 7 of 30
CASES = [(1, 1e-4), (2, 1e-4), (30, 1e-4), (30, None)]


@pytest.fixture(autouse=True)
def empty_buffer():
    profiling.clear()
    yield
    profiling.clear()


def _eager(graph, K, L, iterations, tolerance, device, algo=None):
    """The sparse loop of ``_sparse_run`` written out eagerly: returns the
    ``[N, K]`` baskets, the half-sweeps run, each half-sweep's max diff and
    each one's rise of the kernel's launch counters."""
    dev = torch.device(device)
    algo = resolve_merge_algo(algo, dev)
    net = net_max_width(algo)
    plans = [graph.merge_plan(p, L=L if net else None, net_width=net) for p in (0, 1)]
    hub_sub = max((net - 1) // L, 1) if net else None
    buckets = [device_plan(p, dev) for p in plans]
    damping = torch.tensor(DAMPING, dtype=torch.float32, device=dev)
    basket = empty_baskets(graph.num_nodes, L, dev)
    grank_mod._set_dangling(
        basket, np.concatenate([p.dangling_rows for p in plans]), DAMPING)
    basket, _ = merge_sweep(None, buckets[0] + buckets[1], damping, L, algo,
                            out_basket=basket, hub_sub=hub_sub)
    slots, diffs, launches = [tolerance, tolerance], [], []
    while len(diffs) < iterations and max(slots) >= tolerance:
        before = merge_kernel.launch_count()
        basket, d = merge_sweep(basket, buckets[len(diffs) % 2], damping, L, algo,
                                compute_diff=tolerance >= 0, hub_sub=hub_sub)
        launches.append(merge_kernel.launch_count() - before)
        diffs.append(float(d) if tolerance >= 0 else 0.0)
        slots = [slots[1], diffs[-1]]
    return keep_top_chunked(basket.ids, basket.scores, K), len(diffs), diffs, launches


def _tolerance(graph, K, L, tolerance, device, algo=None):
    """``tolerance``, or for None one that stops the loop by 7 of 30
    half-sweeps: just above the larger of half-sweeps 6 and 7's diffs."""
    if tolerance is not None:
        return tolerance
    diffs = _eager(graph, K, L, 7, 0.0, device, algo)[2]
    return float(np.nextafter(np.float32(max(diffs[5], diffs[6])), np.float32(np.inf)))


def _ran_as_planned(ran, iterations, tolerance):
    """A fixed tolerance runs every half-sweep here; the early stop, two
    (each partition's first) to seven."""
    return ran == iterations if tolerance is not None else 2 <= ran <= 7


def _program(graph, K, L, iterations, tolerance, device, algo=None):
    """The program's call, recorded: baskets, half-sweeps run, spans."""
    with profiling.record():
        out, info = pt.grank_baskets(graph, K, L, iterations, DAMPING, tolerance,
                                     merge_algo=algo, engine="sparse",
                                     return_info=True, device=device)
    return out, info["iterations_ran"], profiling.recorded()


def _same_bits(a, b):
    return (torch.equal(a.ids, b.ids)
            and torch.equal(a.scores.view(torch.int32), b.scores.view(torch.int32)))


def _by_name(spans, name):
    return [s for s in spans if s.name == name]


@pytest.fixture(scope="module")
def small():
    return powerlaw_graph(150, 1000, seed=3)


@pytest.mark.parametrize("iterations,tolerance", CASES)
def test_the_eager_loop_is_the_programs_on_the_cpu(small, iterations, tolerance):
    tol = _tolerance(small, 5, 10, tolerance, "cpu")
    want, ran, _, _ = _eager(small, 5, 10, iterations, tol, "cpu")
    got, got_ran, _ = _program(small, 5, 10, iterations, tol, "cpu")
    assert _same_bits(got, want) and got_ran == ran
    assert _ran_as_planned(ran, iterations, tolerance)


@pytest.mark.parametrize("algo", ["sort", "kernel"])
def test_cpu_half_sweeps_replay_no_graph(small, algo):
    _, ran, spans = _program(small, 5, 10, 6, 1e-4, "cpu", algo)
    sweeps = _by_name(spans, "grank.half_sweep")
    assert len(sweeps) == ran > 0
    assert all(s.counts["graph_replays"] == 0 for s in sweeps)
    assert _by_name(spans, "grank.graph_capture") == []


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA graphs and the CUDA merge kernel")


@pytest.fixture(scope="module")
def eat():
    return pt.load_eat_graph()


@pytest.mark.gpu
@pytest.mark.parametrize("iterations,tolerance", CASES)
def test_graph_replays_are_the_eager_loop_bitwise_on_the_card(eat, iterations, tolerance):
    _card()
    tol = _tolerance(eat, 50, 100, tolerance, "cuda")
    want, ran, _, launches = _eager(eat, 50, 100, iterations, tol, "cuda")
    got, got_ran, spans = _program(eat, 50, 100, iterations, tol, "cuda")
    assert got_ran == ran and _ran_as_planned(ran, iterations, tolerance)
    assert _same_bits(got, want)
    sweeps = _by_name(spans, "grank.half_sweep")
    assert [s.counts["graph_replays"] for s in sweeps] == [1] * ran
    assert [s.counts["merge_launches"] for s in sweeps] == launches
    # one capture a partition, inside that partition's first half-sweep
    captures = _by_name(spans, "grank.graph_capture")
    assert [c.parent for c in captures] == [s.id for s in sweeps[:2]]


@pytest.mark.gpu
def test_tied_row_counts_of_replays_are_the_eager_loops_on_the_card(eat):
    _card()
    merge_kernel.count_tied_rows(True)
    try:
        want, ran, _, launches = _eager(eat, 50, 100, 30, 1e-4, "cuda")
        eager_counts = merge_kernel.tied_row_counts()
        merge_kernel.count_tied_rows(True)
        got, got_ran, spans = _program(eat, 50, 100, 30, 1e-4, "cuda")
        counts = merge_kernel.tied_row_counts()
    finally:
        merge_kernel.count_tied_rows(False)
    assert got_ran == ran == 30 and _same_bits(got, want)
    assert counts == eager_counts and counts["gather_merge_topl"]["rows"] > 0
    sweeps = _by_name(spans, "grank.half_sweep")
    assert [s.counts["graph_replays"] for s in sweeps] == [1] * 30
    assert [s.counts["merge_launches"] for s in sweeps] == launches


@pytest.mark.parametrize("tied", [False, True])
def test_a_capture_counts_nothing_and_each_replay_counts_it(tied):
    """capture_counts and replay_counts on the CPU, with launches and tied
    rows noted by hand where a capture's kernels would note them."""
    cpu = torch.device("cpu")
    gather = merge_kernel.gather_merge_topl.launches
    saved = collections.Counter(gather)
    merge_kernel.count_tied_rows(tied)
    try:
        gather[(512, 128)] += 1
        before = merge_kernel.launch_count()
        with merge_kernel.capture_counts(cpu) as rise:
            gather[(512, 128)] += 2
            gather[(1024, 128)] += 1
            merge_kernel._tie_counter("gather_merge_topl", 40, cpu)
        assert merge_kernel.launch_count() == before and gather[(1024, 128)] == 0
        # counters made for the capture; no row counted until a replay
        assert merge_kernel.tied_row_counts() == {}
        for _ in range(3):
            merge_kernel.replay_counts(rise)
        assert merge_kernel.launch_count() == before + 9
        assert (gather[(512, 128)], gather[(1024, 128)]) == (7, 3)
        counts = merge_kernel.tied_row_counts()
        if tied:
            assert list(counts) == ["gather_merge_topl"]
            assert counts["gather_merge_topl"]["rows"] == 120
        else:
            assert counts == {}
    finally:
        merge_kernel.count_tied_rows(False)
        gather.clear()
        gather.update(saved)
