"""GRank's init sweep and half-sweeps as CUDA graphs
(``models/grank.py::_SweepGraphs``).

On the card the init sweep and each partition's half-sweep are captured
once and replayed; the baskets, the half-sweeps run and the kernel's
counters (launches, tied rows) must be those of the eager loop, which this
file writes out with ``merge_sweep`` (``_init``, ``_eager``).
On the CPU the loop stays eager: the CPU tests hold ``_eager`` to the
program there, so the card's tests hold the graphs to a loop known to be
the program's.  The captured state is kept on the ``Graph`` between calls
of one key (``grank._sweep_key``); the card's tests hold each call on a
kept state to a fresh call on a fresh ``Graph``.

This file imports neither JAX nor the JAX package; its ``gpu`` tests run on
a card's machine without the suite's ``conftest.py``::

    python -m pytest --noconftest -o addopts= -m gpu tests/test_torch_sweep_graph.py
"""

import collections
import pickle
import threading

import numpy as np
import pytest
import torch

import approximated_personalized_pagerank_tpu_torch as pt
from approximated_personalized_pagerank_tpu_torch.models import grank as grank_mod
from approximated_personalized_pagerank_tpu_torch.ops import basket as basket_ops
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


def _init(graph, L, device, algo=None, damping=DAMPING):
    """The init sweep of ``_sparse_run`` written out eagerly: returns the
    ``[N, L]`` basket it leaves, its rise of the kernel's launch counters,
    and what the half-sweeps read (buckets, damping tensor, merge algo,
    ``hub_sub``)."""
    dev = torch.device(device)
    algo = resolve_merge_algo(algo, dev)
    net = net_max_width(algo)
    plans = [graph.merge_plan(p, L=L if net else None, net_width=net) for p in (0, 1)]
    hub_sub = max((net - 1) // L, 1) if net else None
    buckets = [device_plan(p, dev) for p in plans]
    damping_t = torch.tensor(damping, dtype=torch.float32, device=dev)
    basket = empty_baskets(graph.num_nodes, L, dev)
    grank_mod._set_dangling(
        basket, np.concatenate([p.dangling_rows for p in plans]), damping)
    before = merge_kernel.launch_count()
    basket, _ = merge_sweep(None, buckets[0] + buckets[1], damping_t, L, algo,
                            out_basket=basket, hub_sub=hub_sub)
    return basket, merge_kernel.launch_count() - before, (buckets, damping_t, algo, hub_sub)


def _eager(graph, K, L, iterations, tolerance, device, algo=None):
    """The sparse loop of ``_sparse_run`` written out eagerly: returns the
    ``[N, K]`` baskets, the half-sweeps run, each half-sweep's max diff and
    each one's rise of the kernel's launch counters."""
    basket, _, (buckets, damping, algo, hub_sub) = _init(graph, L, device, algo)
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


def _wide_graph():
    """A small graph whose node 0 has 300 more successors: its init row is
    over 256 wide, so the kernel pipeline merges it with the merge kernel."""
    g = powerlaw_graph(400, 3000, seed=3)
    src = np.concatenate([np.repeat(np.arange(g.num_nodes), g.out_degree),
                          np.zeros(300, dtype=np.int64)])
    dst = np.concatenate([g.indices, np.arange(1, 301)])
    return pt.Graph.from_edges(src, dst, num_nodes=g.num_nodes)


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


@pytest.mark.parametrize("algo", ["sort", "kernel"])
@pytest.mark.parametrize("name", ["small", "wide"])
def test_the_cpu_init_sweep_is_the_eager_one_and_replays_no_graph(
        small, name, algo, monkeypatch):
    graph = small if name == "small" else _wide_graph()
    want = _init(graph, 10, "cpu", algo)[0]
    inits = []
    real = grank_mod.merge_sweep

    def merge_sweep(basket, *args, **kw):
        out = real(basket, *args, **kw)
        if basket is None:
            inits.append(pt.Baskets(out[0].ids.clone(), out[0].scores.clone()))
        return out

    monkeypatch.setattr(grank_mod, "merge_sweep", merge_sweep)
    _, _, spans = _program(graph, 5, 10, 2, 1e-4, "cpu", algo)
    (init,) = _by_name(spans, "grank.init_sweep")
    assert init.counts == {"graph_replays": 0}
    assert len(inits) == 1 and _same_bits(inits[0], want)
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
    eat.release_device_state()  # so this call captures
    tol = _tolerance(eat, 50, 100, tolerance, "cuda")
    want, ran, _, launches = _eager(eat, 50, 100, iterations, tol, "cuda")
    got, got_ran, spans = _program(eat, 50, 100, iterations, tol, "cuda")
    assert got_ran == ran and _ran_as_planned(ran, iterations, tolerance)
    assert _same_bits(got, want)
    sweeps = _by_name(spans, "grank.half_sweep")
    assert [s.counts["graph_replays"] for s in sweeps] == [1] * ran
    assert [s.counts["merge_launches"] for s in sweeps] == launches
    (init,) = _by_name(spans, "grank.init_sweep")
    assert init.counts == {"graph_replays": 1}
    # one capture in the init sweep, one a partition in its first half-sweep
    captures = _by_name(spans, "grank.graph_capture")
    assert [c.parent for c in captures] == [init.id] + [s.id for s in sweeps[:2]]


@pytest.mark.gpu
@pytest.mark.parametrize("name,L", [("eat", 100), ("eat", 500), ("wide", 100)])
def test_the_replayed_init_sweep_is_the_eager_one_bitwise_on_the_card(name, L):
    """After one half-sweep ``bufs[0]`` still holds the init sweep's basket
    (partition 0's graph only reads it).  At the call that captures and at
    a call on the kept state with another damping, it is bitwise the eager
    init sweep, and the kernel's launch counters rise by the eager init's
    launches beside the half-sweep's: on the wide graph init rows take the
    merge kernel."""
    _card()
    graph = pt.load_eat_graph() if name == "eat" else _wide_graph()
    for reused, damping in enumerate((DAMPING, 0.6)):
        want, init_launches, _ = _init(graph, L, "cuda", damping=damping)
        before = merge_kernel.launch_count()
        profiling.clear()
        with profiling.record():
            pt.grank_baskets(graph, 5, L, 1, damping, 1e-4, engine="sparse",
                             device="cuda")
        spans = profiling.recorded()
        (job,), (init,), (sweep,) = (_by_name(spans, n) for n in (
            "grank.job", "grank.init_sweep", "grank.half_sweep"))
        assert job.counts["sweep_graphs_reused"] == reused
        assert init.counts == {"graph_replays": 1}
        assert _same_bits(graph._sweep_graphs.bufs[0], want)
        assert (merge_kernel.launch_count() - before
                == init_launches + sweep.counts["merge_launches"])
        assert (init_launches > 0) == (name == "wide")
    graph.release_device_state()


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


# ---------------------------------------------------------------- kept state
KEY = dict(dev=torch.device("cuda", 0), L=100, algo="kernel", elem_budget=1 << 22,
           compute_diff=True)


@pytest.mark.parametrize("part,other", [
    ("dev", torch.device("cuda", 1)), ("dev", torch.device("cpu")), ("L", 50),
    ("algo", "sort"), ("algo", "kernel:512"), ("elem_budget", 1 << 20),
    ("compute_diff", False)])
def test_the_sweep_key_tells_apart_each_of_its_parts(part, other):
    assert grank_mod._sweep_key(**KEY) == grank_mod._sweep_key(**KEY)
    assert grank_mod._sweep_key(**{**KEY, part: other}) != grank_mod._sweep_key(**KEY)


def test_the_sweep_key_changes_with_the_tied_row_counters():
    """A graph captured while tied rows are counted writes into that
    count's counters, so each count_tied_rows(True) starts another key."""
    off = grank_mod._sweep_key(**KEY)
    try:
        merge_kernel.count_tied_rows(True)
        first = grank_mod._sweep_key(**KEY)
        merge_kernel.count_tied_rows(True)
        second = grank_mod._sweep_key(**KEY)
    finally:
        merge_kernel.count_tied_rows(False)
    assert len({off, first, second}) == 3
    assert grank_mod._sweep_key(**KEY) == off


def test_release_device_state_without_a_card_is_a_no_op(small):
    small.release_device_state()
    _program(small, 5, 10, 6, 1e-4, "cpu")
    assert small._sweep_graphs is None
    small.release_device_state()
    assert small._sweep_graphs is None


@pytest.mark.parametrize("algo", ["sort", "kernel"])
def test_two_cpu_calls_on_one_graph_equal_fresh_calls(algo):
    graph = powerlaw_graph(150, 1000, seed=3)
    calls = []
    for _ in range(2):
        profiling.clear()
        calls.append(_program(graph, 5, 10, 6, 1e-4, "cpu", algo))
    fresh = _program(powerlaw_graph(150, 1000, seed=3), 5, 10, 6, 1e-4, "cpu", algo)
    for got, ran, spans in calls:
        assert _same_bits(got, fresh[0]) and ran == fresh[1]
        (job,) = _by_name(spans, "grank.job")
        assert "sweep_graphs_reused" not in job.counts  # eager: nothing kept


def test_a_pickled_graph_runs_as_its_original(small):
    copy = pickle.loads(pickle.dumps(small))
    assert copy._sweep_graphs is None
    got, ran, _ = _program(copy, 5, 10, 6, 1e-4, "cpu")
    want, want_ran, _ = _program(small, 5, 10, 6, 1e-4, "cpu")
    assert _same_bits(got, want) and ran == want_ran


def _order_key_formula(scores, live):
    """``basket._top_order_key`` as it was before it was built in place,
    kept here only, as the reference."""
    bits = scores.contiguous().view(torch.int32).to(torch.int64)
    ordered = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    col = torch.arange(scores.shape[-1], dtype=torch.int64, device=scores.device)
    key = (ordered << 32) | (0xFFFFFFFF - col)
    return torch.where(live, key, torch.full_like(key, basket_ops._DEAD_KEY))


@pytest.mark.parametrize("transposed", [False, True])
def test_the_final_cuts_key_built_in_place_is_its_formula_bit_for_bit(transposed):
    """The final cut runs beside both kept baskets, so its key is built in
    place; every float32 bit pattern (negatives, NaNs, infinities, -0.0)
    and dead slot keep the formula's key, and the scores are left as they
    were."""
    g = torch.Generator().manual_seed(5)
    bits = torch.randint(-2**31, 2**31, (257, 130), dtype=torch.int64, generator=g)
    bits[0, :6] = torch.tensor([0, -2**31, 0x7F800000, -8388608, 0x7FC00000, 1])
    scores = bits.to(torch.int32).view(torch.float32)
    live = torch.rand(257, 130, generator=g) > 0.25
    if transposed:
        scores, live = scores.t(), live.t()
    assert torch.equal(basket_ops._top_order_key(scores, live),
                       _order_key_formula(scores, live))
    assert torch.equal(scores.contiguous().view(torch.int32),
                       bits.to(torch.int32).t().contiguous() if transposed
                       else bits.to(torch.int32))  # the input is left as it was


def _call(graph, L=100, damping=DAMPING, tolerance=1e-4, iterations=30):
    """One Eat call on the card, recorded: baskets, half-sweeps run and the
    job's ``sweep_graphs_reused``."""
    profiling.clear()
    with profiling.record():
        out, info = pt.grank_baskets(graph, 50, L, iterations, damping, tolerance,
                                     engine="sparse", return_info=True, device="cuda")
    (job,) = _by_name(profiling.recorded(), "grank.job")
    return out, info["iterations_ran"], job.counts["sweep_graphs_reused"]


def _fresh(**kw):
    """The same call on a fresh ``Graph``, whose state goes with it."""
    graph = pt.load_eat_graph()
    out, ran, reused = _call(graph, **kw)
    graph.release_device_state()
    assert reused == 0
    return out, ran


def _copy(b):
    return pt.Baskets(b.ids.clone(), b.scores.clone())


@pytest.mark.gpu
@pytest.mark.parametrize("between", [
    {}, {"L": 64}, {"damping": 0.6}, {"tolerance": -1.0}],
    ids=["nothing", "another_L", "another_damping", "negative_tolerance"])
def test_calls_on_a_kept_state_are_fresh_calls_bitwise(between):
    """Two calls on one Eat ``Graph``, with a call of other arguments
    between them: each is bitwise a fresh call on a fresh ``Graph`` with
    the same half-sweeps run.  Another L or a negative tolerance is
    another key, so it captures again and so does the call after it;
    another damping is the same key, written into the captured tensor."""
    _card()
    graph = pt.load_eat_graph()
    recapture = "L" in between or "tolerance" in between
    want, want_ran = _fresh()
    mid_want, mid_ran = _fresh(**between)
    first, ran, reused = _call(graph)
    assert reused == 0 and ran == want_ran and _same_bits(first, want)
    mid, ran, reused = _call(graph, **between)
    assert reused == int(not recapture) and ran == mid_ran and _same_bits(mid, mid_want)
    last, ran, reused = _call(graph)
    assert reused == int(not recapture) and ran == want_ran and _same_bits(last, want)
    graph.release_device_state()


@pytest.mark.gpu
def test_a_later_call_leaves_the_results_a_user_holds():
    _card()
    graph = pt.load_eat_graph()
    first = _call(graph)[0]
    held = _copy(first)
    second, _, reused = _call(graph, damping=0.6)
    assert reused == 1 and not _same_bits(second, first)
    assert _same_bits(first, held)
    graph.release_device_state()


@pytest.mark.gpu
def test_release_device_state_frees_the_state_and_the_next_call_captures():
    _card()
    graph = pt.load_eat_graph()
    want = _call(graph)[0]
    kept = graph._sweep_graphs
    assert set(kept.graphs) == {"init", 0, 1}
    reserved = torch.cuda.memory_reserved()
    graph.release_device_state()
    assert graph._sweep_graphs is None and kept.graphs is None
    assert torch.cuda.memory_reserved() < reserved  # the pool went back to the card
    got = [_call(graph) for _ in range(2)]
    assert [reused for _, _, reused in got] == [0, 1]
    assert all(_same_bits(out, want) for out, _, _ in got)
    graph.release_device_state()


@pytest.mark.gpu
def test_each_call_counts_the_bytes_its_kept_state_holds_on_the_card():
    """A call on the card counts on its ``grank.job`` the bytes the kept
    state holds after it, ``kept_bytes``: at least the two static
    ``[N, L]`` baskets and the upload (plans, dangling rows, damping), at
    most what the caching allocator reserves; a call on the kept state
    counts what the capturing call counted."""
    _card()
    graph = pt.load_eat_graph()
    counted = []
    for reused in (0, 1):
        assert _call(graph)[2] == reused
        (job,) = _by_name(profiling.recorded(), "grank.job")
        counted.append(job.counts["kept_bytes"])
    baskets = 2 * graph.num_nodes * 100 * (4 + 4)  # int32 ids, float32 scores
    low = baskets + graph._sweep_graphs.upload_bytes
    assert low <= counted[0] <= torch.cuda.memory_reserved()
    assert counted[1] == counted[0]
    graph.release_device_state()


@pytest.mark.gpu
@pytest.mark.parametrize("body", ["init_merge", "sweep"])
def test_a_capture_that_raises_leaves_no_state(body, monkeypatch):
    """A capture of the init sweep (the first) or of a half-sweep (after
    the init sweep's graph was kept) that raises keeps nothing."""
    _card()
    graph = pt.load_eat_graph()
    want = _call(graph)[0]
    graph.release_device_state()

    def fail(self, *args):
        raise RuntimeError("made to fail inside the capture")

    with monkeypatch.context() as m:
        m.setattr(grank_mod._SweepGraphs, body, fail)
        with pytest.raises(RuntimeError, match="made to fail"):
            _call(graph)
    assert graph._sweep_graphs is None
    got, _, reused = _call(graph)
    assert reused == 0 and _same_bits(got, want)
    graph.release_device_state()


@pytest.mark.gpu
def test_two_threads_calling_on_one_graph_get_fresh_calls_results():
    _card()
    graph = pt.load_eat_graph()
    want = {d: _fresh(damping=d)[0] for d in (0.85, 0.6)}
    got, errors = {}, []

    def worker(d):
        try:
            got[d] = [_copy(pt.grank_baskets(graph, 50, 100, 30, d, 1e-4, engine="sparse",
                                             device="cuda")) for _ in range(3)]
            torch.cuda.synchronize()
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(d,)) for d in want]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert errors == []
    assert all(_same_bits(b, want[d]) for d, bs in got.items() for b in bs)
    graph.release_device_state()
