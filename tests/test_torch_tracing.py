"""The port's spans and counters (``utils/profiling.py``) in GRank and MC.

Spans record only under ``record()`` or a running ``torch.profiler``, leave
the baskets bitwise as they are, nest by the call stack, carry their job's
id, and sit on the profiler's clock: under ``torch.profiler`` every
operator of a call lies inside the call's ``grank.job`` span, and each
half-sweep's scalar read inside its ``grank.diff_wait``.

This file imports neither JAX nor the JAX package; its ``gpu`` tests run on
a card's machine without the suite's ``conftest.py``::

    python -m pytest --noconftest -o addopts= -m gpu tests/test_torch_tracing.py
"""

import glob
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import approximated_personalized_pagerank_tpu_torch as pt
from approximated_personalized_pagerank_tpu_torch.models import grank as grank_mod
from approximated_personalized_pagerank_tpu_torch.ops import merge as merge_mod
from approximated_personalized_pagerank_tpu_torch.ops import merge_kernel
from approximated_personalized_pagerank_tpu_torch.ops import walk as tw
from approximated_personalized_pagerank_tpu_torch.utils import profiling
from approximated_personalized_pagerank_tpu_torch.utils.synthetic import powerlaw_graph

K, L, ITERATIONS, DAMPING, TOL = 5, 10, 8, 0.85, 1e-4
# Slack allowed between a span's time.time_ns() reads and the profiler's
# event times: both are CLOCK_REALTIME, so an operator inside a span
# starts after it and ends before it; a few microseconds cover the
# profiler's conversion of its own clock.
CLOCK_SLACK_NS = 5_000


@pytest.fixture(autouse=True)
def empty_buffer():
    profiling.clear()
    yield
    profiling.clear()


@pytest.fixture(scope="module")
def graph():
    g = powerlaw_graph(150, 1000, seed=3)
    assert sum(g.merge_plan(p).dangling_rows.size for p in (0, 1)) > 0
    return g


def _grank(graph, device="cpu", **kw):
    kw.setdefault("engine", "sparse")
    return pt.grank_baskets(graph, K, L, ITERATIONS, DAMPING, TOL, return_info=True,
                            device=device, **kw)


def _by_name(spans, name):
    return [s for s in spans if s.name == name]


def test_nothing_is_recorded_without_record_or_a_profiler(graph):
    _grank(graph)
    for engine in ("sparse", "dense"):
        pt.mccompletepathv2_baskets(graph, K, L, 20, DAMPING, seed=1, engine=engine,
                                    device="cpu")
    assert profiling.recorded() == [] and profiling.dropped() == 0
    with profiling.span("x") as s:
        assert not s
        assert profiling.current() is s


@pytest.mark.parametrize("engine", ["sparse", "dense"])
def test_recording_leaves_the_baskets_bitwise(graph, engine):
    off, info_off = _grank(graph, engine=engine)
    with profiling.record():
        on, info_on = _grank(graph, engine=engine)
    assert torch.equal(on.ids, off.ids)
    assert torch.equal(on.scores.view(torch.int32), off.scores.view(torch.int32))
    assert info_on == info_off
    assert len(_by_name(profiling.recorded(), "grank.job")) == 1


def test_spans_of_sparse_calls_nest_by_job(graph):
    with profiling.record():
        infos = [_grank(graph)[1], _grank(graph, merge_algo="kernel")[1]]
    spans = profiling.recorded()
    by_id = {s.id: s for s in spans}
    jobs = _by_name(spans, "grank.job")
    assert len(jobs) == 2 and all(j.parent is None and j.job == j.id for j in jobs)
    for s in spans:
        assert s.start_ns <= s.end_ns
        if s.parent is not None:
            parent = by_id[s.parent]
            assert s.job == parent.job
            assert parent.start_ns <= s.start_ns and s.end_ns <= parent.end_ns
    for job, info in zip(jobs, infos):
        mine = [s for s in spans if s.job == job.id]
        names = [s.name for s in mine]
        assert names[:4] == ["grank.job", "grank.upload", "grank.init_sweep",
                             "grank.half_sweep"]
        sweeps = _by_name(mine, "grank.half_sweep")
        assert len(sweeps) == info["iterations_ran"] == job.counts["half_sweeps"]
        assert all(s.parent == job.id for s in sweeps)
        waits = _by_name(mine, "grank.diff_wait")
        assert sorted(w.parent for w in waits) == sorted(s.id for s in sweeps)
        # on the CPU the kernel's wrappers run their plain versions (no
        # launch) and the loop is eager (no graph captured or replayed); the
        # sparse engine counts each half-sweep's rows by merge route
        routes = {"hub_rows", "gather_rows", "sort_rows"}
        assert all(set(s.counts) == routes | {"merge_launches", "graph_replays"}
                   and s.counts["merge_launches"] == s.counts["graph_replays"] == 0
                   for s in sweeps)
        assert "kept_bytes" not in job.counts
        assert _by_name(mine, "grank.graph_capture") == []


def test_upload_bytes_are_the_uploaded_tensors(graph, monkeypatch):
    uploaded = []
    real = grank_mod.device_plan

    def device_plan(plan, device):
        out = real(plan, device)
        uploaded.extend(t for b in out for t in b)
        return out

    monkeypatch.setattr(grank_mod, "device_plan", device_plan)
    with profiling.record():
        _grank(graph)
    (upload,) = _by_name(profiling.recorded(), "grank.upload")
    dangling = sum(graph.merge_plan(p).dangling_rows.size for p in (0, 1))
    damping = torch.tensor(DAMPING, dtype=torch.float32)
    want = sum(t.nbytes for t in uploaded) + damping.nbytes + dangling * 8
    assert len(uploaded) > 0 and upload.counts == {"bytes": want}


def test_every_engine_has_the_root_span_and_mc_its_parts(graph):
    """Every GRank engine runs the one loop (ops/loop.py), so the dense and
    ring jobs hold a ``grank.half_sweep`` a half-sweep, each with its
    ``grank.diff_wait``; every MC engine, the mesh's included, runs the one
    pipeline: ``mc.walks``, then ``mc.combine``."""
    mesh = pt.make_mesh(2, [torch.device("cpu")] * 2)
    with profiling.record():
        infos = [_grank(graph, engine="dense")[1], _grank(graph, engine="auto", mesh=mesh)[1]]
        for kw in (dict(engine="sparse", device="cpu"), dict(engine="dense", device="cpu"),
                   dict(mesh=mesh)):
            pt.mccompletepathv2_baskets(graph, K, L, 20, DAMPING, seed=1, **kw)
    spans = [s for s in profiling.recorded() if s.name != "mc.alive_wait"]
    jobs = {}
    for s in spans:
        jobs.setdefault(s.job, []).append(s)
    jobs = list(jobs.values())
    assert len(jobs) == 5
    for info, (job, *parts) in zip(infos, jobs[:2]):
        assert job.name == "grank.job" and job.parent is None
        ran = info["iterations_ran"]
        assert ran > 0 and job.counts["half_sweeps"] == ran
        assert [s.name for s in parts] == ["grank.half_sweep", "grank.diff_wait"] * ran
        sweeps, waits = parts[::2], parts[1::2]
        assert all(s.parent == job.id for s in sweeps)
        assert [w.parent for w in waits] == [s.id for s in sweeps]
        # on the CPU no merge kernel launches and no graph replays
        assert all(s.counts == {"merge_launches": 0, "graph_replays": 0} for s in sweeps)
    for job, *parts in jobs[2:]:
        top = [s for s in parts if s.parent == job.id]
        assert [(s.name, s.parent) for s in (job, *top)] == [
            ("mc.job", None), ("mc.walks", job.id), ("mc.combine", job.id)]
        assert top[1].counts == {"passes": 2}
    # only the sparse engine's combine opens its passes and its cut
    inner = [[(s.name, s.parent) for s in parts if s.parent != job.id]
             for job, *parts in jobs[2:]]
    comb = [s for s in jobs[2] if s.name == "mc.combine"][0]
    assert inner == [[("mc.combine_pass", comb.id)] * 2 + [("mc.final_cut", comb.id)], [], []]
    # each walk's alive checks are children of its mc.walks
    waits = _by_name(profiling.recorded(), "mc.alive_wait")
    assert waits and {w.parent for w in waits} == {j[1].id for j in jobs[2:]}


@pytest.mark.parametrize("n,R,chunks", [(150, 20, 1), (1100, 200, 3)])
def test_dense_mc_spans_and_counts_follow_the_plan(n, R, chunks):
    """On the dense engine ``mc.walks`` (counts ``chunks``, ``macro_steps``)
    and ``mc.combine`` (count ``passes``) sit in one ``mc.job``, with one
    ``mc.alive_wait`` a walked macro step under ``mc.walks``, and at most
    one more a chunk (the check that ends it before the horizon)."""
    graph = powerlaw_graph(n, 6 * n, seed=5)
    with profiling.record():
        _, info = pt.mccompletepathv2_baskets(graph, K, L, R, DAMPING, seed=3, engine="dense",
                                              combine_passes=3, return_info=True, device="cpu")
    spans = profiling.recorded()
    (job,) = _by_name(spans, "mc.job")
    (walks,) = _by_name(spans, "mc.walks")
    (comb,) = _by_name(spans, "mc.combine")
    waits = _by_name(spans, "mc.alive_wait")
    assert walks.parent == comb.parent == job.id and walks.end_ns <= comb.start_ns
    assert all(w.parent == walks.id and w.job == job.id for w in waits)
    assert comb.counts == {"passes": 3}
    plan_chunk, _, _, _, plan_macro, _ = tw._trace_chunks(n, R, DAMPING, None, None, 32)
    assert walks.counts["chunks"] == -(-n // plan_chunk) == chunks
    steps = walks.counts["macro_steps"]
    assert chunks <= steps <= chunks * plan_macro
    assert steps <= len(waits) <= steps + chunks
    assert info["walk_steps"] > 0


@pytest.mark.parametrize("algo", ["kernel", "sort"])
def test_sparse_mc_combine_passes_count_their_rows(algo):
    """The sparse engine's ``mc.combine`` holds one ``mc.combine_pass`` a
    pass and then ``mc.final_cut``; each pass counts the plan's buckets and
    the rows of each route (ops/merge.py::merge_route), which together are
    the nodes with successors.  At L=100 the kernel pipeline's plan has hub
    rows (caps above 81), gather rows and rows too narrow for the kernel
    (cap 2 or less: 201 candidates);
    the sort pipeline merges every row by sort.  On the CPU the kernel's
    plain versions count no launch.  The dense engine opens no pass."""
    graph = powerlaw_graph(400, 5000, seed=3)
    with profiling.record():
        pt.mccompletepathv2_baskets(graph, K, 100, 20, DAMPING, seed=1, engine="sparse",
                                    merge_algo=algo, device="cpu")
        pt.mccompletepathv2_baskets(graph, K, 100, 20, DAMPING, seed=1, engine="dense",
                                    device="cpu")
    spans = profiling.recorded()
    combs = _by_name(spans, "mc.combine")
    assert len(combs) == 2
    passes = _by_name(spans, "mc.combine_pass")
    (cut,) = _by_name(spans, "mc.final_cut")
    assert [s.parent for s in passes] + [cut.parent] == [combs[0].id] * 3
    assert passes[0].end_ns <= passes[1].start_ns <= passes[1].end_ns <= cut.start_ns
    plan_L, net, _ = merge_mod.plan_widths(100, algo)
    buckets = graph.merge_plan(None, L=plan_L, net_width=net).buckets
    rows = {"hub_rows", "gather_rows", "sort_rows"}
    for s in passes:
        assert set(s.counts) == rows | {"buckets", "merge_launches"}
        assert s.counts["buckets"] == len(buckets)
        assert sum(s.counts[k] for k in rows) == int((graph.out_degree > 0).sum())
        assert s.counts["merge_launches"] == 0
    assert passes[0].counts == passes[1].counts
    routes = [passes[0].counts[k] for k in ("hub_rows", "gather_rows", "sort_rows")]
    assert (all(routes) if algo == "kernel" else routes[:2] == [0, 0])


def _routed_graph():
    """300 nodes: 30 dangling (0-29), 4 hubs of 90-150 successors (30-33),
    60 rows of one or two successors (34-93), the rest 3-40; every tenth
    edge doubled, so parallel edges count twice in a degree."""
    rng = np.random.default_rng(7)
    n = 300
    deg = np.concatenate([np.zeros(30, int), rng.integers(90, 151, 4),
                          rng.integers(1, 3, 60), rng.integers(3, 41, n - 94)])
    src = np.repeat(np.arange(n), deg)
    dst = rng.integers(0, n, src.size)
    src, dst = np.concatenate([src, src[::10]]), np.concatenate([dst, dst[::10]])
    return pt.Graph.from_edges(src, dst, num_nodes=n), src


@pytest.mark.parametrize("algo", ["kernel", "sort"])
@pytest.mark.parametrize("job", ["grank", "mc"])
def test_each_merge_sweep_counts_its_rows_by_route(job, algo):
    """Each GRank ``grank.half_sweep`` (the swept partition) and each MC
    ``mc.combine_pass`` (every node) counts its rows by merge route, as
    out-degrees taken from the edge arrays say.  At L=100 under the kernel
    pipeline a row of more than 81 successors is a hub row (81 * 100 + 1
    fills the kernel's 8,192), one of 1-2 successors takes the sort pipeline
    (its bucket's rows, 101 or 201 wide, are under the kernel's 256), the
    rest the gather entry; the sort pipeline merges every row by sort.
    Dangling rows are in no bucket."""
    graph, src = _routed_graph()
    deg = np.bincount(src, minlength=graph.num_nodes)
    with profiling.record():
        if job == "grank":
            pt.grank_baskets(graph, K, 100, 2, DAMPING, -1.0, engine="sparse",
                             merge_algo=algo, device="cpu")
        else:
            pt.mccompletepathv2_baskets(graph, K, 100, 4, DAMPING, seed=1,
                                        engine="sparse", merge_algo=algo, device="cpu")
    name = "grank.half_sweep" if job == "grank" else "mc.combine_pass"
    sweeps = _by_name(profiling.recorded(), name)
    assert len(sweeps) == 2
    for i, s in enumerate(sweeps):
        rows = deg > 0
        if job == "grank":
            rows &= graph.partition == i
        d = deg[rows]
        if algo == "kernel":
            want = [(d > 81).sum(), ((d > 2) & (d <= 81)).sum(), (d <= 2).sum()]
        else:
            want = [0, 0, rows.sum()]
        assert [s.counts[f"{r}_rows"] for r in ("hub", "gather", "sort")] == want
        assert min(want) > 0 or algo == "sort"


def test_spans_and_profiler_events_share_a_clock(graph):
    _grank(graph)  # warm: the profiled call's first operators are its own
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _grank(graph)
    spans = profiling.recorded()
    (job,) = _by_name(spans, "grank.job")
    ops = [e for e in prof.profiler.kineto_results.events() if e.name().startswith("aten::")]
    assert ops
    for e in ops:
        assert job.start_ns - CLOCK_SLACK_NS <= e.start_ns()
        assert e.end_ns() <= job.end_ns + CLOCK_SLACK_NS
    reads = [e for e in ops if e.name() == "aten::item"]
    waits = _by_name(spans, "grank.diff_wait")
    assert len(reads) == len(waits) == job.counts["half_sweeps"]
    for e, w in zip(sorted(reads, key=lambda e: e.start_ns()), waits):
        assert w.start_ns - CLOCK_SLACK_NS <= e.start_ns()
        assert e.end_ns() <= w.end_ns + CLOCK_SLACK_NS


def test_the_chrome_trace_holds_the_spans_over_their_operators(graph, tmp_path):
    _grank(graph)
    with profiling.trace(str(tmp_path)):
        _grank(graph)
    (path,) = glob.glob(str(tmp_path / "ppr_trace_*.json"))
    with open(path) as f:
        doc = json.load(f)
    events = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    mine = [e for e in events if e.get("cat") == "program_span"]
    ops = [e for e in events if e.get("cat") == "cpu_op" and e["name"].startswith("aten::")]
    assert {e["pid"] for e in mine} == {profiling.TRACK}
    (job,) = [e for e in mine if e["name"] == "grank.job"]
    assert len(mine) == 3 + 2 * job["args"]["half_sweeps"] and ops
    slack_us = CLOCK_SLACK_NS / 1e3
    for e in ops:
        assert job["ts"] - slack_us <= e["ts"]
        assert e["ts"] + e["dur"] <= job["ts"] + job["dur"] + slack_us
    # the spans stay in the buffer for recorded()
    assert len(profiling.recorded()) == len(mine)


def test_the_buffer_is_bounded_and_counts_what_it_drops(graph, monkeypatch):
    monkeypatch.setattr(profiling, "MAX_SPANS", 3)
    with profiling.record():
        _, info = _grank(graph)
    spans = profiling.recorded()
    # spans are kept as they end: the first three to end
    assert [s.name for s in spans] == ["grank.upload", "grank.init_sweep", "grank.diff_wait"]
    # a call records 3 + 2 h spans: job, upload, init sweep, 2 a half-sweep
    assert profiling.dropped() == 2 * info["iterations_ran"]
    profiling.clear()
    assert profiling.recorded() == [] and profiling.dropped() == 0


def _merge_launches_per_sweep(graph, device, monkeypatch):
    """Each merge_sweep call's increase of the kernel's launch counters,
    and the spans of the same call."""
    deltas = []
    real = grank_mod.merge_sweep

    def merge_sweep(*args, **kw):
        before = merge_kernel.launch_count()
        out = real(*args, **kw)
        deltas.append(merge_kernel.launch_count() - before)
        return out

    monkeypatch.setattr(grank_mod, "merge_sweep", merge_sweep)
    with profiling.record():
        pt.grank_baskets(graph, 50, 100, 30, DAMPING, TOL, engine="sparse", device=device)
    sweeps = _by_name(profiling.recorded(), "grank.half_sweep")
    return deltas, [s.counts["merge_launches"] for s in sweeps]


def test_merge_launches_are_the_kernel_counters_increase(graph, monkeypatch):
    deltas, counted = _merge_launches_per_sweep(graph, "cpu", monkeypatch)
    # the first merge_sweep is the init sweep, outside every half-sweep
    assert counted == deltas[1:] and len(counted) > 0


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA merge kernel has no CPU mode")


@pytest.mark.gpu
def test_merge_launches_are_the_kernel_counters_increase_on_the_card(monkeypatch):
    _card()
    eat = pt.load_eat_graph()
    pt.grank_baskets(eat, 50, 100, 30, DAMPING, TOL, engine="sparse")  # builds the kernel
    eat.release_device_state()  # so the next call captures
    deltas, counted = _merge_launches_per_sweep(eat, "cuda", monkeypatch)
    # the init sweep and the half-sweeps replay CUDA graphs: merge_sweep runs
    # at each graph's capture (the init sweep's, then each partition's), and
    # each replay counts what its partition's capture launched
    assert len(deltas) == 3 and len(counted) == 30 and min(counted) > 0
    assert counted == [deltas[1 + i % 2] for i in range(30)]


@pytest.mark.gpu
def test_diff_wait_holds_the_scalar_read_on_the_card():
    _card()
    eat = pt.load_eat_graph()
    pt.grank_baskets(eat, 50, 100, 30, DAMPING, TOL, engine="sparse")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        pt.grank_baskets(eat, 50, 100, 30, DAMPING, TOL, engine="sparse")
        torch.cuda.synchronize()
    spans = profiling.recorded()
    reads = sorted((e for e in prof.profiler.kineto_results.events()
                    if e.name() == "aten::_local_scalar_dense"), key=lambda e: e.start_ns())
    waits = _by_name(spans, "grank.diff_wait")
    assert len(waits) == 30
    for w in waits:
        inside = [e for e in reads if w.start_ns - CLOCK_SLACK_NS <= e.start_ns()
                  and e.end_ns() <= w.end_ns + CLOCK_SLACK_NS]
        assert len(inside) == 1
