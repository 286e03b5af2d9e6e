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

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import approximated_personalized_pagerank_tpu_torch as pt
from approximated_personalized_pagerank_tpu_torch.models import grank as grank_mod
from approximated_personalized_pagerank_tpu_torch.ops import merge_kernel
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
    pt.mccompletepathv2_baskets(graph, K, L, 20, DAMPING, seed=1, engine="sparse",
                                device="cpu")
    assert profiling.recorded() == [] and profiling.dropped() == 0
    with profiling.span("x") as s:
        assert not s


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
        # launch) and the loop is eager (no graph captured or replayed)
        assert all(s.counts == {"merge_launches": 0, "graph_replays": 0} for s in sweeps)
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
    mesh = pt.make_mesh(2, [torch.device("cpu")] * 2)
    with profiling.record():
        _grank(graph, engine="dense")
        _grank(graph, engine="auto", mesh=mesh)
        pt.mccompletepathv2_baskets(graph, K, L, 20, DAMPING, seed=1, engine="sparse",
                                    device="cpu")
        pt.mccompletepathv2_baskets(graph, K, L, 20, DAMPING, seed=1, engine="dense",
                                    device="cpu")
    spans = profiling.recorded()
    assert [(s.name, s.parent is None) for s in spans] == [
        ("grank.job", True), ("grank.job", True),
        ("mc.job", True), ("mc.walks", False), ("mc.combine", False),
        ("mc.job", True),
    ]
    assert all(s.counts["half_sweeps"] > 0 for s in spans[:2])
    assert spans[3].parent == spans[4].parent == spans[2].id


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
    deltas, counted = _merge_launches_per_sweep(eat, "cuda", monkeypatch)
    # the half-sweeps replay CUDA graphs: merge_sweep runs at the init sweep
    # and at each partition's capture, and each replay counts what its
    # partition's capture launched
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
