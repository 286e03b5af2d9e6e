"""The MC cells' files on the CPU: the job adapter (``algorithms/mc.py``)
through a whole run of a small cell, that run with the timed path broken
underneath or the control in its place (``correct`` must come out false),
its digest, and the five readers the ``eat-mc`` cell adds, on trace data
and spans of known sizes."""

import contextlib
import json
import os
import sys
from types import SimpleNamespace

import pytest
import torch

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
sys.path.insert(0, ROOT)

import approximated_personalized_pagerank_tpu_torch as pt  # noqa: E402
from approximated_personalized_pagerank_tpu_torch.models import mccompletepathv2 as port_mc  # noqa: E402
from approximated_personalized_pagerank_tpu_torch.utils import profiling  # noqa: E402
from ppr_bench import control_mc, harness, trace  # noqa: E402
from ppr_bench.algorithms import mc as adapter  # noqa: E402
from ppr_bench.graphs import powerlaw  # noqa: E402
from ppr_bench.reference import mc as ref  # noqa: E402

SMALL_CONFIG = {"name": "small", "graph": {"generator": "powerlaw", "nodes": 300,
                                           "edges": 1200, "alpha": 1.9, "locality": 0.8,
                                           "community_size": 64}}
SEED = 2**31 + 99


@pytest.fixture
def small_cell(tmp_path):
    """A run of a 300-node cell under ``eat-mc``'s job and limits."""
    with open(os.path.join(BENCH, "workloads", "eat-mc.json")) as f:
        wl = json.load(f)
    wl.update(config="small")
    for kind, name, body in (("configs", "small", SMALL_CONFIG), ("workloads", "small-mc", wl)):
        (tmp_path / kind).mkdir()
        (tmp_path / kind / f"{name}.json").write_text(json.dumps(body))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        m = json.load(f)
    m["workloads"].append({"name": "small-mc", "config": "small", "traffic": "mc",
                           "chips": 1, "why": "test"})
    for e in m["end_to_end"] + m["per_layer"]:
        if "eat-mc" in e.get("workloads", []):
            e["workloads"].append("small-mc")

    def run():
        return harness.run_cell("small-mc", SEED, 0.2, False, device="cpu",
                                bench_dir=str(tmp_path), manifest=m)
    run.bench_dir, run.job = str(tmp_path), wl["job"]
    return run


def test_a_sound_run_is_correct(small_cell):
    r = small_cell()
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1, r["checks"]
    assert set(r["metrics"]) == {"setup_s", "peak_alloc_gib"}
    checks = r["checks"]
    assert checks["walk_steps_gap"]["value"] == checks["abandoned_gap"]["value"] == 0.0
    assert checks["jobs_differing"]["value"] == 0.0


def _walks_of_another_seed(real):
    def mc(graph, K, L, R, damping, seed=None, **kw):
        return real(graph, K, L, R, damping, seed=seed + 1, **kw)
    return mc


def _one_pass(real):
    def mc(*a, combine_passes=2, **kw):
        return real(*a, combine_passes=1, **kw)
    return mc


def _altered(real):
    def mc(*a, **kw):
        out, info = real(*a, **kw)
        out.ids[3, 1], out.ids[3, 2] = out.ids[3, 2].clone(), out.ids[3, 1].clone()
        return out, info
    return mc


@pytest.mark.parametrize("fault,wrap", [("another_seed", _walks_of_another_seed),
                                        ("one_pass", _one_pass), ("ids_swapped", _altered)])
def test_a_broken_timed_path_is_not_correct(small_cell, monkeypatch, fault, wrap):
    monkeypatch.setattr(pt, "mccompletepathv2_baskets", wrap(pt.mccompletepathv2_baskets))
    r = small_cell()
    assert not r["correct"] and r["failed"] == r["attempted"], r["checks"]
    if fault == "another_seed":
        assert r["checks"]["walk_steps_gap"]["value"] > 0


def test_the_control_in_the_programs_place_is_not_correct(small_cell, monkeypatch):
    """The control, the reference with float8 product inputs in its
    combine, put in the place of the program's call: well formed, the
    walks exact, and not correct through the gaps."""
    e = powerlaw.make(SMALL_CONFIG["graph"], SEED, "cpu")

    def control(graph, K, L, R, damping, seed=None, combine_passes=2, **kw):
        c = ref.mccompletepathv2(e.num_nodes, e.src, e.dst, L, R, damping, seed,
                                 passes=combine_passes, dtype=torch.float8_e4m3fn)
        out = SimpleNamespace(ids=c.ids[:, :K].contiguous(),
                              scores=c.scores[:, :K].float().contiguous())
        return out, {"walk_steps": c.walk_steps, "abandoned_walks": c.abandoned_walks}

    monkeypatch.setattr(pt, "mccompletepathv2_baskets", control)
    r = small_cell()
    checks = r["checks"]
    assert checks["malformed"]["value"] == checks["walk_steps_gap"]["value"] == 0.0
    assert not r["correct"], checks


def test_control_readings_of_a_small_cell(small_cell):
    rows = list(control_mc.readings("small-mc", [3], {3}, device="cpu",
                                    bench_dir=small_cell.bench_dir))
    assert [r["side"] for r in rows] == ["program", "control_float8_e4m3fn"]
    program, control = rows
    assert program["correct"] and not control["correct"]
    for r in rows:
        assert r["walk_steps_gap"] == r["abandoned_gap"] == 0.0
        assert {"rank_score_gap", "mean_id_gap", "slots_over_0.001"} <= set(r)
    assert control["mean_score_gap"] > 3 * program["mean_score_gap"]


def test_the_digest_is_the_jobs_and_the_seeds():
    e = powerlaw.make(SMALL_CONFIG["graph"], 4, "cpu")
    job = {"K": 10, "L": 40, "R": 200, "damping": 0.85, "combine_passes": 2, "engine": "auto"}
    state = adapter.setup(e, job, lambda _n: contextlib.nullcontext(), "cpu")
    assert adapter.DETERMINISTIC
    a, ca = adapter.run(state, job, 11, 0)
    b, cb = adapter.run(state, job, 11, 1)
    c, _ = adapter.run(state, job, 12, 2)
    assert ca == cb and ca["jobs"] == 1 and ca["seed"] == 11
    assert torch.equal(adapter.digest(a), adapter.digest(b))
    assert not torch.equal(adapter.digest(a), adapter.digest(c))


def _span(name, id, parent, job, start_ms, end_ms, **counts):
    return profiling.Span(name, id, parent, job, int(start_ms * 1e6), int(end_ms * 1e6), counts)


# Two MC jobs, times in ms: walks with their alive waits, then the combine.
KNOWN = [
    _span("mc.job", 1, None, 1, 0, 100),
    _span("mc.walks", 2, 1, 1, 0, 80, chunks=2, macro_steps=5),
    _span("mc.alive_wait", 3, 2, 1, 10, 12),
    _span("mc.alive_wait", 4, 2, 1, 40, 43),
    _span("mc.combine", 5, 1, 1, 80, 95, passes=2),
    _span("mc.job", 6, None, 6, 200, 290),
    _span("mc.walks", 7, 6, 6, 200, 270, chunks=2, macro_steps=5),
    _span("mc.alive_wait", 8, 7, 6, 220, 221),
    _span("mc.combine", 9, 6, 6, 270, 289, passes=2),
]
SPAN_READERS = {"walks_ms_per_job.eat_mc": (80 + 70) / 2,
                "alive_wait_ms_per_job.eat_mc": (2 + 3 + 1) / 2,
                "combine_ms_per_job.eat_mc": (15 + 19) / 2}
EMPTY = trace.TraceData(1.0, 0.5, (), (), {}, {"jobs": 2})


@pytest.fixture(autouse=True)
def empty_buffer():
    profiling.clear()
    yield
    profiling.clear()


@pytest.mark.parametrize("name,want", sorted(SPAN_READERS.items()))
def test_a_span_reader_on_spans_of_known_lengths(name, want, monkeypatch):
    monkeypatch.setattr(profiling, "recorded", lambda: list(KNOWN))
    assert harness.metric_reader(name)(EMPTY) == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("name", sorted(SPAN_READERS))
def test_a_span_reader_reads_the_spans_of_a_cpu_call(name):
    g = pt.Graph.from_edges(*(t.numpy() for t in powerlaw.make(
        SMALL_CONFIG["graph"], 1, "cpu")[1:]), num_nodes=300)
    with profiling.record():
        for _ in range(2):
            port_mc.mccompletepathv2_baskets(g, 5, 20, 100, 0.85, seed=1, device="cpu")
    spans = profiling.recorded()
    jobs = [s for s in spans if s.name == "mc.job"]
    span = {"walks_ms_per_job.eat_mc": "mc.walks", "alive_wait_ms_per_job.eat_mc":
            "mc.alive_wait", "combine_ms_per_job.eat_mc": "mc.combine"}[name]
    want = sum(s.end_ns - s.start_ns for s in spans if s.name == span) / 1e6 / len(jobs)
    got = harness.metric_reader(name)(EMPTY)
    assert len(jobs) == 2 and got > 0 and got == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("name", sorted(SPAN_READERS))
def test_a_span_reader_reads_none_without_its_spans(name, monkeypatch):
    assert harness.metric_reader(name)(EMPTY) is None
    # the parent's dense engine: the job's span alone; GRank's spans
    monkeypatch.setattr(profiling, "recorded", lambda: [
        KNOWN[0], _span("grank.job", 2, None, 2, 0, 5), _span("grank.half_sweep", 3, 2, 2, 1, 2)])
    assert harness.metric_reader(name)(EMPTY) is None
    # a program without the recorder
    monkeypatch.delattr(profiling, "recorded")
    assert harness.metric_reader(name)(EMPTY) is None


def _activity(name, start_ms, end_ms, kind="kernel"):
    return trace.Activity(name, kind, start_ms / 1e3, end_ms / 1e3)


def test_the_device_readers_per_job():
    device = (_activity("merge_kernel<16, true, false>", 0, 4),
              _activity("vectorized_gather_kernel", 4, 5),
              _activity("Memcpy DtoH", 5, 6, "gpu_memcpy"),
              _activity("merge_kernel<8, true, true>", 6, 7),
              _activity("nvjet_tss_192x208", 8, 18))
    d = trace.TraceData(0.1, 0.017, device, (), {}, {"jobs": 2, "walk_steps": 10})
    read = harness.metric_reader
    assert read("launches_per_job.eat_mc")(d) == pytest.approx(4 / 2)
    assert read("merge_kernel_ms_per_job.eat_mc")(d) == pytest.approx((4 + 1) / 2)
    assert read("device_idle_share.eat_mc")(d) == pytest.approx(83.0)
    # no jobs counted (GRank's counters), or no merge kernel: nothing to read
    g = d._replace(counters={"iterations_ran": 30})
    assert read("launches_per_job.eat_mc")(g) is None
    assert read("merge_kernel_ms_per_job.eat_mc")(g) is None
    assert read("merge_kernel_ms_per_job.eat_mc")(d._replace(device=device[1:3])) is None


def test_the_cell_reports_every_new_metric():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        m = json.load(f)
    layer = {x["name"] for x in harness.metrics_for(m, "eat-mc", "per_layer")}
    assert layer == {f"{b}.eat_mc" for b in (
        "device_idle_share", "launches_per_job", "merge_kernel_ms_per_job", "walks_ms_per_job",
        "alive_wait_ms_per_job", "combine_ms_per_job")}
    e2e = {x["name"] for x in harness.metrics_for(m, "eat-mc", "end_to_end")}
    # the cell reports the end-to-end metrics every cell reports, and adds none
    assert e2e == {"setup_s", "peak_alloc_gib"}
    assert {x["moves"] for x in harness.metrics_for(m, "eat-mc", "per_layer")} <= e2e
    # eat-grank reports what it did
    assert {x["name"] for x in harness.metrics_for(m, "eat-grank", "end_to_end")} == {
        "setup_s", "grank_job_s.eat", "peak_alloc_gib"}
