"""The ``northstar-mc`` cell's files on the CPU: its two new readers,
``final_cut_ms_per_job.ns_mc`` (``metrics/final_cut_ms_per_job.py``) and
``combine_merge_launches_per_job.ns_mc``
(``metrics/combine_merge_launches_per_job.py``), on spans of known sizes,
on a CPU call's spans, and None where the program recorded no such span
(the dense engine, a program without the spans, no recorder); and a whole
run of a small cell under the cell's job, checked in blocks."""

import json
import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
sys.path.insert(0, ROOT)

import approximated_personalized_pagerank_tpu_torch as pt  # noqa: E402
from approximated_personalized_pagerank_tpu_torch.utils import profiling  # noqa: E402
from approximated_personalized_pagerank_tpu_torch.utils.synthetic import powerlaw_graph  # noqa: E402
from ppr_bench import harness, trace  # noqa: E402

DATA = trace.TraceData(1.0, 0.25, (), (), {}, {"jobs": 2})


@pytest.fixture(autouse=True)
def empty_buffer():
    profiling.clear()
    yield
    profiling.clear()


def _span(name, id, parent, start_ms, end_ms, **counts):
    return profiling.Span(name, id, parent, 1, int(start_ms * 1e6), int(end_ms * 1e6), counts)


def _job(first, t0, launches, cut_ms):
    """One sparse MC job's spans from id ``first``, at ``t0`` ms."""
    j, c = first, first + 2
    rows = dict(buckets=40, hub_rows=3, gather_rows=80, sort_rows=17)
    return [_span("mc.job", j, None, t0, t0 + 100),
            _span("mc.walks", j + 1, j, t0, t0 + 40, chunks=2, macro_steps=8),
            _span("mc.combine", c, j, t0 + 40, t0 + 100, passes=2),
            _span("mc.combine_pass", c + 1, c, t0 + 40, t0 + 60, merge_launches=launches[0],
                  **rows),
            _span("mc.combine_pass", c + 2, c, t0 + 60, t0 + 80, merge_launches=launches[1],
                  **rows),
            _span("mc.final_cut", c + 3, c, t0 + 80, t0 + 80 + cut_ms)]


KNOWN = _job(1, 0, (30, 31), 12.5) + _job(10, 200, (30, 29), 7.5)
WANT = {"final_cut_ms_per_job.ns_mc": (12.5 + 7.5) / 2,
        "combine_merge_launches_per_job.ns_mc": (30 + 31 + 30 + 29) / 2}


@pytest.mark.parametrize("name,want", sorted(WANT.items()))
def test_a_reader_on_spans_of_known_sizes(name, want, monkeypatch):
    monkeypatch.setattr(profiling, "recorded", lambda: list(KNOWN))
    assert harness.metric_reader(name)(DATA) == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("name", sorted(WANT))
def test_a_reader_reads_a_sparse_cpu_call(name):
    g = powerlaw_graph(300, 3000, seed=4)
    with profiling.record():
        for _ in range(2):
            pt.mccompletepathv2_baskets(g, 5, 20, 40, 0.85, seed=1, engine="sparse",
                                        device="cpu")
    spans = profiling.recorded()
    got = harness.metric_reader(name)(DATA)
    if name.startswith("final_cut"):
        cuts = [s for s in spans if s.name == "mc.final_cut"]
        assert len(cuts) == 2
        assert got == pytest.approx(sum(s.end_ns - s.start_ns for s in cuts) / 1e6 / 2)
        assert got > 0
    else:
        # the kernel's plain versions on the CPU count no launch
        assert got == 0.0


@pytest.mark.parametrize("name", sorted(WANT))
def test_a_reader_reads_none_without_its_spans(name, monkeypatch):
    assert harness.metric_reader(name)(DATA) is None
    # the dense engine opens no pass and no cut of its own
    g = powerlaw_graph(150, 1000, seed=3)
    with profiling.record():
        pt.mccompletepathv2_baskets(g, 5, 10, 20, 0.85, seed=1, engine="dense", device="cpu")
    assert any(s.name == "mc.combine" for s in profiling.recorded())
    assert harness.metric_reader(name)(DATA) is None
    # the parent's sparse combine: mc.combine alone
    monkeypatch.setattr(profiling, "recorded", lambda: KNOWN[:3])
    assert harness.metric_reader(name)(DATA) is None
    # a program without the recorder
    monkeypatch.delattr(profiling, "recorded")
    assert harness.metric_reader(name)(DATA) is None


@pytest.fixture
def small_cell(tmp_path):
    """A run of a 2,000-node cell of the ``northstar-mcv2`` graph's kind
    under ``northstar-mc``'s job (the sparse engine named, as auto takes
    the dense one at this size) and limits, on the CPU."""
    with open(os.path.join(BENCH, "workloads", "northstar-mc.json")) as f:
        wl = json.load(f)
    with open(os.path.join(BENCH, "configs", "northstar-mcv2.json")) as f:
        cfg = json.load(f)
    cfg["graph"].update(nodes=2000, edges=28000, community_size=64)
    wl.update(config="small")
    wl["job"]["engine"] = "sparse"
    for kind, name, body in (("configs", "small", cfg), ("workloads", "small-ns", wl)):
        (tmp_path / kind).mkdir()
        (tmp_path / kind / f"{name}.json").write_text(json.dumps(body))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        m = json.load(f)
    m["workloads"].append({"name": "small-ns", "config": "small", "traffic": "mc",
                           "chips": 1, "why": "test"})
    return lambda: harness.run_cell("small-ns", 2**31 + 3, 0.2, False, device="cpu",
                                    bench_dir=str(tmp_path), manifest=m)


def test_a_sound_run_is_correct(small_cell):
    r = small_cell()
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1, r["checks"]
    assert set(r["metrics"]) == {"setup_s", "peak_alloc_gib"}
    checks = r["checks"]
    assert checks["walk_steps_gap"]["value"] == checks["abandoned_gap"]["value"] == 0.0
    assert checks["jobs_differing"]["value"] == 0.0
