"""The readers of the program's spans and counters (``metrics/
upload_ms_per_job.py`` and the rest): what each reads from the spans of a
CPU call, from spans of known lengths, and None where the program
recorded no span or has no recorder."""

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

READERS = ("upload_ms_per_job.eat", "init_sweep_ms_per_job.eat",
           "host_enqueue_ms_per_half_sweep.eat", "diff_wait_ms_per_half_sweep.eat",
           "merge_launches_per_half_sweep.eat")
# A traced window as the harness hands it to a reader; the span readers
# read the program's buffer, not the window.
DATA = trace.TraceData(1.0, 0.25, (), (), {"graph_build": 0.1}, {"iterations_ran": 24})


def _ms(spans):
    return sum(s.end_ns - s.start_ns for s in spans) / 1e6


def _want(name, spans):
    """Each metric computed straight from the spans."""
    by = {n: [s for s in spans if s.name == n] for n in
          ("grank.job", "grank.upload", "grank.init_sweep", "grank.half_sweep",
           "grank.diff_wait")}
    jobs, sweeps = len(by["grank.job"]), len(by["grank.half_sweep"])
    return {
        "upload_ms_per_job.eat": _ms(by["grank.upload"]) / jobs,
        "init_sweep_ms_per_job.eat": _ms(by["grank.init_sweep"]) / jobs,
        "host_enqueue_ms_per_half_sweep.eat":
            (_ms(by["grank.half_sweep"]) - _ms(by["grank.diff_wait"])) / sweeps,
        "diff_wait_ms_per_half_sweep.eat": _ms(by["grank.diff_wait"]) / sweeps,
        "merge_launches_per_half_sweep.eat":
            sum(s.counts["merge_launches"] for s in by["grank.half_sweep"]) / sweeps,
    }[name]


@pytest.fixture(autouse=True)
def empty_buffer():
    profiling.clear()
    yield
    profiling.clear()


@pytest.mark.parametrize("name", READERS)
def test_a_reader_reads_the_spans_of_cpu_calls(name):
    g = powerlaw_graph(150, 1000, seed=3)
    with profiling.record():
        for _ in range(2):
            pt.grank_baskets(g, 5, 10, 6, 0.85, -1.0, engine="sparse", device="cpu")
    spans = profiling.recorded()
    assert len([s for s in spans if s.name == "grank.half_sweep"]) == 12
    got = harness.metric_reader(name)(DATA)
    assert got is not None and got >= 0
    assert got == pytest.approx(_want(name, spans), rel=1e-12)


def _span(name, id, parent, job, start_ms, end_ms, **counts):
    return profiling.Span(name, id, parent, job, int(start_ms * 1e6), int(end_ms * 1e6), counts)


# Two jobs of two half-sweeps each, times in ms.
KNOWN = [
    _span("grank.job", 1, None, 1, 0, 20, half_sweeps=2),
    _span("grank.upload", 2, 1, 1, 0, 3, bytes=800),
    _span("grank.init_sweep", 3, 1, 1, 3, 5),
    _span("grank.half_sweep", 4, 1, 1, 5, 10, merge_launches=7),
    _span("grank.diff_wait", 5, 4, 1, 9, 10),
    _span("grank.half_sweep", 6, 1, 1, 10, 18, merge_launches=9),
    _span("grank.diff_wait", 7, 6, 1, 16, 18),
    _span("grank.job", 8, None, 8, 30, 50, half_sweeps=2),
    _span("grank.upload", 9, 8, 8, 30, 35, bytes=800),
    _span("grank.init_sweep", 10, 8, 8, 35, 37),
    _span("grank.half_sweep", 11, 8, 8, 37, 42, merge_launches=7),
    _span("grank.diff_wait", 12, 11, 8, 41, 42),
    _span("grank.half_sweep", 13, 8, 8, 42, 48, merge_launches=9),
    _span("grank.diff_wait", 14, 13, 8, 47, 48),
]


@pytest.mark.parametrize("name,want", [
    ("upload_ms_per_job.eat", (3 + 5) / 2),
    ("init_sweep_ms_per_job.eat", (2 + 2) / 2),
    ("host_enqueue_ms_per_half_sweep.eat", ((5 + 8 + 5 + 6) - (1 + 2 + 1 + 1)) / 4),
    ("diff_wait_ms_per_half_sweep.eat", (1 + 2 + 1 + 1) / 4),
    ("merge_launches_per_half_sweep.eat", (7 + 9 + 7 + 9) / 4),
])
def test_a_reader_on_spans_of_known_lengths(name, want, monkeypatch):
    monkeypatch.setattr(profiling, "recorded", lambda: list(KNOWN))
    assert harness.metric_reader(name)(DATA) == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("name", READERS)
def test_a_reader_reads_none_without_spans(name, monkeypatch):
    assert harness.metric_reader(name)(DATA) is None
    # spans of another algorithm only: MC's
    with profiling.record():
        with profiling.span("mc.job"):
            pass
    assert harness.metric_reader(name)(DATA) is None
    # a program without the recorder, as the benchmark's parent commit
    monkeypatch.delattr(profiling, "recorded")
    assert harness.metric_reader(name)(DATA) is None
