"""The reader of ``graph_replays_per_half_sweep.eat``
(``metrics/graph_replays_per_half_sweep.py``): what it reads from the
spans of CPU calls (eager: 0), from spans of known counts, and None where
the program recorded no half-sweep, has no recorder, or its half-sweeps
carry no count ``graph_replays`` (a program without CUDA-graph
half-sweeps)."""

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

NAME = "graph_replays_per_half_sweep.eat"
DATA = trace.TraceData(1.0, 0.25, (), (), {"graph_build": 0.1}, {"iterations_ran": 24})


@pytest.fixture(autouse=True)
def empty_buffer():
    profiling.clear()
    yield
    profiling.clear()


def _span(name, id, parent, **counts):
    return profiling.Span(name, id, parent, 1, id * 1000, id * 1000 + 500, counts)


def test_cpu_calls_read_zero():
    g = powerlaw_graph(150, 1000, seed=3)
    with profiling.record():
        pt.grank_baskets(g, 5, 10, 6, 0.85, -1.0, engine="sparse", device="cpu")
    assert harness.metric_reader(NAME)(DATA) == 0.0


@pytest.mark.parametrize("replays,want", [((1, 1, 1, 1), 1.0), ((0, 1, 1, 0), 0.5),
                                          ((0, 0, 0, 0), 0.0)])
def test_the_share_of_replayed_half_sweeps(replays, want, monkeypatch):
    spans = [_span("grank.job", 1, None, half_sweeps=4)]
    for i, r in enumerate(replays):
        spans.append(_span("grank.half_sweep", 2 + 2 * i, 1, merge_launches=5,
                           graph_replays=r))
        if i < 2 and r:
            spans.append(_span("grank.graph_capture", 3 + 2 * i, 2 + 2 * i))
    monkeypatch.setattr(profiling, "recorded", lambda: list(spans))
    assert harness.metric_reader(NAME)(DATA) == pytest.approx(want, rel=1e-12)


def test_spans_without_the_count_read_none(monkeypatch):
    # a program whose half-sweeps carry merge_launches alone
    spans = [_span("grank.job", 1, None, half_sweeps=2),
             _span("grank.half_sweep", 2, 1, merge_launches=5),
             _span("grank.half_sweep", 3, 1, merge_launches=5)]
    monkeypatch.setattr(profiling, "recorded", lambda: list(spans))
    assert harness.metric_reader(NAME)(DATA) is None


def test_none_without_half_sweeps_or_recorder(monkeypatch):
    assert harness.metric_reader(NAME)(DATA) is None
    with profiling.record():
        with profiling.span("mc.job"):
            pass
    assert harness.metric_reader(NAME)(DATA) is None
    monkeypatch.delattr(profiling, "recorded")
    assert harness.metric_reader(NAME)(DATA) is None
