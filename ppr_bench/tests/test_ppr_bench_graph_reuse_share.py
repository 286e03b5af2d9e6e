"""The reader of ``graph_reuse_share.eat`` (``metrics/graph_reuse_share.py``):
what it reads from ``grank.job`` spans of known counts, and None where no
job carries the count ``sweep_graphs_reused`` (a program that keeps no
graphs between calls, or jobs on the CPU) or there is no recorder."""

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

NAME = "graph_reuse_share.eat"
DATA = trace.TraceData(1.0, 0.25, (), (), {}, {"jobs": 4})


@pytest.fixture(autouse=True)
def empty_buffer():
    profiling.clear()
    yield
    profiling.clear()


def _span(name, id, parent, **counts):
    return profiling.Span(name, id, parent, id, id * 1000, id * 1000 + 500, counts)


@pytest.mark.parametrize("reused,want", [((1, 1, 1, 1), 1.0), ((0, 1, 1, 1), 0.75),
                                         ((0, 0, 0, 0), 0.0)])
def test_the_share_of_jobs_that_reused_kept_graphs(reused, want, monkeypatch):
    spans = []
    for i, r in enumerate(reused):
        spans += [_span("grank.job", 1 + 2 * i, None, half_sweeps=30, sweep_graphs_reused=r),
                  _span("grank.half_sweep", 2 + 2 * i, 1 + 2 * i, graph_replays=1)]
    monkeypatch.setattr(profiling, "recorded", lambda: list(spans))
    assert harness.metric_reader(NAME)(DATA) == pytest.approx(want, rel=1e-12)


def test_jobs_without_the_count_read_none(monkeypatch):
    # the parent's jobs: replays, but nothing kept between calls
    spans = [_span("grank.job", 1, None, half_sweeps=30),
             _span("grank.half_sweep", 2, 1, graph_replays=1)]
    monkeypatch.setattr(profiling, "recorded", lambda: list(spans))
    assert harness.metric_reader(NAME)(DATA) is None


def test_cpu_jobs_read_none():
    g = powerlaw_graph(150, 1000, seed=3)
    with profiling.record():
        for _ in range(2):
            pt.grank_baskets(g, 5, 10, 6, 0.85, 1e-4, engine="sparse", device="cpu")
    assert any(s.name == "grank.job" for s in profiling.recorded())
    assert harness.metric_reader(NAME)(DATA) is None


def test_none_without_jobs_or_recorder(monkeypatch):
    assert harness.metric_reader(NAME)(DATA) is None
    monkeypatch.delattr(profiling, "recorded")
    assert harness.metric_reader(NAME)(DATA) is None
