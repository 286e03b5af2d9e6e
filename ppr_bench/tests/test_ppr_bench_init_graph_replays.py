"""The reader of ``init_graph_replays_per_job.eat``
(``metrics/init_graph_replays_per_job.py``): what it reads from the spans
of CPU calls (eager: 0), from spans of known counts, and None where the
program recorded no init sweep, has no recorder, or its init sweeps carry
no count ``graph_replays`` (a program whose init sweep is eager)."""

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

NAME = "init_graph_replays_per_job.eat"
DATA = trace.TraceData(1.0, 0.25, (), (), {}, {"jobs": 4})


@pytest.fixture(autouse=True)
def empty_buffer():
    profiling.clear()
    yield
    profiling.clear()


def _span(name, id, parent, **counts):
    return profiling.Span(name, id, parent, id, id * 1000, id * 1000 + 500, counts)


def _jobs(replays):
    """A job a value of ``replays``, each with an upload, an init sweep
    counting that many replays and a replayed half-sweep."""
    spans = []
    for i, r in enumerate(replays):
        job = 1 + 4 * i
        spans += [_span("grank.job", job, None, half_sweeps=1, sweep_graphs_reused=1),
                  _span("grank.upload", job + 1, job, bytes=0),
                  _span("grank.init_sweep", job + 2, job, graph_replays=r),
                  _span("grank.half_sweep", job + 3, job, graph_replays=1)]
    return spans


def test_cpu_calls_read_zero():
    g = powerlaw_graph(150, 1000, seed=3)
    with profiling.record():
        for _ in range(2):
            pt.grank_baskets(g, 5, 10, 6, 0.85, 1e-4, engine="sparse", device="cpu")
    assert harness.metric_reader(NAME)(DATA) == 0.0


@pytest.mark.parametrize("replays,want", [((1, 1, 1, 1), 1.0), ((0, 1, 1, 1), 0.75),
                                          ((0, 0, 0, 0), 0.0)])
def test_the_init_sweeps_replayed_per_job(replays, want, monkeypatch):
    spans = _jobs(replays)
    monkeypatch.setattr(profiling, "recorded", lambda: list(spans))
    assert harness.metric_reader(NAME)(DATA) == pytest.approx(want, rel=1e-12)


def test_init_sweeps_without_the_count_read_none(monkeypatch):
    # the parent's jobs: replayed half-sweeps beside an eager init sweep
    spans = [_span("grank.job", 1, None, half_sweeps=1, sweep_graphs_reused=1),
             _span("grank.init_sweep", 2, 1),
             _span("grank.half_sweep", 3, 1, graph_replays=1)]
    monkeypatch.setattr(profiling, "recorded", lambda: list(spans))
    assert harness.metric_reader(NAME)(DATA) is None


def test_none_without_init_sweeps_or_recorder(monkeypatch):
    assert harness.metric_reader(NAME)(DATA) is None
    with profiling.record():
        with profiling.span("mc.job"):
            pass
    assert harness.metric_reader(NAME)(DATA) is None
    monkeypatch.delattr(profiling, "recorded")
    assert harness.metric_reader(NAME)(DATA) is None
