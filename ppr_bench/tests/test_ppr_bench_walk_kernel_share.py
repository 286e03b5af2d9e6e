"""The reader of ``walk_kernel_share.eat_mc``
(``metrics/walk_kernel_share.py``): what it reads from spans of known
counts, and None where the program recorded no walks, has no recorder, or
its walks carry no count ``walk_kernel_chunks`` (a program without the walk
cohort kernel, or walks on the CPU)."""

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

NAME = "walk_kernel_share.eat_mc"
DATA = trace.TraceData(1.0, 0.25, (), (), {}, {"jobs": 2})


@pytest.fixture(autouse=True)
def empty_buffer():
    profiling.clear()
    yield
    profiling.clear()


def _span(name, id, parent, **counts):
    return profiling.Span(name, id, parent, id, id * 1000, id * 1000 + 500, counts)


@pytest.mark.parametrize("kernel,want", [((46, 46), 1.0), ((46, 0), 0.5), ((0, 0), 0.0)])
def test_the_share_of_chunks_the_kernel_walked(kernel, want, monkeypatch):
    spans = []
    for i, k in enumerate(kernel):
        spans += [_span("mc.job", 1 + 3 * i, None),
                  _span("mc.walks", 2 + 3 * i, 1 + 3 * i, chunks=46, walk_kernel_chunks=k,
                        macro_steps=414),
                  _span("mc.alive_wait", 3 + 3 * i, 2 + 3 * i)]
    monkeypatch.setattr(profiling, "recorded", lambda: list(spans))
    assert harness.metric_reader(NAME)(DATA) == pytest.approx(want, rel=1e-12)


def test_walks_without_the_count_read_none(monkeypatch):
    # the parent's walks: chunks and macro steps, no kernel
    spans = [_span("mc.job", 1, None),
             _span("mc.walks", 2, 1, chunks=46, macro_steps=414)]
    monkeypatch.setattr(profiling, "recorded", lambda: list(spans))
    assert harness.metric_reader(NAME)(DATA) is None


def test_cpu_walks_read_none():
    g = powerlaw_graph(150, 1000, seed=3)
    with profiling.record():
        pt.mccompletepathv2_baskets(g, 5, 10, 40, 0.85, seed=1, device="cpu")
    assert any(s.name == "mc.walks" for s in profiling.recorded())
    assert harness.metric_reader(NAME)(DATA) is None


def test_none_without_walks_or_recorder(monkeypatch):
    assert harness.metric_reader(NAME)(DATA) is None
    with profiling.record():
        with profiling.span("grank.job"):
            pass
    assert harness.metric_reader(NAME)(DATA) is None
    monkeypatch.delattr(profiling, "recorded")
    assert harness.metric_reader(NAME)(DATA) is None
