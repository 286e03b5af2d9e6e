"""The ``northstar-grank`` cell's files on the CPU: its configuration and
cell as the manifest names them, its two new readers,
``kept_state_gib.ns_grank`` (``metrics/kept_state_gib.py``) and
``sort_rows_per_half_sweep.ns_grank``
(``metrics/sort_rows_per_half_sweep.py``), on spans of known counts, on a
CPU call's spans, and None where no span carries their count (the parent
program, the CPU's eager engine for ``kept_bytes``, no recorder); and a
whole run of a small cell of the configuration's kind under the cell's
job."""

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

CELL = "northstar-grank"
KEPT, SORT = "kept_state_gib.ns_grank", "sort_rows_per_half_sweep.ns_grank"
DATA = trace.TraceData(1.0, 0.25, (), (), {}, {"iterations_ran": 4})


@pytest.fixture(autouse=True)
def empty_buffer():
    profiling.clear()
    yield
    profiling.clear()


@pytest.fixture(scope="module")
def manifest():
    return harness.load_json(harness.MANIFEST)


def test_the_cell_runs_the_north_stars_grank_on_northstar_mcv2s_graph(manifest):
    files = harness.cell_files(CELL)
    wl, cfg = files["workload"], files["config"]
    mc = harness.cell_files("northstar-mc")["config"]
    assert cfg["name"] == CELL and cfg["graph"] == mc["graph"]
    assert wl["job"] == {**cfg["parameters"]["grank"], "engine": "auto"}
    assert wl["algorithm"] == "grank" and wl["metric_suffix"] == "ns_grank"
    assert wl["warmup"] == {} and wl["trace_seconds"] == 12
    entry = harness.manifest_cell(manifest, CELL)
    assert entry["config"] == CELL and entry["chips"] == 1
    (c,) = [c for c in manifest["configs"] if c["name"] == CELL]
    assert c["reduced"] == [] and c["source"] == cfg["source"]


def test_the_cell_reports_its_metrics(manifest):
    """At least the metrics this cell came with (later PRs may add more)."""
    e2e = {m["name"] for m in harness.metrics_for(manifest, CELL, "end_to_end")}
    assert e2e >= {"setup_s", "peak_alloc_gib"}
    layer = {m["name"]: m for m in harness.metrics_for(manifest, CELL, "per_layer")}
    mine = {f"{n}.ns_grank" for n in (
        "merge_kernel_ms_per_half_sweep", "diff_wait_ms_per_half_sweep",
        "launches_per_half_sweep", "init_sweep_ms_per_job", "device_idle_share",
        "kept_state_gib", "sort_rows_per_half_sweep")}
    assert set(layer) >= mine
    assert layer[KEPT]["moves"] == "peak_alloc_gib"
    assert all(layer[n]["moves"] in e2e and CELL in layer[n]["workloads"] for n in mine)
    assert all(callable(harness.metric_reader(n)) for n in layer)


def _span(name, id, parent, **counts):
    return profiling.Span(name, id, parent, id, id * 1000, id * 1000 + 500, counts)


def _jobs(kept, sort_rows):
    """A job a value of ``kept``, each counting that many ``kept_bytes``
    (none where None) and holding a half-sweep a value of ``sort_rows``."""
    spans, i = [], 1
    for k in kept:
        job = i
        spans.append(_span("grank.job", job, None, half_sweeps=len(sort_rows),
                           sweep_graphs_reused=1, **({} if k is None else {"kept_bytes": k})))
        for r in sort_rows:
            i += 1
            spans.append(_span("grank.half_sweep", i, job, graph_replays=1, hub_rows=3,
                               gather_rows=40, sort_rows=r))
        i += 1
    return spans


@pytest.mark.parametrize("name,kept,sort_rows,want", [
    (KEPT, (3 * 2**30, 3 * 2**30), (7, 9), 3.0),
    (KEPT, (2**31, 2**30), (7,), 1.5),
    (SORT, (1, 1), (7, 9), 8.0),
    (SORT, (1,), (0, 5, 10, 25), 10.0)])
def test_a_reader_on_spans_of_known_counts(name, kept, sort_rows, want, monkeypatch):
    spans = _jobs(kept, sort_rows)
    monkeypatch.setattr(profiling, "recorded", lambda: list(spans))
    assert harness.metric_reader(name)(DATA) == pytest.approx(want, rel=1e-12)


def test_sort_rows_of_a_cpu_call_are_its_sort_pipelines_rows():
    g = powerlaw_graph(300, 3000, seed=4)
    with profiling.record():
        for algo in ("kernel", "sort"):
            pt.grank_baskets(g, 5, 100, 4, 0.85, -1.0, engine="sparse", merge_algo=algo,
                             device="cpu")
    sweeps = [s for s in profiling.recorded() if s.name == "grank.half_sweep"]
    assert len(sweeps) == 8
    want = sum(s.counts["sort_rows"] for s in sweeps) / 8
    assert harness.metric_reader(SORT)(DATA) == pytest.approx(want, rel=1e-12)
    # the sort pipeline's half-sweeps: every row with successors, each once
    # in the two partitions' half-sweeps
    assert sum(s.counts["sort_rows"] for s in sweeps[4:6]) == int((g.out_degree > 0).sum())


@pytest.mark.parametrize("name", [KEPT, SORT])
def test_a_reader_reads_none_without_its_count(name, monkeypatch):
    assert harness.metric_reader(name)(DATA) is None
    if name == KEPT:  # the CPU's eager loop keeps nothing and counts nothing
        g = powerlaw_graph(150, 1000, seed=3)
        with profiling.record():
            pt.grank_baskets(g, 5, 10, 4, 0.85, 1e-4, engine="sparse", device="cpu")
        assert any(s.name == "grank.job" for s in profiling.recorded())
        assert harness.metric_reader(name)(DATA) is None
    # the parent's jobs: half-sweeps without route counts, jobs without kept_bytes
    spans = [_span("grank.job", 1, None, half_sweeps=1, sweep_graphs_reused=1),
             _span("grank.half_sweep", 2, 1, graph_replays=1, merge_launches=5)]
    monkeypatch.setattr(profiling, "recorded", lambda: list(spans))
    assert harness.metric_reader(name)(DATA) is None
    monkeypatch.delattr(profiling, "recorded")
    assert harness.metric_reader(name)(DATA) is None


def test_a_small_run_of_the_cells_kind_is_correct(tmp_path, manifest):
    """A run of a 2,000-node cell of the configuration's graph kind under
    the cell's job and limits (the sparse engine named, as auto takes the
    dense one at this size), on the CPU."""
    files = harness.cell_files(CELL)
    wl, cfg = files["workload"], files["config"]
    cfg["graph"].update(nodes=2000, edges=28000, community_size=64)
    wl.update(config="small")
    wl["job"]["engine"] = "sparse"
    for kind, name, body in (("configs", "small", cfg), ("workloads", "small-nsg", wl)):
        (tmp_path / kind).mkdir()
        (tmp_path / kind / f"{name}.json").write_text(json.dumps(body))
    m = json.loads(json.dumps(manifest))
    m["workloads"].append({"name": "small-nsg", "config": "small", "traffic": "grank",
                           "chips": 1, "why": "test"})
    r = harness.run_cell("small-nsg", 2**31 + 5, 0.2, False, device="cpu",
                         bench_dir=str(tmp_path), manifest=m)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1, r["checks"]
    assert set(r["metrics"]) == {"setup_s", "peak_alloc_gib"}
    assert r["checks"]["half_sweeps_gap"]["value"] == 0.0
    assert r["checks"]["jobs_differing"]["value"] == 0.0
