"""The harness on the CPU: inputs from the seed, the trace arithmetic, a
whole run of a small cell past the look for a card, that run with the
timed path broken underneath (``correct`` must come out false), and the
refusal without a card."""

import json
import os
import subprocess
import sys
from types import SimpleNamespace
from typing import NamedTuple

import numpy as np
import pytest
import torch

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
sys.path.insert(0, ROOT)

import approximated_personalized_pagerank_tpu_torch as pt  # noqa: E402
from approximated_personalized_pagerank_tpu_torch.models import grank as port_grank  # noqa: E402
from ppr_bench import harness, trace  # noqa: E402
from ppr_bench.graphs import eat, powerlaw  # noqa: E402
from ppr_bench.reference.grank import grank as reference_grank  # noqa: E402

EAT = {"nodes": 23132, "edges": 312310}


def test_eat_seed_zero_keeps_the_files_labels():
    e = eat.make(EAT, 0, "cpu")
    g = pt.Graph.from_edges(e.src.numpy(), e.dst.numpy(), num_nodes=e.num_nodes)
    ref = pt.load_eat_graph()
    assert np.array_equal(g.indptr, ref.indptr) and np.array_equal(g.indices, ref.indices)


@pytest.mark.parametrize("seed", [1, 2**31 + 3])
def test_eat_other_seeds_relabel_by_a_permutation(seed):
    e0, e = eat.make(EAT, 0, "cpu"), eat.make(EAT, seed, "cpu")
    # the label of each node under the seed, read off the edge arrays
    perm = torch.full((e0.num_nodes,), -1, dtype=torch.int64)
    perm[e0.src] = e.src
    perm[e0.dst] = e.dst
    assert sorted(perm.tolist()) == list(range(e0.num_nodes))
    assert not torch.equal(perm, torch.arange(e0.num_nodes))
    assert torch.equal(eat.make(EAT, seed, "cpu").src, e.src)
    # the lowest id stays, so the program's BFS root, partition and merge
    # plans are the same sets of nodes: every seed does the same work
    assert perm[0] == 0
    g0, g = (pt.Graph.from_edges(x.src.numpy(), x.dst.numpy(), num_nodes=x.num_nodes)
             for x in (e0, e))
    assert np.array_equal(g.partition[perm.numpy()], g0.partition)
    for part in (0, 1):
        p0, p = (x.merge_plan(part, L=100, net_width=8192) for x in (g0, g))
        assert [len(b.rows) for b in p.buckets] == [len(b.rows) for b in p0.buckets]
        for b, b0 in zip(p.buckets, p0.buckets):
            assert np.array_equal(np.sort(b.rows), np.sort(perm.numpy()[b0.rows]))


def test_powerlaw_is_drawn_from_the_seed():
    spec = {"nodes": 5000, "edges": 40000, "alpha": 1.9, "locality": 0.8, "community_size": 1024}
    a, b, c = (powerlaw.make(spec, s, "cpu") for s in (5, 5, 6))
    assert torch.equal(a.src, b.src) and torch.equal(a.dst, b.dst)
    assert not torch.equal(a.dst, c.dst)
    assert a.src.numel() == 40000 and int(a.src.max()) < 5000 and int(a.dst.max()) < 5000


class _Dev(NamedTuple):
    name: str


class Ev(NamedTuple):
    """A stand-in for a kineto event: its name, device, start and end."""

    n: str
    dev: str
    s: int
    e: int

    def name(self):
        return self.n

    def device_type(self):
        return _Dev("CUDA" if self.dev == "cuda" else "CPU")

    def start_ns(self):
        return self.s

    def end_ns(self):
        return self.e


def test_trace_union_gaps_and_readers():
    ms = 1_000_000
    events = [
        Ev(trace.WINDOW, "cpu", 10 * ms, 110 * ms),
        Ev(trace.WINDOW, "cuda", 12 * ms, 108 * ms),  # the window's device copy
        Ev("merge_kernel<8, true, false>", "cuda", 20 * ms, 40 * ms),
        Ev("gatherTopK", "cuda", 30 * ms, 45 * ms),  # overlaps the first
        Ev("Memcpy HtoD", "cuda", 60 * ms, 70 * ms),
        Ev("merge_kernel<16, true, true>", "cuda", 100 * ms, 120 * ms),  # clipped at 110
        Ev("early", "cuda", 0, 5 * ms),  # before the window
        Ev("aten::item", "cpu", 52 * ms, 58 * ms),
        Ev("aten::sort", "cpu", 71 * ms, 99 * ms),
        Ev("cudaLaunchKernel", "cpu", 80 * ms, 81 * ms),
    ]
    d = trace.read(events, {"graph_build": 1.0, "csc": 2.0, "partition": 0.5},
                   {"iterations_ran": 4, "jobs": 2})
    assert d.window_s == pytest.approx(0.1)
    assert d.busy_s == pytest.approx(0.025 + 0.01 + 0.01)
    gaps = sorted((round(s, 6), round(e, 6), n) for s, e, n in d.gaps)
    assert gaps == [(0.0, 0.01, "host outside operators"), (0.035, 0.05, "aten::item"),
                    (0.06, 0.09, "aten::sort")]
    assert len(d.kernels()) == 3
    read = harness.metric_reader
    assert read("device_idle_share.eat")(d) == pytest.approx(55.0)
    assert read("launches_per_half_sweep")(d) == pytest.approx(0.75)
    assert read("merge_kernel_ms_per_half_sweep")(d) == pytest.approx(30.0 / 4)
    assert read("prep_s")(d) == pytest.approx(3.5)
    b = trace.breakdown(d)
    assert b["device_ops"][0][0].startswith("merge_kernel<8") and len(b["idle_gaps"]) == 3
    assert b["idle_gaps"][0] == ["aten::sort", pytest.approx(0.03)]


def test_kinds_by_device_and_name():
    evs = [Ev(trace.WINDOW, "cpu", 0, 10), Ev(trace.WINDOW, "cuda", 1, 9),
           Ev("merge_kernel<8>", "cuda", 1, 2), Ev("Memcpy DtoH", "cuda", 3, 4),
           Ev("Memset (Device)", "cuda", 4, 5), Ev("aten::sort", "cpu", 2, 3)]
    assert [trace.kind_of(e) for e in evs] == [
        "user_annotation", "gpu_user_annotation", "kernel", "gpu_memcpy", "gpu_memset", "cpu_op"]
    d = trace.read(evs, {}, {})
    assert [a.kind for a in d.device] == ["kernel", "gpu_memcpy", "gpu_memset"]
    assert d.busy_s == pytest.approx(3e-9)


def test_readers_find_nothing_in_an_empty_window():
    d = trace.TraceData(1.0, 0.5, (), (), {}, {})
    for name in ("launches_per_half_sweep", "merge_kernel_ms_per_half_sweep.eat", "prep_s"):
        assert harness.metric_reader(name)(d) is None


# A small cell: nothing is cut at L >= |V|, so the program and the
# reference agree to rounding and any fault shows.
SMALL_CONFIG = {"name": "small", "graph": {"generator": "powerlaw", "nodes": 150,
                                           "edges": 1200, "alpha": 1.9, "locality": 0.8,
                                           "community_size": 64}}


@pytest.fixture(params=["eat-grank"])
def small_cell(tmp_path, request):
    """A run of the small cell under the named cell's checks and limits."""
    with open(os.path.join(BENCH, "workloads", f"{request.param}.json")) as f:
        wl = json.load(f)
    wl.update(config="small", job={**wl["job"], "K": 50, "L": 150, "engine": "sparse"})
    for kind, name, body in (("configs", "small", SMALL_CONFIG), ("workloads", "small-grank", wl)):
        (tmp_path / kind).mkdir()
        (tmp_path / kind / f"{name}.json").write_text(json.dumps(body))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        m = json.load(f)
    m["workloads"].append({"name": "small-grank", "config": "small", "traffic": "grank",
                           "chips": 1, "why": "test"})
    for e in m["end_to_end"] + m["per_layer"]:
        if request.param in e.get("workloads", []):
            e["workloads"].append("small-grank")

    def run():
        return harness.run_cell("small-grank", 7, 0.2, False, device="cpu",
                                bench_dir=str(tmp_path), manifest=m)
    return run


def test_a_sound_run_is_correct(small_cell):
    r = small_cell()
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1, r["checks"]
    assert {"setup_s", "peak_alloc_gib"} < set(r["metrics"])
    assert all(k.startswith("grank_job") for k in set(r["metrics"]) - {"setup_s", "peak_alloc_gib"})
    assert list(r)[-1] == "checks"


def _unchanged(real):
    def sweep(basket, *a, **k):
        out, d = real(basket, *a, **k)
        if basket is None:
            return out, d
        return type(basket)(basket.ids.clone(), basket.scores.clone()), d
    return sweep


def _half_left_out(real):
    def sweep(basket, buckets, *a, **k):
        return real(basket, buckets[: max(1, len(buckets) // 2)], *a, **k)
    return sweep


def _altered(real):
    def top(ids, scores, k, *a, **kw):
        out = real(ids, scores, k, *a, **kw)
        out.ids[3, 0] = (out.ids[3, 0] + 1) % ids.shape[0]
        return out
    return top


@pytest.mark.parametrize("fault", ["state_unchanged", "half_left_out", "answer_altered"])
def test_a_broken_timed_path_is_not_correct(small_cell, monkeypatch, fault):
    if fault == "answer_altered":
        monkeypatch.setattr(port_grank, "keep_top_chunked", _altered(port_grank.keep_top_chunked))
    else:
        wrap = _unchanged if fault == "state_unchanged" else _half_left_out
        monkeypatch.setattr(port_grank, "merge_sweep", wrap(port_grank.merge_sweep))
    r = small_cell()
    assert not r["correct"] and r["failed"] == r["attempted"], r["checks"]


def test_the_control_in_the_programs_place_is_not_correct(small_cell, monkeypatch):
    """The control, the reference computed in bfloat16, put in the place of
    the program's ``grank_baskets``: a whole run under the cell's limits
    is not correct, through the gaps and not through the result's form."""
    e = powerlaw.make(SMALL_CONFIG["graph"], 7, "cpu")

    def control(graph, K, L, iterations, damping, tolerance, **kw):
        r = reference_grank(e.num_nodes, e.src, e.dst, K, L, iterations, damping, tolerance,
                            dtype=torch.bfloat16)
        out = SimpleNamespace(ids=r.ids[:, :K].contiguous(),
                              scores=r.scores[:, :K].float().contiguous())
        return out, {"iterations_ran": r.iterations_ran}

    monkeypatch.setattr(pt, "grank_baskets", control)
    r = small_cell()
    checks = r["checks"]
    assert checks["malformed"]["value"] == 0.0 and checks["half_sweeps_gap"]["value"] == 0.0
    assert not r["correct"], checks


def test_the_run_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, os.path.join(BENCH, "run.py"), "--workload", "eat-grank",
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "CUDA card" in p.stderr


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


@pytest.mark.gpu
def test_eat_grank_runs_on_the_card(card):
    p = subprocess.run([sys.executable, os.path.join(BENCH, "run.py"), "--workload", "eat-grank",
                        "--seed", "5", "--seconds", "2", "--trace", "0"],
                       cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-4000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["device"]["platform"] == "gpu", r
