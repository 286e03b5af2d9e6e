"""BENCHMARK.json and the benchmark's data files: they parse, resolve by
name and keep to the manifest's format; no module of the benchmark loads
JAX or the JAX package."""

import ast
import json
import os
import re
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
sys.path.insert(0, ROOT)

from ppr_bench import harness  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "approximated_personalized_pagerank_tpu"}
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def manifest():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_manifest_keys_and_limits(manifest):
    assert set(manifest) == TOP_KEYS
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert manifest["command"] == ["python3", "ppr_bench/run.py"]
    assert manifest["paths"] == ["ppr_bench"]
    assert isinstance(manifest["run_seconds"], int) and 1 <= manifest["run_seconds"] <= 51
    cells = len(manifest["workloads"])
    assert 1 <= len(manifest["configs"]) <= 24 and 1 <= cells <= 24
    runs = 2 + 14 * 24
    assert runs * (manifest["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_lines(manifest):
    names = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in manifest[group]:
            assert NAME.match(entry["name"]), entry["name"]
            assert (group, entry["name"]) not in names
            names.add((group, entry["name"]))
    for c in manifest["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"]) and PATH.match(c["file"])
        assert c["file"].startswith("ppr_bench/") and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for w in manifest["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and _line(w["why"])
        assert w["chips"] in (1, 4)
    pairs = [(w["config"], w["traffic"]) for w in manifest["workloads"]]
    assert len(pairs) == len(set(pairs))
    cells = {w["name"] for w in manifest["workloads"]}
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= cells
    for m in manifest["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert "setup_s" in {m["name"] for m in manifest["end_to_end"]}
    e2e = {m["name"] for m in manifest["end_to_end"]}
    for m in manifest["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e and _line(m["layer"])
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def test_every_cell_resolves_by_name(manifest):
    import importlib

    used = set()
    for w in manifest["workloads"]:
        files = harness.cell_files(w["name"])
        wl, cfg = files["workload"], files["config"]
        assert wl["config"] == w["config"] and _line(wl["why"])
        used.add(w["config"])
        importlib.import_module(f"ppr_bench.algorithms.{wl['algorithm']}")
        importlib.import_module(f"ppr_bench.graphs.{cfg['graph']['generator']}")
        e2e = harness.metrics_for(manifest, w["name"], "end_to_end")
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
        layer = harness.metrics_for(manifest, w["name"], "per_layer")
        assert layer
        for m in layer:
            assert callable(harness.metric_reader(m["name"]))
    assert used == {c["name"] for c in manifest["configs"]}
    for c in manifest["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            assert json.load(f)["name"] == c["name"]


def test_a_cell_added_as_files_resolves(manifest, tmp_path):
    """A later cell is a workload file, a configuration file and manifest
    entries: nothing else changes."""
    for kind in ("configs", "workloads"):
        (tmp_path / kind).mkdir()
    (tmp_path / "configs" / "eat-l500.json").write_text(json.dumps(
        {"name": "eat-l500", "graph": {"generator": "eat", "nodes": 23132, "edges": 312310}}))
    (tmp_path / "workloads" / "eat-grank-L500.json").write_text(json.dumps(
        {"config": "eat-l500", "algorithm": "grank", "why": "L = 10 K",
         "job": {"K": 50, "L": 500, "iterations": 30, "damping": 0.85, "tolerance": 1e-4},
         "limits": {"rank_score_gap": 1e-3}}))
    m = json.loads(json.dumps(manifest))
    m["workloads"].append({"name": "eat-grank-L500", "config": "eat-l500",
                           "traffic": "grank-L500", "chips": 1, "why": "L = 10 K"})
    files = harness.cell_files("eat-grank-L500", str(tmp_path))
    assert files["workload"]["job"]["L"] == 500
    assert files["config"]["graph"]["generator"] == "eat"
    assert harness.manifest_cell(m, "eat-grank-L500")["chips"] == 1
    e2e = {x["name"] for x in harness.metrics_for(m, "eat-grank-L500", "end_to_end")}
    assert {"setup_s", "peak_alloc_gib"} <= e2e


def _modules_of(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                yield node.args[0].value


def test_no_module_imports_jax_or_the_jax_package():
    found = []
    for dirpath, _, files in os.walk(BENCH):
        for name in files:
            if name.endswith(".py"):
                path = os.path.join(dirpath, name)
                found += [(path, m) for m in _modules_of(path)
                          if m.split(".")[0] in FORBIDDEN]
    assert not found, found


def test_files_are_named_from_name_characters():
    for dirpath, dirs, files in os.walk(BENCH):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for name in files:
            rel = os.path.relpath(os.path.join(dirpath, name), ROOT)
            assert PATH.match(rel), rel
