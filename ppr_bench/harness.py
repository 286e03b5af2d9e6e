"""The benchmark's core: one run of one cell, driven by data.

A run finds its cell in ``BENCHMARK.json`` and in ``workloads/<cell>.json``
(the configuration it names, the algorithm, the job's parameters, the
warm-up, the limits of its checks), the configuration in
``configs/<config>.json`` (the graph and its generator), the generator in
``graphs/<generator>.py``, the job adapter in ``algorithms/<algorithm>.py``
and each per-layer metric's reader in ``metrics/<metric>.py``.  Nothing
here is particular to a cell.

A run: make the inputs from the seed, set the program up and warm it up
(``setup_s``, from the process's start), then run whole jobs back to back,
each ended by a device synchronise, until ``seconds`` have passed (the last
job may overrun it).  With ``trace`` the jobs of the first
``trace_seconds`` (the cell's, at most ``seconds``) run under the profiler
and only they make the window.  Once the window has closed the device's
peak memory is read, the program's state is freed, and the last job's
output is checked against the plain reference.
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import importlib.util
import json
import math
import os
import shutil
import subprocess
import sys
import time
from typing import Dict

import torch

from . import trace as trace_mod

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
MANIFEST = os.path.join(ROOT, "BENCHMARK.json")
# Top-level module names that must not be loaded once the window has closed:
# the port is measured on its own, without JAX or the JAX package.
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "approximated_personalized_pagerank_tpu")


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_files(name: str, bench_dir: str = BENCH_DIR) -> dict:
    """The cell's workload file and the configuration file it names."""
    workload = load_json(os.path.join(bench_dir, "workloads", f"{name}.json"))
    config = load_json(os.path.join(bench_dir, "configs", f"{workload['config']}.json"))
    return {"workload": workload, "config": config}


def manifest_cell(manifest: dict, name: str) -> dict:
    for w in manifest["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def metrics_for(manifest: dict, name: str, kind: str) -> list:
    """The ``end_to_end`` or ``per_layer`` entries a cell reports: those that
    list it under ``workloads``; an entry without the key is reported by
    every cell (end to end) or every cell that reports what it moves."""
    e2e = [m for m in manifest["end_to_end"] if name in m.get("workloads", [name])]
    if kind == "end_to_end":
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in manifest["per_layer"]
            if ("workloads" in m and name in m["workloads"])
            or ("workloads" not in m and m["moves"] in moved)]


def metric_reader(name: str, bench_dir: str = BENCH_DIR):
    """``read`` of ``metrics/<name>.py``, or where that is missing of
    ``metrics/<base>.py``, ``<base>`` being the name up to its first dot:
    the metric ``x.eat`` is ``x`` read in the cells that report ``.eat``
    metrics."""
    path = os.path.join(bench_dir, "metrics", f"{name}.py")
    if not os.path.exists(path):
        path = os.path.join(bench_dir, "metrics", f"{name.split('.')[0]}.py")
    spec = importlib.util.spec_from_file_location(
        "ppr_bench.metrics." + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_loaded() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN_MODULES))


def card_line() -> str | None:
    """``nvidia-smi``'s name and power limit of the first card."""
    if shutil.which("nvidia-smi") is None:
        return None
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    lines = out.stdout.strip().splitlines()
    return lines[0] if out.returncode == 0 and lines else None


def percentile(values, q: float) -> float:
    """Nearest-rank percentile (``q`` in (0, 100])."""
    s = sorted(values)
    return s[max(0, math.ceil(q / 100 * len(s)) - 1)]


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(name: str, seed: int, seconds: float, trace: bool, device="cuda",
             bench_dir: str = BENCH_DIR, manifest: dict | None = None,
             t_start: float | None = None) -> dict:
    """One run of cell ``name``; returns the result line's object."""
    t_start = time.perf_counter() if t_start is None else t_start
    manifest = load_json(MANIFEST) if manifest is None else manifest
    entry = manifest_cell(manifest, name)
    files = cell_files(name, bench_dir)
    wl, cfg = files["workload"], files["config"]
    algo = importlib.import_module(f"ppr_bench.algorithms.{wl['algorithm']}")
    gen = importlib.import_module(f"ppr_bench.graphs.{cfg['graph']['generator']}")
    job = dict(wl["job"])
    cuda = torch.device(device).type == "cuda"
    spans: Dict[str, float] = {}

    @contextlib.contextmanager
    def span(label):
        t0 = time.perf_counter()
        yield
        _sync(device)
        spans[label] = time.perf_counter() - t0

    # From the process's start: the interpreter's imports (torch, the harness).
    spans["import"] = time.perf_counter() - t_start
    if cuda:
        with span("cuda_init"):
            torch.cuda.init()
            torch.empty(1, device=device)
        torch.cuda.reset_peak_memory_stats(device)
    with span("inputs"):
        edges = gen.make(cfg["graph"], seed, device)
    state = algo.setup(edges, job, span, device)
    with span("warmup"):
        out, _ = algo.run(state, {**job, **wl.get("warmup", {})}, seed, -1)
        _sync(device)
    out = None
    setup_s = time.perf_counter() - t_start

    limit = min(seconds, wl.get("trace_seconds", seconds)) if trace else seconds
    times, digests, counters, last = [], [], {}, {}
    prof = None
    with contextlib.ExitStack() as stack:
        if trace:
            from torch.profiler import ProfilerActivity, profile, record_function

            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
            prof = stack.enter_context(profile(activities=acts))
            stack.enter_context(record_function(trace_mod.WINDOW))
        t_w0 = time.perf_counter()
        index = 0
        while True:
            t0 = time.perf_counter()
            out = None
            out, last = algo.run(state, job, seed, index)
            _sync(device)
            t1 = time.perf_counter()
            times.append(t1 - t0)
            for k, v in last.items():
                counters[k] = counters.get(k, 0) + v
            if algo.DETERMINISTIC:
                digests.append(algo.digest(out))
            index += 1
            if t1 - t_w0 >= limit:
                break
        elapsed = t1 - t_w0
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    data = None
    if trace:
        data = trace_mod.read(prof.profiler.kineto_results.events(), spans, counters)
        prof = None
    del state
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    checks = algo.check(edges, out, last, job, wl["limits"], device)
    differing = 0
    if algo.DETERMINISTIC:
        final = digests[-1]
        differing = sum(not torch.equal(d, final) for d in digests)
        checks["jobs_differing"] = (float(differing), 0.0)
    correct = all(v <= lim for v, lim in checks.values())
    failed = differing + (0 if correct else len(times) - differing)

    tail = f".{wl['metric_suffix']}" if "metric_suffix" in wl else ""
    values = {
        "setup_s": setup_s,
        "peak_alloc_gib": peak / 2**30,
        f"{wl['algorithm']}_job_s{tail}": elapsed / len(times),
        f"{wl['algorithm']}_job_p95_s{tail}": percentile(times, 95),
    }
    metrics = {}
    if not trace:
        for m in metrics_for(manifest, name, "end_to_end"):
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        for m in metrics_for(manifest, name, "per_layer"):
            v = metric_reader(m["name"], bench_dir)(data)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": int(entry["chips"]), "memory_peak_bytes": int(peak)}
    if cuda:
        dev["nvidia_smi"] = card_line()
    result = {"correct": correct, "attempted": len(times), "failed": failed,
              "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = data.busy_s
        dev["window_s"] = data.window_s
        result["breakdown"] = trace_mod.breakdown(data)
    result["spans_s"] = spans
    result["job_times_s"] = dict(zip(("min", "q1", "median", "q3", "max"),
                                     (percentile(times, q) for q in (1e-9, 25, 50, 75, 100))))
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    return result
