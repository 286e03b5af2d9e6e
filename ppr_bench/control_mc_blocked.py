#!/usr/bin/env python3
"""Readings behind the limits of an MC cell checked in blocks.

    python3 ppr_bench/control_mc_blocked.py --workload northstar-mc --seeds 1-3 --control-seeds 1-3

For each seed: the cell's inputs, one job of the program exactly as the
window runs it, and the numbers its check compares
(algorithms/mc_blocked.py, reference/compare.py) against the plain
reference in blocks (reference/mc_blocked.py, float64 sums), every gap of
``algorithms/mc_blocked.py::basket_gaps`` beside them; for each
control seed also the control, the same reference with each combine
pass's input rows rounded to bfloat16 (below the float32 the
configuration states) and put in the program's place, on the reference's
own walks.  One JSON line a reading, with the seconds each side took.  A
limit sits above every program reading and below every control reading
(PERF.md gives the readings and the limits).  Runs on the card by default;
``--device cpu`` for small cells.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from ppr_bench.control import seed_list  # noqa: E402

CONTROL_DTYPE = "bfloat16"


def readings(name: str, seeds, control_seeds, device="cuda", bench_dir=None):
    """Yield one dict a reading (see the module doc)."""
    import importlib

    import torch

    from ppr_bench import harness
    from ppr_bench.algorithms import mc_blocked as algo
    from ppr_bench.reference.mc_blocked import walks

    files = harness.cell_files(name, bench_dir or harness.BENCH_DIR)
    wl, cfg = files["workload"], files["config"]
    if wl["algorithm"] != "mc_blocked":
        raise ValueError("readings are written for MC cells checked in blocks")
    gen = importlib.import_module(f"ppr_bench.graphs.{cfg['graph']['generator']}")
    job, limits = wl["job"], wl["limits"]
    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def reading(ids, scores, counters, ref):
        """The check's numbers, every gap of reference/compare.py beside
        them, and the verdict under the cell's limits."""
        checks = algo.gaps(ids, scores, counters, ref, ids.shape[0], job["K"], limits)
        out = {c: v for c, (v, _) in checks.items()}
        if not out["malformed"]:
            out.update(algo.basket_gaps(ids, scores, ref))
        out["correct"] = all(v <= lim for v, lim in checks.values())
        return out

    def free():
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

    for seed in seeds:
        t0 = time.perf_counter()
        edges = gen.make(cfg["graph"], seed, device)
        state = algo.setup(edges, job, lambda _name: contextlib.nullcontext(), device)
        inputs_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        (ids, scores), counters = algo.run(state, job, seed, 0)
        sync()
        job_s = time.perf_counter() - t0
        del state
        free()
        n, k = edges.num_nodes, job["K"]
        src, dst = edges.src.to(device), edges.dst.to(device)
        t0 = time.perf_counter()
        w = walks(n, src, dst, job["R"], job["damping"], seed, min(job["L"], n))
        sync()
        walks_s = time.perf_counter() - t0
        ref = algo.reference(edges, job, seed, device, walks=w)
        sync()
        ref_s = time.perf_counter() - t0
        yield {"cell": name, "seed": seed, "side": "program", "inputs_s": inputs_s,
               "job_s": job_s, "reference_s": ref_s, "reference_walks_s": walks_s,
               "walk_steps": counters["walk_steps"],
               "abandoned_walks": counters["abandoned_walks"],
               **reading(ids, scores, counters, ref)}
        del ids, scores
        free()
        if seed in control_seeds:
            t0 = time.perf_counter()
            ctl = algo.reference(edges, job, seed, device, dtype=getattr(torch, CONTROL_DTYPE),
                                 walks=w)
            sync()
            c_ids = ctl.ids[:, :k].contiguous()
            c_sc = ctl.scores[:, :k].to(torch.float32).contiguous()
            c_counters = {"walk_steps": ctl.walk_steps, "abandoned_walks": ctl.abandoned_walks}
            yield {"cell": name, "seed": seed, "side": f"control_{CONTROL_DTYPE}",
                   "control_s": time.perf_counter() - t0,
                   **reading(c_ids, c_sc, c_counters, ref)}
            del ctl, c_ids, c_sc
        del ref, w, src, dst
        free()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="e.g. 1-3 or 3,5,7")
    ap.add_argument("--control-seeds", default="", help="seeds that also run the control")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("control_mc_blocked.py: no CUDA card", file=sys.stderr)
        return 2
    for r in readings(args.workload, seed_list(args.seeds), set(seed_list(args.control_seeds)),
                      device=args.device):
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
