#!/usr/bin/env python3
"""Readings behind the limits of a cell's checks.

    python3 ppr_bench/control.py --workload <cell> --seeds 1-12 --control-seeds 1-3

For each seed: the cell's inputs, one job of the program exactly as the
window runs it, and the numbers its check compares (reference/compare.py)
against the plain reference in float32; for each control seed also the
control, the same reference computed in bfloat16 and put in the program's
place, held to the same numbers.  One JSON line a reading.  A limit sits
above every program reading and below every control reading
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


def seed_list(text: str) -> list:
    out = []
    for part in filter(None, text.split(",")):
        lo, _, hi = part.partition("-")
        out.extend(range(int(lo), int(hi or lo) + 1))
    return out


def readings(name: str, seeds, control_seeds, device="cuda", bench_dir=None):
    """Yield one dict a reading (see the module doc)."""
    import importlib

    import torch

    from ppr_bench import harness
    from ppr_bench.reference import compare
    from ppr_bench.reference.grank import grank as reference_grank

    files = harness.cell_files(name, bench_dir or harness.BENCH_DIR)
    wl, cfg = files["workload"], files["config"]
    if wl["algorithm"] != "grank":
        raise ValueError("readings are written for GRank cells")
    algo = importlib.import_module(f"ppr_bench.algorithms.{wl['algorithm']}")
    gen = importlib.import_module(f"ppr_bench.graphs.{cfg['graph']['generator']}")
    job = wl["job"]
    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    for seed in seeds:
        edges = gen.make(cfg["graph"], seed, device)
        state = algo.setup(edges, job, lambda _name: contextlib.nullcontext(), device)
        t0 = time.perf_counter()
        (ids, scores), counters = algo.run(state, job, seed, 0)
        sync()
        job_s = time.perf_counter() - t0
        del state
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        src, dst = edges.src.to(device), edges.dst.to(device)
        args = (edges.num_nodes, src, dst, job["K"], job["L"], job["iterations"],
                job["damping"], job["tolerance"])
        t0 = time.perf_counter()
        ref = reference_grank(*args)
        sync()
        ref_s = time.perf_counter() - t0
        gaps = compare.basket_gaps(ids, scores, ref.ids, ref.scores)
        yield {"cell": name, "seed": seed, "side": "program", "job_s": job_s,
               "reference_s": ref_s, "half_sweeps": counters["iterations_ran"],
               "reference_half_sweeps": ref.iterations_ran,
               "well_formed": compare.well_formed(ids, scores, edges.num_nodes, job["K"]),
               **gaps}
        del ids, scores
        if seed in control_seeds:
            t0 = time.perf_counter()
            ctl = reference_grank(*args, dtype=torch.bfloat16)
            sync()
            k = job["K"]
            c_ids, c_sc = ctl.ids[:, :k].contiguous(), ctl.scores[:, :k].contiguous()
            yield {"cell": name, "seed": seed, "side": "control_bfloat16",
                   "control_s": time.perf_counter() - t0,
                   "half_sweeps": ctl.iterations_ran,
                   **compare.basket_gaps(c_ids, c_sc, ref.ids, ref.scores)}
            del ctl, c_ids, c_sc
        del ref, src, dst
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="e.g. 1-12 or 3,5,7")
    ap.add_argument("--control-seeds", default="", help="seeds that also run the control")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("control.py: no CUDA card", file=sys.stderr)
        return 2
    for r in readings(args.workload, seed_list(args.seeds), set(seed_list(args.control_seeds)),
                      device=args.device):
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
