#!/usr/bin/env python3
"""Run one cell of the benchmark of ``approximated_personalized_pagerank_tpu_torch``.

    python3 ppr_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks for
(BENCHMARK.json).  The last line of standard output is the result (JSON);
the last lines of standard error are the checks that decide ``correct``,
each beside its limit.  Without a card, or with too few, the run exits
with code 2 and prints no result.
"""

import time

T_START = time.perf_counter()

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Kernel caches stay at fixed places inside the checkout, so that only a
# cell's first run there compiles (the merge kernel and the native loader
# build into build/kernels and build/native beside the package).
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build", "torch_extensions")
sys.path.insert(0, ROOT)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    import torch

    from ppr_bench import harness

    manifest = harness.load_json(harness.MANIFEST)
    chips = int(harness.manifest_cell(manifest, args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"ppr_bench: the cell needs {chips} CUDA card(s), this machine has {have}",
              file=sys.stderr)
        return 2
    result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                              device="cuda", manifest=manifest, t_start=T_START)
    found = harness.forbidden_loaded()
    if found:
        print(f"ppr_bench: modules loaded that the run must not load: {', '.join(found)}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
