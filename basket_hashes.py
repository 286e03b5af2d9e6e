#!/usr/bin/env python3
"""sha256 of the final baskets of chip_smoke.py's main-path runs, on one card.

    python3 basket_hashes.py [--skip-north-star]

Runs, with the PyTorch port of the checkout this script sits in, the runs
whose final baskets chip_smoke.py phases 2, 3, 4 and 8f hash: sparse GRank on
Eat (K=50, L=100, 30 half-sweeps, tol 1e-4), two GRank half-sweeps on
``powerlaw_graph(1_000_000, 10_000_000, seed=7, locality=0.8)``, sparse
MCCompletePathV2 on Eat (K=50, L=200, R=1000, seed 1), and the north star's
GRank and MC (``examples/run_scale_torch.py``: 4.8M nodes, 69M edges; GRank
K=50, L=100, 30 half-sweeps, tol 1e-4; MC mc_l=100, R=200, seed 1).  Prints
one JSON line of digests: the ids' int32 bytes, then the scores' float32
bits.  It needs nothing newer than the port's entry points, so copied into
an older checkout it hashes that checkout's runs, and two trees can be held
bit for bit in one call.  Exits non-zero without a CUDA card.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

K, L, ITERS, DAMPING, TOL = 50, 100, 30, 0.85, 1e-4


def sha256(baskets) -> str:
    ids = np.ascontiguousarray(baskets.ids.cpu().numpy(), dtype=np.int32)
    bits = np.ascontiguousarray(baskets.scores.cpu().numpy(), dtype=np.float32).view(np.int32)
    h = hashlib.sha256(ids.tobytes())
    h.update(bits.tobytes())
    return h.hexdigest()


def main() -> int:
    if not torch.cuda.is_available():
        print("basket_hashes: no CUDA device", file=sys.stderr)
        return 1
    from approximated_personalized_pagerank_tpu_torch import (
        grank_baskets,
        load_eat_graph,
        mccompletepathv2_baskets,
    )
    from approximated_personalized_pagerank_tpu_torch.utils.synthetic import powerlaw_graph

    out = {"device": torch.cuda.get_device_name(0)}
    eat = load_eat_graph()
    out["phase2_eat_grank"] = sha256(grank_baskets(eat, K, L, ITERS, DAMPING, TOL,
                                                   engine="sparse"))
    big = powerlaw_graph(1_000_000, 10_000_000, seed=7, locality=0.8)
    out["phase3_1m_grank"] = sha256(grank_baskets(big, K, L, 2, DAMPING, -1.0,
                                                  engine="sparse"))
    del big
    out["phase4_eat_mc"] = sha256(mccompletepathv2_baskets(eat, 50, 200, 1000, DAMPING,
                                                          seed=1, engine="sparse"))
    if "--skip-north-star" not in sys.argv[1:]:
        star = powerlaw_graph(4_800_000, 69_000_000, seed=7, locality=0.8)
        out["phase8f_north_star_grank"] = sha256(grank_baskets(
            star, K, L, ITERS, DAMPING, TOL, engine="sparse", device="cuda"))
        out["phase8f_north_star_mc"] = sha256(mccompletepathv2_baskets(
            star, K, 100, 200, DAMPING, seed=1, engine="sparse", device="cuda"))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
