#!/usr/bin/env python
"""North-star scale driver of the PyTorch port: full GRank and
MCCompletePathV2 with a quality evaluation on a soc-LiveJournal-class graph
(default 4.8M nodes / 69M edges), on one card.

The port's counterpart of ``examples/run_scale.py``, with its signature and
its ``scale_full_*`` keys.  Stages run in order (build, prep, grank, mc,
eval) and each prints one JSON line as it ends, so a run cut short keeps
what it measured; each line carries the stage's wall, the card's peak
allocated memory during the stage, whether the 2-colouring ran natively,
and the card's name and power limit.  The returned dict (printed last)
holds the ``scale_full_*`` keys.

Usage:
    python examples/run_scale_torch.py                 # the full north star
    python examples/run_scale_torch.py --nodes 1000000 --edges 10000000
    python examples/run_scale_torch.py --skip-mc       # GRank + eval only
    python examples/run_scale_torch.py --device cpu --nodes 2000 --edges 20000
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np
import torch

from approximated_personalized_pagerank_tpu_torch import (
    benchmark_sampled,
    grank_baskets,
    mccompletepathv2_baskets,
    sample_result,
)
from approximated_personalized_pagerank_tpu_torch.ops.merge import (
    net_max_width,
    resolve_merge_algo,
)
from approximated_personalized_pagerank_tpu_torch.utils import io
from approximated_personalized_pagerank_tpu_torch.utils.compare import basket_sha256
from approximated_personalized_pagerank_tpu_torch.utils.device import (
    card_line,
    resolve_device,
    synchronize,
)
from approximated_personalized_pagerank_tpu_torch.utils.synthetic import powerlaw_graph

class _Stages:
    """Times each stage and prints its JSON line through ``log``."""

    def __init__(self, dev, log):
        self.dev, self.log, self.card = dev, log, card_line() if dev.type == "cuda" else None

    def start(self) -> float:
        synchronize(self.dev)
        if self.dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.dev)
        return time.perf_counter()

    def end(self, stage: str, t0: float, **fields) -> float:
        synchronize(self.dev)
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(self.dev) if self.dev.type == "cuda" else None
        self.log(json.dumps({
            "stage": stage, "stage_wall_s": wall, "peak_allocated_bytes": peak,
            "native_partition": io.paths_ran()["bfs_bipartition"] == "native",
            "device": str(self.dev), "nvidia_smi": self.card, **fields}))
        return wall


def merges(graph, half_sweeps: int, L: int) -> int:
    """Basket-merge slot updates of ``half_sweeps`` half-sweeps: every edge
    out of the active partition brings one basket of L slots (partition 0
    sweeps first); run_scale.py's formula."""
    part = graph.partition
    deg = graph.out_degree.astype(np.int64)
    e0, e1 = int(deg[part == 0].sum()), int(deg[part == 1].sum())
    return ((half_sweeps + 1) // 2 * e0 + half_sweeps // 2 * e1) * L


def run_scale(
    nodes: int = 4_800_000,
    edges: int = 69_000_000,
    locality: float = 0.8,
    K: int = 50,
    L: int = 100,
    iterations: int = 30,
    damping: float = 0.85,
    tolerance: float = 1e-4,
    test_nodes: int = 100,
    mc_r: int = 200,
    # run_scale.py's MC width at 4.8M nodes, kept so both runs compare
    mc_l: int = 100,
    skip_mc: bool = False,
    seed: int = 7,
    log=None,
    device=None,
    merge_algo=None,
    mc_seed: int = 1,
    digests: bool = False,
    keep: dict | None = None,
) -> dict:
    """The north star's stages; returns the ``scale_full_*`` dict.

    ``log`` takes each stage's JSON line (default: print, flushed).
    ``device`` is where the run happens (None: the card); the graph is
    built anew each run (no pickle cache).  ``merge_algo`` is GRank's and
    MC's (None: the kernel on the card); ``mc_seed`` MC's walk seed
    (run_scale.py's is 1).  ``digests`` adds the sha256 of GRank's and
    MC's final baskets (``scale_full_grank_sha256``,
    ``scale_full_mc_sha256``), taken outside the timed stages.  ``keep``,
    a dict, receives the graph (``keep["graph"]``).
    """
    if log is None:
        import functools

        log = functools.partial(print, flush=True)
    dev = resolve_device(device)
    st = _Stages(dev, log)
    out: dict = {
        "scale_full_nodes": nodes,
        "scale_full_edges": edges,
        "scale_full_locality": locality,
    }

    # --- build the graph ---
    t0 = st.start()
    graph = powerlaw_graph(nodes, edges, seed=seed, locality=locality)
    if keep is not None:
        keep.update(graph=graph)
    deg = graph.out_degree
    out["scale_full_max_out_degree"] = int(deg.max())
    out["scale_full_dangling_nodes"] = int((deg == 0).sum())
    out["scale_full_build_s"] = st.end(
        "build", t0, num_nodes=graph.num_nodes, num_edges=graph.num_edges,
        **{k: out[k] for k in ("scale_full_max_out_degree", "scale_full_dangling_nodes")})

    # --- prep: the 2-colouring and the merge plans, on the host ---
    algo = resolve_merge_algo(merge_algo, dev)
    net = net_max_width(algo)
    plan_L = L if net else None
    t0 = st.start()
    graph.csc
    csc_s = time.perf_counter() - t0
    part = graph.partition
    colouring_s = time.perf_counter() - t0 - csc_s
    plans = [graph.merge_plan(p, L=plan_L, net_width=net) for p in (0, 1)]
    if not skip_mc:
        graph.merge_plan(None, L=mc_l if net else None, net_width=net)
    out["scale_full_prep_s"] = st.end(
        "prep", t0, csc_s=csc_s, colouring_s=colouring_s,
        partition_sizes=[int((part == 0).sum()), int((part == 1).sum())],
        buckets=[len(p.buckets) for p in plans], merge_algo=algo)

    # --- GRank, sparse engine, canonical config ---
    t0 = st.start()
    grank_baskets(graph, K, L, 2, damping, tolerance, engine="sparse",
                  merge_algo=algo, return_info=True, device=dev)
    out["scale_full_compile_s"] = st.end("grank_warmup", t0, half_sweeps=2)
    t0 = st.start()
    baskets, info = grank_baskets(graph, K, L, iterations, damping, tolerance,
                                  engine="sparse", merge_algo=algo, return_info=True,
                                  device=dev)
    synchronize(dev)
    wall = time.perf_counter() - t0
    out["scale_full_wall_s"] = wall
    out["scale_full_iterations"] = info["iterations_ran"]
    out["scale_full_merges_per_s"] = merges(graph, info["iterations_ran"], L) / wall
    st.end("grank", t0, K=K, L=L, tolerance=tolerance,
           **{k: out[k] for k in ("scale_full_wall_s", "scale_full_iterations",
                                  "scale_full_merges_per_s")})

    # sample the eval rows now (KBs to the host), free the full baskets
    g_sample = sample_result(baskets, graph, test_nodes, True, seed=0)
    if digests:
        out["scale_full_grank_sha256"] = basket_sha256(baskets)
    del baskets

    # --- MCCompletePathV2, full (walks + combine) ---
    mc_sample = None
    if not skip_mc:
        t0 = st.start()
        mc, mc_info = mccompletepathv2_baskets(
            graph, K, mc_l, mc_r, damping, seed=mc_seed, engine="sparse",
            merge_algo=algo, return_info=True, device=dev,
        )
        synchronize(dev)
        mc_wall = time.perf_counter() - t0
        out["scale_full_mc_wall_s"] = mc_wall
        out["scale_full_mc_r"] = mc_r
        out["scale_full_mc_walk_steps"] = mc_info["walk_steps"]
        out["scale_full_mc_walk_steps_per_s"] = mc_info["walk_steps"] / mc_wall
        out["scale_full_mc_abandoned_frac"] = (
            mc_info["abandoned_walks"] / max(mc_info["total_walks"], 1))
        mc_sample = sample_result(mc, graph, test_nodes, True, seed=0)
        st.end("mc", t0, mc_l=mc_l, mc_seed=mc_seed, total_walks=mc_info["total_walks"],
               **{k: v for k, v in out.items() if k.startswith("scale_full_mc_")})
        if digests:
            out["scale_full_mc_sha256"] = basket_sha256(mc)
        del mc

    # --- quality: one shared oracle pass for both algorithms ---
    t0 = st.start()
    all_stats = benchmark_sampled(
        [g_sample] + ([mc_sample] if mc_sample is not None else []), graph, device=dev)
    stats = all_stats[0]
    synchronize(dev)
    out["scale_full_eval_s"] = time.perf_counter() - t0
    out["scale_full_jaccard"] = stats["jaccard average"]
    out["scale_full_jaccard_min"] = stats["jaccard min"]
    out["scale_full_kendall"] = stats["kendall average"]
    out["scale_full_recall"] = stats["recall average"]
    if mc_sample is not None:
        out["scale_full_mc_jaccard"] = all_stats[1]["jaccard average"]
        out["scale_full_mc_recall"] = all_stats[1]["recall average"]
    st.end("eval", t0, test_nodes=int(g_sample.sources.size),
           **{k: out[k] for k in out if k.endswith(("jaccard", "jaccard_min", "kendall",
                                                     "recall"))})
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--nodes", type=int, default=4_800_000)
    ap.add_argument("--edges", type=int, default=69_000_000)
    ap.add_argument(
        "--locality", type=float, default=0.8,
        help="fraction of edges routed within communities (0 = pure "
        "configuration model; ~0.8 gives the community concentration of "
        "social graphs)",
    )
    ap.add_argument("--iterations", type=int, default=30)
    ap.add_argument("--tolerance", type=float, default=1e-4)
    ap.add_argument("--test-nodes", type=int, default=100)
    ap.add_argument("--mc-r", type=int, default=200)
    ap.add_argument("--skip-mc", action="store_true")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--merge-algo", default=None,
                    help="sort or kernel[:cap] (default: kernel on the card)")
    ap.add_argument("--mc-seed", type=int, default=1)
    args = ap.parse_args()
    out = run_scale(
        nodes=args.nodes,
        edges=args.edges,
        locality=args.locality,
        iterations=args.iterations,
        tolerance=args.tolerance,
        test_nodes=args.test_nodes,
        mc_r=args.mc_r,
        skip_mc=args.skip_mc,
        device=args.device,
        merge_algo=args.merge_algo,
        mc_seed=args.mc_seed,
    )
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
