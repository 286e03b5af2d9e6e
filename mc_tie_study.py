#!/usr/bin/env python3
"""MCCompletePathV2 on one power-law graph through both packages, on the CPU.

    python3 mc_tie_study.py run jax-sort|jax-bitonic|jax-pallas|port|port-kernel [--nodes N] [--seed S]
    python3 mc_tie_study.py compare [--nodes N]
    python3 mc_tie_study.py walks [--nodes N]

Asks whether the port's MC quality at the north star's configuration (K=50,
mc_l=100, R=200, seed 1, sparse engine, 32 strict sources) differs from the
JAX package's by more than the cut of tied visit counts.  ``run`` builds
``powerlaw_graph(N, 14.375 N, seed=7, locality=0.8)`` (the north star's
edge density), runs MC and scores it against the exact oracle with its own
package's harness, and saves the baskets and figures under
``build/mc_tie_study/``.  ``jax-sort``, ``jax-bitonic`` and ``jax-pallas``
run the JAX package with that merge pipeline in every merge, the walks'
trace top-L included (through ``PPR_MERGE_ALGO``: the JAX package does not
pass ``merge_algo`` to the trace top-L): ``sort`` cuts ties as
``lax.top_k`` does (equal counts to the smaller id), ``bitonic`` by the
full descending network of ``bitonic_merge_topk``, and ``pallas`` is the
TPU kernel itself (``bitonic_prune_topk`` after the run sums, in interpret
mode on the CPU).  ``port`` runs the port on the CPU with its sort
pipeline, ``port-kernel`` with its kernel pipeline (the plain versions of
the merge kernel, which cut ties as the TPU kernel does).  ``--seed`` (default 1) is MC's seed; other seeds give the
spread of the quality figures.  ``compare`` prints each run's quality and, row by row, how many
of the port's ids each JAX run shares, and how many of ``port-kernel``'s
rows equal ``jax-pallas``'s.  ``walks`` walks every source chunk
of seed 1 through both packages' trace engines and counts the rows whose
traces differ.  Each mode runs in a process of its own, as the JAX
pipeline is fixed when the package is imported.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

K, MC_L, MC_R, DAMPING, TEST_NODES = 50, 100, 200, 0.85, 32
EDGES_PER_NODE = 69_000_000 / 4_800_000
OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "mc_tie_study")
MODES = ("jax-sort", "jax-bitonic", "jax-pallas", "port", "port-kernel")


def _path(mode: str, nodes: int, seed: int = 1) -> str:
    return os.path.join(OUT_DIR, f"{mode}_{nodes}_seed{seed}.npz")


def run(mode: str, nodes: int, seed: int) -> dict:
    edges = int(round(nodes * EDGES_PER_NODE))
    if mode.startswith("port"):
        from approximated_personalized_pagerank_tpu_torch import (
            benchmark_sampled, mccompletepathv2_baskets, sample_result,
        )
        from approximated_personalized_pagerank_tpu_torch.utils.synthetic import powerlaw_graph

        algo = "kernel" if mode == "port-kernel" else "sort"

        def mc(graph):
            return mccompletepathv2_baskets(graph, K, MC_L, MC_R, DAMPING, seed=seed,
                                            engine="sparse", return_info=True, device="cpu",
                                            merge_algo=algo)
    else:
        os.environ["PPR_MERGE_ALGO"] = mode.split("-")[1]
        import jax

        jax.config.update("jax_platforms", "cpu")
        from approximated_personalized_pagerank_tpu import mccompletepathv2_baskets
        from approximated_personalized_pagerank_tpu.models.benchmark import (
            benchmark_sampled, sample_result,
        )
        from approximated_personalized_pagerank_tpu.utils.synthetic import powerlaw_graph

        def mc(graph):
            return mccompletepathv2_baskets(graph, K, MC_L, MC_R, DAMPING, seed=seed,
                                            engine="sparse", return_info=True)
    t0 = time.perf_counter()
    graph = powerlaw_graph(nodes, edges, seed=7, locality=0.8)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    baskets, info = mc(graph)
    ids, scores = np.asarray(baskets.ids), np.asarray(baskets.scores)
    mc_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    kw = {"device": "cpu"} if mode.startswith("port") else {}
    stats = benchmark_sampled([sample_result(baskets, graph, TEST_NODES, True, seed=0)], graph,
                              **kw)[0]
    eval_s = time.perf_counter() - t0
    out = {"mode": mode, "nodes": nodes, "edges": edges, "seed": seed, "build_s": build_s, "mc_s": mc_s,
           "eval_s": eval_s, "walk_steps": int(info["walk_steps"]),
           "abandoned_walks": int(info["abandoned_walks"]),
           "jaccard": float(stats["jaccard average"]), "recall": float(stats["recall average"]),
           "kendall": float(stats["kendall average"])}
    os.makedirs(OUT_DIR, exist_ok=True)
    np.savez(_path(mode, nodes, seed), ids=ids, scores=scores, figures=json.dumps(out))
    return out


def compare(nodes: int) -> dict:
    runs = {m: np.load(_path(m, nodes)) for m in MODES if os.path.exists(_path(m, nodes))}
    out = {m: json.loads(str(r["figures"])) for m, r in runs.items()}
    seeds = sorted(f for f in os.listdir(OUT_DIR) if f.startswith(f"port_{nodes}_seed"))
    out["port_jaccard_by_seed"] = {f[:-4].split("seed")[1]: json.loads(str(
        np.load(os.path.join(OUT_DIR, f))["figures"]))["jaccard"] for f in seeds}
    pairs = [("port", m) for m in runs if m != "port"] + [("port-kernel", "jax-pallas")]
    for a, b in pairs:
        if a not in runs or b not in runs:
            continue
        mine, other = runs[a]["ids"], runs[b]["ids"]
        same = (other == mine).all(axis=1)
        shared = [np.intersect1d(x[x >= 0], y[y >= 0]).size / max(1, (x >= 0).sum())
                  for x, y in zip(mine, other)]
        out[f"{a}_vs_{b}"] = {"rows": int(mine.shape[0]), "identical_rows": int(same.sum()),
                              "mean_shared_id_share": float(np.mean(shared)),
                              "min_shared_id_share": float(np.min(shared)),
                              "max_abs_score_diff_identical_rows": float(np.abs(
                                  runs[a]["scores"] - runs[b]["scores"])[same].max(initial=0.0))}
    return out


def walks(nodes: int) -> dict:
    """Seed 1's visit traces, chunk by chunk, in both packages."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import torch

    from approximated_personalized_pagerank_tpu.models.common import device_graph
    from approximated_personalized_pagerank_tpu.ops import walk as jw
    from approximated_personalized_pagerank_tpu.utils.synthetic import powerlaw_graph as jgraph
    from approximated_personalized_pagerank_tpu_torch.ops import walk as tw
    from approximated_personalized_pagerank_tpu_torch.utils.synthetic import powerlaw_graph

    edges = int(round(nodes * EDGES_PER_NODE))
    gj = jgraph(nodes, edges, seed=7, locality=0.8)
    gt = powerlaw_graph(nodes, edges, seed=7, locality=0.8)
    dj, dt = device_graph(gj), gt.device_graph("cpu")
    start_deg = jnp.stack([dj.indptr[:-1].astype(jnp.int32), dj.out_degree.astype(jnp.int32)], -1)
    chunk, _, slots, total, macro, _ = tw._trace_chunks(nodes, MC_R, DAMPING, None, None, 32)
    root_j, root_t = jax.random.PRNGKey(1), tw._root_key(1)
    out = {"nodes": nodes, "chunks": 0, "visits": 0, "rows_differing": 0}
    for s in range(0, nodes, chunk):
        real = min(chunk, nodes - s)
        src = np.pad(np.arange(s, s + real, dtype=np.int32), (0, chunk - real))
        tj, _ = jw.walk_trace_chunk(start_deg, dj.indices, jnp.asarray(src),
                                    jax.random.fold_in(root_j, s), jnp.float32(DAMPING),
                                    jnp.int32(total), slots, macro, 32)
        tt, _ = tw.walk_trace_chunk(dt.start_deg, dt.indices, tw._chunk_sources(s, nodes, chunk, "cpu")[0],
                                    tw.fold_in(root_t, s), torch.tensor(DAMPING), total, slots, macro, 32)
        tj, tt = np.asarray(tj)[:real], tt.numpy()[:real]
        out["chunks"] += 1
        out["visits"] += int((tt >= 0).sum())
        out["rows_differing"] += int((~(tj == tt).all(axis=1)).sum())
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("what", choices=("run", "compare", "walks"))
    ap.add_argument("mode", nargs="?", choices=MODES)
    ap.add_argument("--nodes", type=int, default=200_000)
    ap.add_argument("--seed", type=int, default=1)
    a = ap.parse_args()
    if a.what == "run":
        if a.mode is None:
            ap.error("run needs a mode")
        print(json.dumps(run(a.mode, a.nodes, a.seed)), flush=True)
    elif a.what == "walks":
        print(json.dumps(walks(a.nodes)), flush=True)
    else:
        print(json.dumps(compare(a.nodes), indent=1), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
