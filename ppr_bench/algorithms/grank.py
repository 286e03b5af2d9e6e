"""GRank jobs: ``grank_baskets(graph, K, L, iterations, damping, tolerance,
engine=...)`` as users call it, on the program's ``Graph`` built from the
cell's edges.  The program runs the engine ``engine`` picks (``auto``:
sparse above 16,384 nodes) with its default merge pipeline (the CUDA merge
kernel on the card)."""

from __future__ import annotations

import torch

from ..reference import compare
from ..reference.grank import grank as reference_grank

DETERMINISTIC = True


def setup(edges, job, span, device):
    from approximated_personalized_pagerank_tpu_torch import Graph

    src, dst = edges.src.numpy(), edges.dst.numpy()
    with span("graph_build"):
        graph = Graph.from_edges(src, dst, num_nodes=edges.num_nodes)
    with span("csc"):
        graph.csc
    with span("partition"):
        graph.partition
    return {"graph": graph, "device": device}


def run(state, job, seed, index):
    from approximated_personalized_pagerank_tpu_torch import grank_baskets

    out, info = grank_baskets(
        state["graph"], job["K"], job["L"], job["iterations"], job["damping"],
        job["tolerance"], engine=job.get("engine", "auto"), return_info=True,
        device=state["device"])
    return (out.ids, out.scores), {"iterations_ran": int(info["iterations_ran"])}


def digest(output, block: int = 1 << 22):
    """Two int64 sums (wrapping) of the ids' and the scores' bits, each
    slot weighted by an odd multiple of its position; in blocks of slots,
    so that its temporaries stay small beside the program's memory."""
    ids, scores = (t.reshape(-1) for t in output)
    acc = torch.zeros(2, dtype=torch.int64, device=ids.device)
    for a in range(0, ids.numel(), block):
        w = torch.arange(a, min(a + block, ids.numel()), dtype=torch.int64, device=ids.device)
        w = w * -0x61C8864680B583EB + 0x632BE59BD9B4E019
        acc[0] += (ids[a:a + block].to(torch.int64) * w).sum()
        acc[1] += (scores[a:a + block].view(torch.int32).to(torch.int64) * w).sum()
    return acc


def check(edges, output, counters, job, limits, device):
    """The reference's GRank on the same edges, then the checks: the output
    is well formed, ran the reference's number of half-sweeps, and its
    basket gaps (reference/compare.py) are within their limits."""
    ids, scores = output
    n = edges.num_nodes
    checks = {"malformed": (0.0 if compare.well_formed(ids, scores, n, job["K"]) else 1.0, 0.0)}
    ref = reference_grank(
        n, edges.src.to(device), edges.dst.to(device), job["K"], job["L"],
        job["iterations"], job["damping"], job["tolerance"])
    checks["half_sweeps_gap"] = (float(abs(ref.iterations_ran - counters["iterations_ran"])), 0.0)
    gaps = (compare.basket_gaps(ids, scores, ref.ids, ref.scores)
            if checks["malformed"][0] == 0.0 else {})
    for name, limit in limits.items():
        checks[name] = (gaps.get(name, float("inf")), float(limit))
    return checks
