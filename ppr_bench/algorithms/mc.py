"""MCCompletePathV2 jobs: ``mccompletepathv2_baskets(graph, K, L, R,
damping, seed=..., combine_passes=..., engine=..., return_info=True)`` as
users call it, on the program's ``Graph`` built from the cell's edges.  The
program runs the engine ``engine`` picks (``auto``: dense up to 32,768
nodes) with its defaults otherwise: uniform successor choice, the CUDA
merge kernel for the walks' top-L on the card, bfloat16 products in the
dense combine.  Every job draws its walks from the run's ``--seed``, so
every job of a run gives the same baskets.  Besides the program's counts,
a job's counters carry the ``seed`` its walks drew from: the check draws
the reference's walks from it."""

from __future__ import annotations

from ..reference import compare
from ..reference.mc import mccompletepathv2 as reference_mc
from .grank import digest, setup  # noqa: F401  (the same set-up and fingerprint)

DETERMINISTIC = True


def run(state, job, seed, index):
    from approximated_personalized_pagerank_tpu_torch import mccompletepathv2_baskets

    out, info = mccompletepathv2_baskets(
        state["graph"], job["K"], job["L"], job["R"], job["damping"], seed=seed,
        combine_passes=job["combine_passes"], engine=job.get("engine", "auto"),
        return_info=True, device=state["device"])
    return (out.ids, out.scores), {"jobs": 1, "walk_steps": int(info["walk_steps"]),
                                   "abandoned_walks": int(info["abandoned_walks"]),
                                   "seed": seed}


def reference(edges, job, seed, device, dtype=None, walks=None):
    """The plain reference's result for the cell's edges and ``seed`` on
    ``device``; ``dtype`` rounds its combine's product inputs (the
    control), ``walks`` reuses walks already run."""
    return reference_mc(
        edges.num_nodes, edges.src.to(device), edges.dst.to(device), job["L"], job["R"],
        job["damping"], seed, passes=job["combine_passes"], dtype=dtype, w=walks)


def gaps(ids, scores, counters, ref, n, K, limits):
    """The checks of a ``[N, K]`` result and its walk counters against the
    reference's result: well formed, the walks' counters exactly the
    reference's, and the basket gaps (reference/compare.py) within
    ``limits``."""
    checks = {"malformed": (0.0 if compare.well_formed(ids, scores, n, K) else 1.0, 0.0)}
    checks["walk_steps_gap"] = (float(abs(ref.walk_steps - counters["walk_steps"])), 0.0)
    checks["abandoned_gap"] = (float(abs(ref.abandoned_walks - counters["abandoned_walks"])), 0.0)
    found = (compare.basket_gaps(ids, scores, ref.ids, ref.scores)
             if checks["malformed"][0] == 0.0 else {})
    for name, limit in limits.items():
        checks[name] = (found.get(name, float("inf")), float(limit))
    return checks


def check(edges, output, counters, job, limits, device):
    """The reference's MC on the same edges and the job's seed (its
    counters'), then :func:`gaps`."""
    ids, scores = output
    ref = reference(edges, job, counters["seed"], device)
    return gaps(ids, scores, counters, ref, edges.num_nodes, job["K"], limits)
