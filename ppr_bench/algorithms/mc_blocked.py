"""MCCompletePathV2 jobs at a scale whose ``[N, N]`` matrices no card holds:
``algorithms/mc.py``'s jobs (the same public call, set-up and fingerprint,
every job on the run's ``--seed``), checked against the plain reference in
blocks (``reference/mc_blocked.py``) in place of the dense one.

The checks are ``algorithms/mc.py``'s (well formed, the walks' counters
exactly the reference's, the basket gaps within the cell's limits) and
beside the gaps, ``share_over_<t>``: the share of the N x K slots whose
rank gap exceeds ``t`` (reference/compare.py counts them as
``slots_over_<t>``).  The widest and mean gaps see where the program's
own choices (which of equal counts or sums a fixed-width row keeps, the
hub rows' hierarchical merge) move a score; the share sees a lower
precision, which moves nearly every score a little.
"""

from __future__ import annotations

from ..reference import compare
from ..reference.mc_blocked import mccompletepathv2 as reference_mc
from .mc import DETERMINISTIC, digest, run, setup  # noqa: F401  (the same jobs)


def reference(edges, job, seed, device, dtype=None, walks=None):
    """The blocked reference's result for the cell's edges and ``seed`` on
    ``device``; ``dtype`` rounds each combine pass's input rows (the
    control), ``walks`` reuses walks already run."""
    return reference_mc(
        edges.num_nodes, edges.src.to(device), edges.dst.to(device), job["L"], job["R"],
        job["damping"], seed, passes=job["combine_passes"], dtype=dtype, w=walks)


def basket_gaps(ids, scores, ref):
    """reference/compare.py's gaps of a ``[N, K]`` result against the
    reference's, with each count ``slots_over_<t>`` also as a share of the
    N x K slots, ``share_over_<t>``."""
    found = compare.basket_gaps(ids, scores, ref.ids, ref.scores)
    slots = max(ids.numel(), 1)
    found.update({f"share_over_{t:g}": found[f"slots_over_{t:g}"] / slots
                  for t in compare.THRESHOLDS})
    return found


def gaps(ids, scores, counters, ref, n, K, limits):
    """The checks of a ``[N, K]`` result and its walk counters against the
    reference's result: well formed, the walks' counters exactly the
    reference's, and the gaps of :func:`basket_gaps` that ``limits``
    names within them."""
    checks = {"malformed": (0.0 if compare.well_formed(ids, scores, n, K) else 1.0, 0.0)}
    checks["walk_steps_gap"] = (float(abs(ref.walk_steps - counters["walk_steps"])), 0.0)
    checks["abandoned_gap"] = (float(abs(ref.abandoned_walks - counters["abandoned_walks"])), 0.0)
    found = basket_gaps(ids, scores, ref) if checks["malformed"][0] == 0.0 else {}
    for name, limit in limits.items():
        checks[name] = (found.get(name, float("inf")), float(limit))
    return checks


def check(edges, output, counters, job, limits, device):
    """The blocked reference's MC on the same edges and the job's seed (its
    counters'), then :func:`gaps`."""
    ids, scores = output
    ref = reference(edges, job, counters["seed"], device)
    return gaps(ids, scores, counters, ref, edges.num_nodes, job["K"], limits)
