#!/usr/bin/env python3
"""MCCompletePathV2 through both packages, stage by stage.

    python3 mc_tie_study.py stages MODE [--nodes N | --eat] [--seed S] [--from MODE] [--no-one-call]
    python3 mc_tie_study.py compare [--nodes N | --eat] [--seed S]
    python3 mc_tie_study.py groups [--nodes N | --eat] [--stage pass1|pass2] [--rows R,..]
    python3 mc_tie_study.py walks [--nodes N]
    python3 mc_tie_study.py auto [--seed S]
    python3 mc_tie_study.py card [--nodes N] [--seeds 1,2,3,4] [--pipelines kernel,sort]

Asks where the port's MC parts from the JAX package's, and whether by more
than the cut of tied totals and the order of sums.  The graph is
``powerlaw_graph(N, 14.375 N, seed=7, locality=0.8)`` (the north star's
edge density) at the north star's MC (K=50, mc_l=100, R=200, 32 strict
sources), or with ``--eat`` the bundled Eat graph at bench.py's MC (K=50,
L=200, R=1000, 200 strict sources); the sparse engine unless said.

MODE names a package and its merge pipeline, in every merge, the walks'
trace top-L included: ``jax-sort``, ``jax-bitonic`` and ``jax-pallas`` run
the JAX package through ``PPR_MERGE_ALGO`` (it does not pass ``merge_algo``
to the trace top-L; the pipeline is fixed when the package is imported, so
each mode runs in a process of its own).  ``sort`` cuts ties as
``lax.top_k`` does, ``bitonic`` by the full network of
``bitonic_merge_topk``, ``pallas`` is the TPU kernel itself in interpret
mode.  ``port`` is the port's sort pipeline on the CPU, ``port-kernel`` its
kernel pipeline (the kernel's plain versions, which keep ties as the TPU
kernel does).

``stages`` runs MC as ``mccompletepathv2_baskets`` does, one stage at a
time through its own package's functions (the walks, the combine sweep once
a pass, the final cut to K), saves each stage's baskets and sha256 under
``build/mc_tie_study/``, and asserts that the staged final equals the
one-call result bit for bit.  A port mode with ``--from MODE`` also runs
each combine pass and the final cut from MODE's saved input to that stage
(the ``_shared`` stages), so a stage is judged on a shared input.
``compare`` reports, for the pairs port / jax-sort and port-kernel /
jax-pallas (or jax-bitonic where no jax-pallas run exists), stage by
stage: identical rows; rows that part beyond ties at the cut and the order
of sums (``utils/compare.py::topl_max_error`` at ``STAGE_ATOL``) and how
many of those take the hub path; the mean and least share of shared ids;
the largest score difference on ids both keep; and quality on the strict
sources with each stage's baskets cut to K (one oracle pass, the port's
harness for every run).  ``groups`` opens up the hub rows where
port-kernel and jax-pallas part on a shared input: each hub group's top M
in both packages, the ids only one side keeps, and how many ids sit at the
group's cut in exact sums.  ``walks`` walks every source chunk of seed 1
through both packages' trace engines and counts the rows whose traces
differ.  ``auto`` runs Eat's MC in one call of the JAX package through
``engine="auto"`` (the dense engine there, as bench.py's TPU run took it)
on the CPU, scored with the port's harness.

``card`` (the port alone, no JAX) runs on the card: MC at each seed through
each pipeline, their jaccard, recall and kendall from one oracle pass, and
the kernel against its plain version on the real combine rows of the
sampled sources and of the largest hubs in both passes, hub groups apart.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import time

import numpy as np

K, MC_L, MC_R, DAMPING, TEST_NODES = 50, 100, 200, 0.85, 32
EAT = {"K": 50, "L": 200, "R": 1000, "test_nodes": 200}
EDGES_PER_NODE = 69_000_000 / 4_800_000
OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "mc_tie_study")
MODES = ("jax-sort", "jax-bitonic", "jax-pallas", "port", "port-kernel")
STAGES = ("walk", "pass1", "pass2", "final")
# Two runs of one stage agree up to the order of sums when every row keeps
# the same ids up to ties at the cut and the same scores within this.
STAGE_ATOL = 2e-6


def _stage_path(mode: str, tag: str, seed: int) -> str:
    return os.path.join(OUT_DIR, f"stages_{tag}_{mode}_seed{seed}.npz")


def _config(eat: bool, nodes: int) -> dict:
    if eat:
        return dict(EAT, tag="eat")
    return {"K": K, "L": MC_L, "R": MC_R, "test_nodes": TEST_NODES, "tag": str(nodes),
            "nodes": nodes, "edges": int(round(nodes * EDGES_PER_NODE))}


def _sha(ids, scores) -> str:
    """``utils/compare.py::basket_sha256`` on numpy arrays."""
    h = hashlib.sha256(np.ascontiguousarray(ids, dtype=np.int32).tobytes())
    h.update(np.ascontiguousarray(scores, dtype=np.float32).view(np.int32).tobytes())
    return h.hexdigest()


def _jax_setup(mode: str):
    os.environ["PPR_MERGE_ALGO"] = mode.split("-")[1]
    import jax

    jax.config.update("jax_platforms", "cpu")


# ------------------------------------------------------------------ stages
def port_stages(graph, cfg: dict, seed: int, algo: str, device, inputs=None):
    """Yield ``(stage, Baskets)`` of the port's MC as
    ``models/mccompletepathv2.py::mccompletepathv2_baskets`` runs it on the
    sparse engine.  With ``inputs`` (a stage name -> (ids, scores) of the
    stage before it) each combine pass and the final cut also run from
    that input, yielded as ``(stage + "_shared", Baskets)``."""
    import torch

    from approximated_personalized_pagerank_tpu_torch.ops.basket import keep_top_chunked
    from approximated_personalized_pagerank_tpu_torch.ops.merge import (
        device_plan, merge_sweep, net_max_width,
    )
    from approximated_personalized_pagerank_tpu_torch.ops.walk import walk_baskets
    from approximated_personalized_pagerank_tpu_torch.utils.convert import baskets_from_numpy

    L = cfg["L"]
    basket, info = walk_baskets(graph, L, cfg["R"], DAMPING, seed=seed, return_info=True,
                                merge_algo=algo, device=device)
    yield "walk", basket, info
    net = net_max_width(algo)
    plan = graph.merge_plan(None, L=L if net else None, net_width=net)
    hub_sub = max((net - 1) // L, 1) if net else None
    buckets = device_plan(plan, device)
    damping = torch.tensor(DAMPING, dtype=torch.float32, device=device)

    def combine(b):
        return merge_sweep(b, buckets, damping, L, algo, mode="mc_combine",
                           hub_sub=hub_sub)[0]

    for stage in ("pass1", "pass2"):
        basket = combine(basket)
        yield stage, basket, None
        if inputs is not None:
            yield stage + "_shared", combine(baskets_from_numpy(*inputs[stage], device)), None
    yield "final", keep_top_chunked(basket.ids, basket.scores, cfg["K"]), None
    if inputs is not None:
        b = baskets_from_numpy(*inputs["final"], device)
        yield "final_shared", keep_top_chunked(b.ids, b.scores, cfg["K"]), None


def _jax_stages(graph, cfg: dict, seed: int):
    """The JAX package's MC as ``models/mccompletepathv2.py``'s
    ``mccompletepathv2_baskets`` runs it on the sparse engine (its lines
    160-176), with the pipeline ``PPR_MERGE_ALGO`` names: a combine pass
    is its jitted ``_combine_pass``.  In the network pipelines the pass
    runs one bucket at a time, each from the pass's input, its rows then
    written into the pass's output (bitwise the whole pass: the one-call
    check holds at 3,000 nodes), with ``jax.clear_caches()`` between
    buckets: at 200,000 nodes
    the whole pass's interpret-mode Pallas program maps more code than a
    Linux process may hold (``vm.max_map_count``, 65,530 by default), and
    the process dies."""
    import jax
    import jax.numpy as jnp

    from approximated_personalized_pagerank_tpu.models.mccompletepathv2 import _combine_pass
    from approximated_personalized_pagerank_tpu.ops.basket import Baskets, keep_top_chunked
    from approximated_personalized_pagerank_tpu.ops.merge import (
        DEFAULT_ELEM_BUDGET, device_plan, net_max_width,
    )
    from approximated_personalized_pagerank_tpu.ops.walk import walk_baskets

    L, n = cfg["L"], graph.num_nodes
    basket, info = walk_baskets(graph, L, cfg["R"], DAMPING, seed=seed, return_info=True)
    yield "walk", basket, info
    net = net_max_width(None)
    plan = graph.merge_plan(None, L=L if net else None, net_width=net)
    hub_sub = max((net - 1) // L, 1) if net else None
    buckets = device_plan(plan, n)

    def combine(b, bks):
        # _combine_pass donates its input: give it a copy
        return _combine_pass(Baskets(jnp.copy(b.ids), jnp.copy(b.scores)), bks,
                             jnp.float32(DAMPING), L, n, DEFAULT_ELEM_BUDGET, hub_sub=hub_sub)

    for stage in ("pass1", "pass2"):
        if not net:
            basket = combine(basket, buckets)
            yield stage, basket, None
            continue
        ids, scores = basket.ids, basket.scores
        for b in buckets:
            part = combine(basket, (b,))
            ids = ids.at[b.rows].set(part.ids[b.rows], mode="drop")
            scores = scores.at[b.rows].set(part.scores[b.rows], mode="drop")
            del part
            jax.clear_caches()
        basket = Baskets(ids, scores)
        yield stage, basket, None
    yield "final", keep_top_chunked(basket.ids, basket.scores, cfg["K"]), None


def _load_graph(cfg: dict, jax_side: bool):
    if jax_side:
        import approximated_personalized_pagerank_tpu as pkg
        from approximated_personalized_pagerank_tpu.utils.synthetic import powerlaw_graph
    else:
        import approximated_personalized_pagerank_tpu_torch as pkg
        from approximated_personalized_pagerank_tpu_torch.utils.synthetic import powerlaw_graph
    if cfg["tag"] == "eat":
        return pkg.load_eat_graph()
    return powerlaw_graph(cfg["nodes"], cfg["edges"], seed=7, locality=0.8)


def stages(mode: str, cfg: dict, seed: int, source: str | None = None,
           one_call: bool = True) -> dict:
    """Run ``mode`` stage by stage, save each stage, check the one-call
    result unless ``one_call`` is False (the JAX package's Pallas pipeline
    in one call cannot run at 200,000 nodes on the CPU, see
    :func:`_jax_stages`); ``source`` names the run whose inputs the
    ``_shared`` stages start from (port modes only)."""
    jax_side = not mode.startswith("port")
    inputs = None
    if jax_side:
        _jax_setup(mode)
    elif source is not None:
        ref = np.load(_stage_path(source, cfg["tag"], seed))
        before = {"pass1": "walk", "pass2": "pass1", "final": "pass2"}
        inputs = {s: (ref[f"{b}_ids"], ref[f"{b}_scores"]) for s, b in before.items()}
    t0 = time.perf_counter()
    graph = _load_graph(cfg, jax_side)
    out = {"mode": mode, "tag": cfg["tag"], "seed": seed, "from": source,
           "nodes": graph.num_nodes, "max_out_degree": int(graph.out_degree.max()),
           "build_s": time.perf_counter() - t0, "stage_s": {}, "sha256": {}}
    arrays = {}
    t0 = time.perf_counter()
    if jax_side:
        gen = _jax_stages(graph, cfg, seed)
    else:
        algo = "kernel" if mode == "port-kernel" else "sort"
        gen = port_stages(graph, cfg, seed, algo, "cpu", inputs)
    for stage, b, info in gen:
        ids, scores = np.asarray(b.ids), np.asarray(b.scores)
        arrays[f"{stage}_ids"], arrays[f"{stage}_scores"] = ids, scores
        out["sha256"][stage] = _sha(ids, scores)
        out["stage_s"][stage] = time.perf_counter() - t0
        if info is not None:
            out.update({k: int(v) for k, v in info.items()})
        print(f"{mode}: {stage} in {out['stage_s'][stage]:.1f} s", file=sys.stderr, flush=True)
        t0 = time.perf_counter()
    out["one_call_sha256"] = None
    if one_call and jax_side:
        from approximated_personalized_pagerank_tpu import mccompletepathv2_baskets

        one = mccompletepathv2_baskets(graph, cfg["K"], cfg["L"], cfg["R"], DAMPING, seed=seed,
                                       engine="sparse")
    elif one_call:
        from approximated_personalized_pagerank_tpu_torch import mccompletepathv2_baskets

        one = mccompletepathv2_baskets(graph, cfg["K"], cfg["L"], cfg["R"], DAMPING, seed=seed,
                                       engine="sparse", merge_algo=algo, device="cpu")
    if one_call:
        out["one_call_s"] = time.perf_counter() - t0
        out["one_call_sha256"] = _sha(np.asarray(one.ids), np.asarray(one.scores))
        if out["one_call_sha256"] != out["sha256"]["final"]:
            raise AssertionError(f"{mode}: the staged final is not the one-call result")
    os.makedirs(OUT_DIR, exist_ok=True)
    np.savez(_stage_path(mode, cfg["tag"], seed), figures=json.dumps(out), **arrays)
    return out


def _row_keys(ids: np.ndarray) -> tuple:
    """Live entries as int64 keys ``row * 2**32 + id`` (one per id and row)."""
    rows = np.broadcast_to(np.arange(ids.shape[0], dtype=np.int64)[:, None], ids.shape)
    live = ids >= 0
    return (rows[live] << 32) + ids[live].astype(np.int64), live


def _parted_rows(a_ids, a_sc, b_ids, b_sc, limit: int | None = None,
                 atol: float = STAGE_ATOL) -> list[int]:
    """Rows of two ``[N, W]`` basket sets that part beyond ties at the cut
    and ``atol`` (``utils/compare.py::topl_max_error``), the first
    ``limit`` of them."""
    from approximated_personalized_pagerank_tpu_torch.utils.compare import (
        ToplMismatch, topl_max_error,
    )

    parted = []
    for r in np.nonzero(~((a_ids == b_ids).all(axis=1) & (a_sc == b_sc).all(axis=1)))[0]:
        try:
            topl_max_error(a_ids[r : r + 1], a_sc[r : r + 1], b_ids[r : r + 1],
                           b_sc[r : r + 1], atol)
        except ToplMismatch:
            parted.append(int(r))
            if limit is not None and len(parted) >= limit:
                break
    return parted


def stage_pair(a_ids, a_sc, b_ids, b_sc, hub, atol: float = STAGE_ATOL) -> dict:
    """How far two ``[N, W]`` basket sets of one stage part, row by row;
    ``hub`` marks the rows that take the hub path (or is None)."""
    n = a_ids.shape[0]
    identical = (a_ids == b_ids).all(axis=1) & (
        a_sc.view(np.int32) == b_sc.view(np.int32)).all(axis=1)
    ka, la = _row_keys(a_ids)
    kb, lb = _row_keys(b_ids)
    _, ia, ib = np.intersect1d(ka, kb, assume_unique=True, return_indices=True)
    shared = np.bincount(ka[ia] >> 32, minlength=n)
    share = shared / np.maximum(la.sum(axis=1), 1)
    diff = np.abs(a_sc[la][ia] - b_sc[lb][ib])
    parted = _parted_rows(a_ids, a_sc, b_ids, b_sc, atol=atol)
    return {"rows": int(n), "identical_rows": int(identical.sum()),
            "rows_beyond_ties_and_sum_order": len(parted), "first_parted_rows": parted[:5],
            "hub_rows_of_those": None if hub is None else int(hub[parted].sum()),
            "mean_shared_id_share": float(share.mean()), "min_shared_id_share": float(share.min()),
            "max_abs_score_diff_shared_ids": float(diff.max(initial=0.0))}


def _stage_quality(runs: dict, cfg: dict) -> dict:
    """Quality of every (run, stage) cut to K, from one oracle pass of the
    port's harness on the CPU."""
    from approximated_personalized_pagerank_tpu_torch import benchmark_sampled, sample_result
    from approximated_personalized_pagerank_tpu_torch.ops.basket import keep_top
    from approximated_personalized_pagerank_tpu_torch.utils.convert import baskets_from_numpy

    graph = _load_graph(cfg, False)
    keys, samples = [], []
    for mode, r in runs.items():
        for stage in STAGES + tuple(s + "_shared" for s in STAGES[1:]):
            if f"{stage}_ids" not in r:
                continue
            b = baskets_from_numpy(r[f"{stage}_ids"], r[f"{stage}_scores"], "cpu")
            b = keep_top(b.ids, b.scores, cfg["K"])
            keys.append((mode, stage))
            samples.append(sample_result(b, graph, cfg["test_nodes"], True, seed=0))
    stats = benchmark_sampled(samples, graph, device="cpu")
    out = {}
    for (mode, stage), s in zip(keys, stats):
        out.setdefault(mode, {})[stage] = {
            "jaccard": s["jaccard average"], "recall": s["recall average"],
            "kendall": s["kendall average"]}
    return out


def compare_stages(cfg: dict, seed: int) -> dict:
    from approximated_personalized_pagerank_tpu_torch.ops.merge_kernel import MAX_KERNEL_WIDTH

    runs = {m: np.load(_stage_path(m, cfg["tag"], seed)) for m in MODES
            if os.path.exists(_stage_path(m, cfg["tag"], seed))}
    out = {"tag": cfg["tag"], "seed": seed,
           "runs": {m: json.loads(str(r["figures"])) for m, r in runs.items()}}
    kernel_ref = "jax-pallas" if "jax-pallas" in runs else "jax-bitonic"
    # the kernel pipeline's hub rows (the sort pipeline merges every row flat)
    hub = _load_graph(cfg, False).out_degree > (MAX_KERNEL_WIDTH - 1) // cfg["L"]
    for a, b in (("port", "jax-sort"), ("port-kernel", kernel_ref)):
        if a not in runs or b not in runs:
            continue
        pair = {}
        h = hub if a == "port-kernel" else None
        for stage in STAGES:
            bi, bs = runs[b][f"{stage}_ids"], runs[b][f"{stage}_scores"]
            pair[stage] = stage_pair(runs[a][f"{stage}_ids"], runs[a][f"{stage}_scores"],
                                     bi, bs, h)
            if f"{stage}_shared_ids" in runs[a] and out["runs"][a]["from"] == b:
                pair[stage + "_shared"] = stage_pair(
                    runs[a][f"{stage}_shared_ids"], runs[a][f"{stage}_shared_scores"], bi, bs, h)
        out[f"{a}_vs_{b}"] = pair
    out["quality"] = _stage_quality(runs, cfg)
    return out


def auto_eat(seed: int) -> dict:
    """Eat MC at bench.py's config in one call of the JAX package through
    ``engine="auto"`` (the dense engine at 23,132 nodes) on the CPU, with
    bfloat16 product inputs as on the TPU; quality from the port's
    harness, as ``compare`` scores."""
    os.environ.pop("PPR_MERGE_ALGO", None)
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from approximated_personalized_pagerank_tpu import mccompletepathv2_baskets
    from approximated_personalized_pagerank_tpu_torch import benchmark_sampled, sample_result
    from approximated_personalized_pagerank_tpu_torch.utils.convert import baskets_from_numpy

    cfg = _config(True, 0)
    t0 = time.perf_counter()
    out = mccompletepathv2_baskets(_load_graph(cfg, True), cfg["K"], cfg["L"], cfg["R"],
                                   DAMPING, seed=seed, matmul_dtype=jnp.bfloat16)
    ids, scores = np.asarray(out.ids), np.asarray(out.scores)
    mc_s = time.perf_counter() - t0
    graph = _load_graph(cfg, False)
    b = baskets_from_numpy(ids, scores, "cpu")
    stats = benchmark_sampled([sample_result(b, graph, cfg["test_nodes"], True, seed=0)],
                              graph, device="cpu")[0]
    return {"seed": seed, "mc_s": mc_s, "sha256": _sha(ids, scores),
            "jaccard": stats["jaccard average"], "recall": stats["recall average"],
            "kendall": stats["kendall average"]}


def hub_groups(cfg: dict, seed: int, stage: str, rows: list[int] | None, limit: int = 5) -> dict:
    """Why a hub row parts between ``port-kernel`` and ``jax-pallas`` in a
    combine pass run from one input (the JAX run's input to ``stage``):
    each of the row's hub groups merged to its top M in both packages (the
    TPU kernel in interpret mode; the gather entry's plain version), the
    ids that only one side keeps, their float32 totals, and how many ids
    sit at the group's M-th total in exact (float64) sums.  ``rows``
    defaults to the first ``limit`` rows that part beyond ties and the
    order of sums in the saved runs."""
    _jax_setup("jax-pallas")
    import jax.numpy as jnp
    import torch

    from approximated_personalized_pagerank_tpu.ops import merge as jm
    from approximated_personalized_pagerank_tpu_torch.ops import merge as tm
    from approximated_personalized_pagerank_tpu_torch.utils.convert import baskets_from_numpy

    J = np.load(_stage_path("jax-pallas", cfg["tag"], seed))
    before = {"pass1": "walk", "pass2": "pass1"}[stage]
    in_ids, in_sc = J[f"{before}_ids"], J[f"{before}_scores"]
    if rows is None:
        P = np.load(_stage_path("port-kernel", cfg["tag"], seed))
        rows = _parted_rows(P[f"{stage}_shared_ids"], P[f"{stage}_shared_scores"],
                            J[f"{stage}_ids"], J[f"{stage}_scores"], limit)
    graph = _load_graph(cfg, False)
    L = cfg["L"]
    sub = (tm.MAX_KERNEL_WIDTH - 1) // L
    m = min(tm.HUB_TOP_M_FACTOR * L, sub * L)
    where = {}
    for b in graph.merge_plan(None, L=L, net_width=tm.MAX_KERNEL_WIDTH).buckets:
        for i, r in enumerate(b.rows.tolist()):
            where[r] = b.succ[i]
    state = baskets_from_numpy(in_ids, in_sc, "cpu")
    out = {"stage": stage, "rows": []}
    for r in rows:
        succ = where[r]
        g = -(-succ.size // sub)
        groups = np.full(g * sub, -1, np.int64)
        groups[: succ.size] = succ
        groups = groups.reshape(g, sub)
        valid = groups >= 0
        cand_ids = in_ids[np.where(valid, groups, 0)]
        live = valid[..., None] & (cand_ids >= 0)
        cand_ids = np.where(live, cand_ids, -1).reshape(g, -1)
        cand_sc = np.where(live, in_sc[np.where(valid, groups, 0)], 0).reshape(g, -1)
        j = jm._merge_rows(jnp.asarray(cand_ids), jnp.asarray(cand_sc.astype(np.float32)), m,
                           "pallas")
        t = tm.gather_merge_topl(state.ids, state.scores, torch.as_tensor(groups), None,
                                 torch.ones(g), None, None, m, tm._l_pad(m))
        # every id's float32 total on each side: the same merges, uncut
        w = tm.next_pow2(cand_ids.shape[1])
        j_all = jm._merge_rows(jnp.asarray(cand_ids), jnp.asarray(cand_sc.astype(np.float32)),
                               w, "pallas")
        t_all = tm.gather_merge_topl(state.ids, state.scores, torch.as_tensor(groups), None,
                                     torch.ones(g), None, None, w, w)
        row = {"row": int(r), "out_degree": int(graph.out_degree[r]), "groups": []}
        for k in range(g):
            jk = dict(zip(np.asarray(j.ids[k]).tolist(), np.asarray(j.scores[k]).tolist()))
            tk = dict(zip(t.ids[k].tolist(), t.scores[k].tolist()))
            j_tot = dict(zip(np.asarray(j_all.ids[k]).tolist(),
                             np.asarray(j_all.scores[k]).tolist()))
            t_tot = dict(zip(t_all.ids[k].tolist(), t_all.scores[k].tolist()))
            apart = sorted(i for i in set(jk) ^ set(tk) if i >= 0)
            exact: dict = {}
            for i, sc in zip(cand_ids[k].tolist(), cand_sc[k].astype(np.float64).tolist()):
                if i >= 0:
                    exact[i] = exact.get(i, 0.0) + sc
            vals = np.sort(np.fromiter(exact.values(), float))[::-1]
            cut = vals[m - 1] if vals.size >= m else 0.0
            row["groups"].append({
                "cut_jax": float(np.asarray(j.scores[k])[m - 1]),
                "cut_port": float(t.scores[k, m - 1]),
                "only_jax": [i for i in apart if i in jk],
                "only_port": [i for i in apart if i in tk],
                "their_totals_jax_port": {i: (j_tot[i], t_tot[i]) for i in apart},
                "ids_within_1e-6_of_the_exact_cut": int((np.abs(vals - cut) <= 1e-6 * cut).sum()),
                "of_those_with_other_float32_totals": sum(
                    j_tot[i] != t_tot[i] for i, v in exact.items() if abs(v - cut) <= 1e-6 * cut),
            })
        out["rows"].append(row)
    return out


# -------------------------------------------------------------------- card
def _held_rows(a, b) -> tuple:
    """Row by row, ``utils/compare.py::topl_max_error`` between two merge
    results at ``STAGE_ATOL`` times the row's largest score (at least 1):
    the largest error of the rows that hold, and the rows that do not."""
    from approximated_personalized_pagerank_tpu_torch.utils.compare import (
        ToplMismatch, topl_max_error,
    )

    a_ids, a_sc, b_ids, b_sc = (t.cpu().numpy() for t in (a.ids, a.scores, b.ids, b.scores))
    err, beyond = 0.0, []
    for r in range(a_ids.shape[0]):
        tol = STAGE_ATOL * max(1.0, float(np.abs(a_sc[r]).max(initial=0.0)))
        try:
            err = max(err, topl_max_error(a_ids[r : r + 1], a_sc[r : r + 1],
                                          b_ids[r : r + 1], b_sc[r : r + 1], tol))
        except ToplMismatch:
            beyond.append(r)
    return err, beyond


def _kernel_vs_plain_rows(state, after, plan, sources, hub_sub: int, L: int) -> dict:
    """The combine's merges of the ``sources``' rows from ``state`` (one
    pass's input on the card), through the kernel and through its plain
    version (the same call on a CPU copy), hub groups apart
    (:func:`_held_rows`).  The kernel's rows must also be the pass's own
    output rows ``after``, bit for bit.  A hub row whose groups kept other
    ids at a near tie of a group's top-M cut may part by the dropped share
    (ROADMAP, the inherent differences); such rows are counted apart."""
    import torch

    from approximated_personalized_pagerank_tpu_torch.ops import merge as tm

    dev = state.ids.device
    host = tm.Baskets(state.ids.cpu(), state.scores.cpu())
    damping = torch.tensor(DAMPING, dtype=torch.float32)
    out = {"rows": 0, "rows_beyond": 0, "max_err_rows": 0.0, "hub_rows": 0,
           "hub_rows_beyond": 0, "hub_rows_beyond_with_a_group_cut_apart": 0,
           "max_diff_hub_rows_beyond": 0.0, "hub_groups": 0, "groups_beyond": 0,
           "groups_with_other_ids": 0, "max_err_groups": 0.0, "rows_equal_the_pass": True}
    src = set(int(s) for s in sources)
    for b in plan.buckets:
        sel = np.array([i for i, r in enumerate(b.rows) if int(r) in src], dtype=np.int64)
        if sel.size == 0:
            continue
        rows = torch.as_tensor(b.rows[sel], dtype=torch.int64)
        succ = torch.as_tensor(b.succ[sel], dtype=torch.int64)
        runs = [tm.merge_bucket(s, rows.to(d), succ.to(d), damping.to(d), L, "kernel",
                                mode="mc_combine", hub_sub=hub_sub)[0]
                for s, d in ((state, dev), (host, "cpu"))]
        err, beyond = _held_rows(runs[0], runs[1])
        out["max_err_rows"] = max(out["max_err_rows"], err)
        mine = rows.to(dev)
        out["rows_equal_the_pass"] &= bool(
            torch.equal(runs[0].ids, after.ids[mine])
            and torch.equal(runs[0].scores.view(torch.int32), after.scores[mine].view(torch.int32)))
        out["rows"] += sel.size
        if succ.shape[1] <= hub_sub:
            out["rows_beyond"] += len(beyond)
            continue
        # the hub path's first level: groups of hub_sub successors, top-M each
        g = -(-succ.shape[1] // hub_sub)
        groups = torch.nn.functional.pad(succ, (0, g * hub_sub - succ.shape[1]), value=-1)
        groups = groups.reshape(-1, hub_sub)
        m = min(tm.HUB_TOP_M_FACTOR * L, hub_sub * state.ids.shape[1])
        ones = torch.ones(groups.shape[0])
        parts = [tm.gather_merge_topl(s.ids, s.scores, groups.to(d), None, ones.to(d),
                                      None, None, m, tm._l_pad(m))
                 for s, d in ((state, dev), (host, "cpu"))]
        g_err, g_beyond = _held_rows(parts[0], parts[1])
        k_ids, p_ids = (np.sort(p.ids.cpu().numpy(), axis=1) for p in parts)
        other = (k_ids != p_ids).any(axis=1).reshape(sel.size, g)
        for r in beyond:
            diff = np.abs(runs[0].scores[r].cpu().numpy() - runs[1].scores[r].numpy()).max()
            out["max_diff_hub_rows_beyond"] = max(out["max_diff_hub_rows_beyond"], float(diff))
            out["hub_rows_beyond_with_a_group_cut_apart"] += int(other[r].any())
        out.update(hub_rows=out["hub_rows"] + sel.size,
                   hub_rows_beyond=out["hub_rows_beyond"] + len(beyond),
                   hub_groups=out["hub_groups"] + groups.shape[0],
                   groups_beyond=out["groups_beyond"] + len(g_beyond),
                   groups_with_other_ids=out["groups_with_other_ids"] + int(other.sum()),
                   max_err_groups=max(out["max_err_groups"], g_err))
    return out


def card(nodes: int, seeds: list[int], pipelines: tuple = ("kernel", "sort"),
         hubs: int = 32) -> dict:
    """The port alone on the card: MC at each seed through each pipeline,
    scored from one oracle pass, and the kernel against its plain version
    on real combine rows (the first seed's kernel run, both passes): the
    sampled sources' rows, and the ``hubs`` rows of largest out-degree,
    which take the hub path (groups, tree reduction, final merge)."""
    import torch

    from approximated_personalized_pagerank_tpu_torch import (
        benchmark_sampled, mccompletepathv2_baskets, sample_result,
    )
    from approximated_personalized_pagerank_tpu_torch.ops.merge_kernel import MAX_KERNEL_WIDTH
    from approximated_personalized_pagerank_tpu_torch.utils.compare import basket_sha256
    from approximated_personalized_pagerank_tpu_torch.utils.device import card_line, synchronize

    if not torch.cuda.is_available():
        raise SystemExit("card: no CUDA device")
    dev = torch.device("cuda")
    cfg = _config(False, nodes)
    out = {"nvidia_smi": card_line(), "device": torch.cuda.get_device_name(0), "nodes": nodes,
           "runs": []}
    t0 = time.perf_counter()
    graph = _load_graph(cfg, False)
    out["build_s"] = time.perf_counter() - t0
    samples, states = [], {}
    for seed in seeds:
        for algo in pipelines:
            t0 = time.perf_counter()
            if (seed, algo) == (seeds[0], "kernel"):
                # staged, keeping every pass's input and output for the rows below
                for stage, mc, _ in port_stages(graph, cfg, seed, algo, dev):
                    states[stage] = mc
            else:
                mc = mccompletepathv2_baskets(graph, cfg["K"], cfg["L"], cfg["R"], DAMPING,
                                              seed=seed, engine="sparse", merge_algo=algo,
                                              device=dev)
            synchronize(dev)
            run = {"seed": seed, "merge_algo": algo, "mc_s": time.perf_counter() - t0,
                   "sha256": basket_sha256(mc)}
            out["runs"].append(run)
            samples.append(sample_result(mc, graph, cfg["test_nodes"], True, seed=0))
            print(json.dumps(run), flush=True)
            del mc
    states.pop("final")
    t0 = time.perf_counter()
    for run, s in zip(out["runs"], benchmark_sampled(samples, graph, device=dev)):
        run.update(jaccard=s["jaccard average"], recall=s["recall average"],
                   kendall=s["kendall average"])
    out["eval_s"] = time.perf_counter() - t0
    plan = graph.merge_plan(None, L=cfg["L"], net_width=MAX_KERNEL_WIDTH)
    hub_sub = max((MAX_KERNEL_WIDTH - 1) // cfg["L"], 1)
    row_sets = {"sources": samples[0].sources,
                "hubs": np.argsort(-graph.out_degree, kind="stable")[:hubs]}
    out["kernel_vs_plain"] = {
        name: {p: _kernel_vs_plain_rows(states[before], states[p], plan, rows, hub_sub,
                                        cfg["L"])
               for before, p in (("walk", "pass1"), ("pass1", "pass2"))}
        for name, rows in row_sets.items()}
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
    global OUT_DIR
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("what", choices=("stages", "compare", "groups", "walks", "auto", "card"))
    ap.add_argument("mode", nargs="?", choices=MODES)
    ap.add_argument("--nodes", type=int, default=200_000)
    ap.add_argument("--eat", action="store_true", help="the Eat graph at bench.py's MC config")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--from", dest="source", choices=MODES,
                    help="stages: also run each stage from this run's input to it")
    ap.add_argument("--no-one-call", action="store_true",
                    help="stages: skip the one-call check (JAX Pallas at 200,000 nodes, "
                         "which cannot run in one call here; the port at 1M, to save an hour)")
    ap.add_argument("--stage", choices=("pass1", "pass2"), default="pass1",
                    help="groups: the combine pass to open up")
    ap.add_argument("--rows", default=None, help="groups: rows (default: the first that part)")
    ap.add_argument("--seeds", default="1,2,3,4", help="card: MC seeds")
    ap.add_argument("--pipelines", default="kernel,sort", help="card: merge pipelines")
    ap.add_argument("--out", default=OUT_DIR, help="where runs are saved and read")
    a = ap.parse_args()
    OUT_DIR = a.out
    cfg = _config(a.eat, a.nodes)
    if a.what == "stages":
        if a.mode not in MODES:
            ap.error(f"stages needs a mode of {MODES}")
        if a.source is not None and not a.mode.startswith("port"):
            ap.error("--from is for port modes")
        out = stages(a.mode, cfg, a.seed, a.source, not a.no_one_call)
    elif a.what == "compare":
        out = compare_stages(cfg, a.seed)
    elif a.what == "groups":
        rows = [int(r) for r in a.rows.split(",")] if a.rows else None
        out = hub_groups(cfg, a.seed, a.stage, rows)
    elif a.what == "walks":
        out = walks(a.nodes)
    elif a.what == "auto":
        out = auto_eat(a.seed)
    else:
        out = card(a.nodes, [int(s) for s in a.seeds.split(",")], tuple(a.pipelines.split(",")))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
