"""Recall/quality harness comparing approximate baskets to exact PPR.

Reference: ``ppr::benchmarkAlgorithm`` (include/benchmarkAlgorithm.h:51-153).
Semantics preserved:

* sample ``test_nodes`` random sources from the result's keys (``strict``
  skips out-degree-0 sources, benchmarkAlgorithm.h:71-77);
* exact oracle fixed at 100 iterations, damping 0.85, tolerance 1e-4
  (benchmarkAlgorithm.h:32,91);
* the exact basket is truncated **to the approximate basket's size** (not K)
  before the Jaccard comparison (benchmarkAlgorithm.h:95);
* Kendall tau-b compares the approximate scores against the *untruncated*
  exact scores at the approximate basket's ids (benchmarkAlgorithm.h:116-126);
* all stats are -1 when nothing was sampled (benchmarkAlgorithm.h:144-151).

Sources are evaluated in batches against the batched oracle.  An extra
``recall average`` stat (top-K hit rate vs the exact top-K) is reported
beyond the reference's five.  Sampling is numpy ``default_rng(seed)``, the
JAX package's, so both packages pick the same sources.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Sequence

import numpy as np
import torch

from ..graph import Graph
from ..ops.basket import Baskets, jaccard_rows
from ..ops.kendall import kendall_tau_b
from ..utils.validation import check_test_nodes
from .ppr_single_source import ppr_single_source_batch

STAT_KEYS = (
    "jaccard average",
    "jaccard min",
    "kendall average",
    "kendall min",
    "average map size",
)


@dataclasses.dataclass
class SampledResult:
    """The sampled rows of one algorithm's result, on the host.

    Two results sampled with the same (graph, test_nodes, strict, seed)
    select the same sources, so :func:`benchmark_sampled` can evaluate both
    against one exact-oracle pass.
    """

    sources: np.ndarray  # int64[M] internal source ids
    ids: np.ndarray  # int32[M, W] basket ids, -1 padded
    scores: np.ndarray  # float32[M, W]


def _result_to_rows(result, graph: Graph):
    """Normalise a map-of-maps result to (source ids [M], ids [M, W],
    scores [M, W])."""
    if isinstance(result, Mapping):
        sources = []
        for k in result:
            if k not in graph:
                raise ValueError(
                    f"node {k} in the provided map is not part of the provided graph"
                )
            sources.append(graph.key_to_id(k))
        width = max((len(b) for b in result.values()), default=1)
        width = max(width, 1)
        ids = np.full((len(sources), width), -1, dtype=np.int32)
        scores = np.zeros((len(sources), width), dtype=np.float32)
        for r, (k, basket) in enumerate(result.items()):
            for c, (node, score) in enumerate(basket.items()):
                ids[r, c] = graph.key_to_id(node)
                scores[r, c] = score
        return np.asarray(sources, dtype=np.int64), ids, scores
    raise TypeError(f"unsupported result type {type(result)!r}")


def sample_result(
    result,
    graph: Graph,
    test_nodes: int,
    strict: bool,
    *,
    seed: int | None = None,
) -> SampledResult:
    """Sample ``test_nodes`` sources from a result and gather their rows.

    Sampling mirrors the reference (shuffle candidates, ``strict`` skips
    out-degree-0 sources, benchmarkAlgorithm.h:60-79).  For ``Baskets``
    results only the sampled rows leave the device.
    """
    check_test_nodes(test_nodes)
    if isinstance(result, Baskets):
        n = graph.num_nodes
        if result.ids.shape[0] != n:
            raise ValueError("basket result must cover every graph node")
        sources = np.arange(n, dtype=np.int64)
        ids_all = scores_all = None
    else:
        sources, ids_all, scores_all = _result_to_rows(result, graph)

    if strict:
        keep = np.nonzero(graph.out_degree[sources] > 0)[0]
    else:
        keep = np.arange(sources.size)
    rng = np.random.default_rng(seed)
    rng.shuffle(keep)
    keep = keep[: min(test_nodes, keep.size)]

    if keep.size == 0:
        return SampledResult(
            sources=np.empty(0, np.int64),
            ids=np.empty((0, 1), np.int32),
            scores=np.empty((0, 1), np.float32),
        )
    if ids_all is None:
        keep_d = torch.as_tensor(keep, dtype=torch.int64).to(result.ids.device)
        sel_ids = result.ids[keep_d].cpu().numpy()
        sel_scores = result.scores[keep_d].cpu().numpy()
    else:
        sel_ids = ids_all[keep]
        sel_scores = scores_all[keep]
    return SampledResult(sources=sources[keep], ids=sel_ids, scores=sel_scores)


def benchmark_sampled(
    samples: Sequence[SampledResult],
    graph: Graph,
    *,
    oracle_iterations: int = 100,
    oracle_damping: float = 0.85,
    oracle_tolerance: float = 1e-4,
    batch_size: int | None = None,
    device=None,
    mesh=None,
) -> list:
    """Stats for several sampled results sharing one exact-oracle pass.

    All samples must hold the same source list (same sampling arguments).
    Returns one stats dict per sample.  The oracle runs on ``device``
    (``None`` means ``"cuda"``), or split across ``mesh``'s shards, each
    taking a batch of the auto size.
    """
    if batch_size is None:
        # bound the [N, B] oracle state at ~128 MB per buffer (a shard)
        batch_size = int(max(4, min(32, (32 << 20) // max(graph.num_nodes, 1))))
        if mesh is not None:
            batch_size *= mesh.n_shards
    if not samples:
        return []
    sel_sources = samples[0].sources
    for s in samples[1:]:
        if not np.array_equal(s.sources, sel_sources):
            raise ValueError(
                "benchmark_sampled requires identical source samples "
                "(same graph/test_nodes/strict/seed)"
            )
    if sel_sources.size == 0:
        out = {k: -1.0 for k in STAT_KEYS}
        out["recall average"] = -1.0
        return [dict(out) for _ in samples]

    parts = [{"jacc": [], "kend": [], "recall": [], "sizes": []} for _ in samples]
    for s in range(0, sel_sources.size, batch_size):
        b_src = sel_sources[s : s + batch_size]
        nb = b_src.shape[0]
        dense = ppr_single_source_batch(
            graph, b_src, oracle_iterations, oracle_damping, oracle_tolerance,
            device=device, mesh=mesh,
        )  # [nb, N]
        dev = dense.device
        rows = torch.arange(nb, device=dev)
        # A node is "present" in the exact sparse map iff its score is > 0
        # or it is the source (pprSingleSource always inserts the source).
        present = dense > 0
        present[rows, torch.as_tensor(b_src, dtype=torch.int64).to(dev)] = True

        for sample, acc in zip(samples, parts):
            b_ids = torch.as_tensor(sample.ids[s : s + nb]).to(dev)
            b_scores = torch.as_tensor(sample.scores[s : s + nb]).to(dev)
            width = sample.ids.shape[1]
            sizes = (b_ids >= 0).sum(dim=1)
            # Exact basket truncated to the approx basket's size: take the
            # top `width` entries, then keep the first `sizes[r]` of each.
            _, top_ids = torch.topk(dense, min(width, dense.shape[1]), dim=1)
            pos = torch.arange(top_ids.shape[1], device=dev)[None, :]
            top_present = torch.gather(present, 1, top_ids)
            live = (pos < sizes[:, None]) & top_present
            exact_ids = torch.where(
                live, top_ids, torch.full_like(top_ids, -1)
            ).to(torch.int32)
            if exact_ids.shape[1] < width:
                exact_ids = torch.nn.functional.pad(
                    exact_ids, (0, width - exact_ids.shape[1]), value=-1
                )
            acc["jacc"].append(jaccard_rows(b_ids, exact_ids).cpu().numpy())

            # Kendall: approx scores vs untruncated exact values at the
            # approx ids.
            valid = b_ids >= 0
            exact_at_ids = torch.gather(dense, 1, b_ids.clamp(min=0).to(torch.int64))
            acc["kend"].append(
                kendall_tau_b(
                    b_scores,
                    torch.where(valid, exact_at_ids, torch.zeros_like(exact_at_ids)),
                    valid,
                ).cpu().numpy()
            )
            # recall@K extension: fraction of the approx basket's ids in
            # the exact top-(same size), == intersection / size.
            inter = (
                (b_ids[:, :, None] == exact_ids[:, None, :])
                & (b_ids[:, :, None] >= 0)
            ).sum(dim=(1, 2)).cpu().numpy()
            sizes_np = sizes.cpu().numpy()
            acc["recall"].append(
                np.where(sizes_np > 0, inter / np.maximum(sizes_np, 1), 1.0)
            )
            acc["sizes"].append(sizes_np)

    out = []
    for acc in parts:
        jacc = np.concatenate(acc["jacc"])
        kend = np.concatenate(acc["kend"])
        recall = np.concatenate(acc["recall"])
        sizes = np.concatenate(acc["sizes"])
        out.append(
            {
                "jaccard average": float(jacc.mean()),
                "jaccard min": float(jacc.min()),
                "kendall average": float(kend.mean()),
                "kendall min": float(kend.min()),
                "average map size": float(sizes.mean()),
                "recall average": float(recall.mean()),
            }
        )
    return out


def benchmark_algorithm(
    result,
    graph: Graph,
    test_nodes: int,
    strict: bool,
    *,
    seed: int | None = None,
    oracle_iterations: int = 100,
    oracle_damping: float = 0.85,
    oracle_tolerance: float = 1e-4,
    batch_size: int | None = None,
    device=None,
    mesh=None,
) -> Dict[str, float]:
    """Quality stats of an approximate all-sources PPR result.

    ``result`` is either ``Baskets`` from ``grank_baskets`` or the
    reference-shaped dict-of-dicts.  ``seed`` makes sampling reproducible
    (the reference uses an entropy-seeded shuffle,
    benchmarkAlgorithm.h:60-61).  To evaluate several results against one
    oracle pass, see :func:`sample_result` + :func:`benchmark_sampled`;
    ``mesh`` splits each oracle batch across its shards.
    """
    sample = sample_result(result, graph, test_nodes, strict, seed=seed)
    return benchmark_sampled(
        [sample],
        graph,
        oracle_iterations=oracle_iterations,
        oracle_damping=oracle_damping,
        oracle_tolerance=oracle_tolerance,
        batch_size=batch_size,
        device=device,
        mesh=mesh,
    )[0]
