"""Command-line entry point of the PyTorch/CUDA port.

The reference ships a hardcoded example binary (src/main.cc); this CLI is
its parameterized equivalent, with the JAX package's flags plus
``--device``:

    ppr-torch --graph edges.csv --algorithm grank --K 50 --L 100 \\
        --iterations 30 --damping 0.85 --tolerance 1e-4 \\
        --test-nodes 200 --save baskets.npz            # on the card
    python -m approximated_personalized_pagerank_tpu_torch.cli --device cpu

Prints the run time and the benchmark statistics like the reference's
example program (src/main.cc:39-44).  ``--algorithm grank_multi`` runs the
ring-sharded GRank over ``--n-shards`` shards, and ``mccompletepathv2``
with ``--n-shards > 1`` the sharded MC: over the first cards, or as that
many shards on the CPU with ``--device cpu``.  Plain ``grank`` ignores
``--n-shards``, as the JAX package's CLI does.
"""

from __future__ import annotations

import argparse
import time

from .config import RunConfig


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="ppr-torch",
        description="All-sources personalized PageRank on PyTorch/CUDA",
    )
    p.add_argument(
        "--graph",
        default=None,
        help="CSV edge list (node1,node2); defaults to the bundled sample graph",
    )
    p.add_argument(
        "--algorithm",
        default="grank",
        choices=["grank", "grank_multi", "mccompletepathv2"],
    )
    p.add_argument("--K", type=int, default=50)
    p.add_argument("--L", type=int, default=100)
    p.add_argument("--iterations", type=int, default=30)
    p.add_argument("--damping", type=float, default=0.85)
    p.add_argument("--tolerance", type=float, default=1e-4)
    p.add_argument("--n-shards", type=int, default=1)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--combine-passes", type=int, default=2)
    p.add_argument(
        "--engine", default="auto", choices=["auto", "dense", "sparse"],
        help="dense = matrix-product engine (graphs whose [N, N] matrix fits "
        "the device); sparse = degree-bucketed engine (any size); auto = "
        "dense up to 16,384 nodes (GRank) or 32,768 (MC)",
    )
    p.add_argument(
        "--merge-algo", default=None,
        help="sparse-engine merge pipeline: sort | kernel[:cap] "
        "(default: kernel on the card, sort on the CPU)",
    )
    p.add_argument(
        "--device", default=None,
        help="cuda (the default; fails without a card) or cpu",
    )
    p.add_argument("--test-nodes", type=int, default=200)
    p.add_argument("--no-strict", action="store_true")
    p.add_argument("--no-eval", action="store_true")
    p.add_argument("--save", default=None, help="save baskets to .npz")
    p.add_argument(
        "--profile", default=None, metavar="DIR",
        help="write a torch.profiler Chrome trace of the run to DIR "
        "(view with ui.perfetto.dev)",
    )
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    cfg = RunConfig(
        algorithm=args.algorithm,
        K=args.K,
        L=args.L,
        iterations=args.iterations,
        damping=args.damping,
        tolerance=args.tolerance,
        n_shards=args.n_shards,
        seed=args.seed,
        combine_passes=args.combine_passes,
        engine=args.engine,
        merge_algo=args.merge_algo,
        device=args.device,
        test_nodes=args.test_nodes,
        strict=not args.no_strict,
    )
    cfg.validate()

    import torch

    from . import (
        benchmark_algorithm,
        grank_baskets,
        grank_multi_baskets,
        load_csv_graph,
        mccompletepathv2_baskets,
        mccompletepathv2_multi_baskets,
        sample_graph_path,
    )
    from .utils.checkpoint import save_baskets
    from .utils.device import resolve_device
    from .utils.profiling import trace

    dev = resolve_device(cfg.device)
    graph_path = args.graph
    if graph_path is None:
        graph_path = sample_graph_path()
        print(f"no --graph given; using bundled sample {graph_path}")
    graph = load_csv_graph(graph_path)
    print(f"nodes: {graph.num_nodes} edges: {graph.num_edges}")

    with trace(args.profile):
        t0 = time.perf_counter()
        if cfg.algorithm == "grank":
            baskets = grank_baskets(
                graph, cfg.K, cfg.L, cfg.iterations, cfg.damping, cfg.tolerance,
                engine=cfg.engine, merge_algo=cfg.merge_algo, device=dev,
            )
        elif cfg.algorithm == "grank_multi":
            baskets = grank_multi_baskets(
                graph, cfg.K, cfg.L, cfg.iterations, cfg.damping, cfg.tolerance,
                cfg.n_shards, merge_algo=cfg.merge_algo, device=dev,
            )
        elif cfg.n_shards > 1:
            baskets = mccompletepathv2_multi_baskets(
                graph, cfg.K, cfg.L, cfg.iterations, cfg.damping, cfg.n_shards,
                seed=cfg.seed, combine_passes=cfg.combine_passes,
                merge_algo=cfg.merge_algo, device=dev,
            )
        else:
            baskets = mccompletepathv2_baskets(
                graph, cfg.K, cfg.L, cfg.iterations, cfg.damping, seed=cfg.seed,
                combine_passes=cfg.combine_passes, engine=cfg.engine,
                merge_algo=cfg.merge_algo, device=dev,
            )
        if dev.type == "cuda":
            torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
    print(f"{cfg.algorithm} run-time = {elapsed * 1000:.0f} ms")
    if args.profile:
        print(f"profiler trace written to {args.profile}")

    if not args.no_eval:
        stats = benchmark_algorithm(
            baskets, graph, cfg.test_nodes, cfg.strict, seed=cfg.seed, device=dev
        )
        print("-------")
        for k, v in stats.items():
            print(f"{k}     {v:.6g}")
        print("-------")

    if args.save:
        save_baskets(args.save, baskets, graph)
        print(f"saved baskets to {args.save}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
