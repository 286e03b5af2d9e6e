"""All-sources approximated personalized PageRank in PyTorch and CUDA.

The port of ``approximated_personalized_pagerank_tpu`` (JAX) to one NVIDIA
H100: sparse GRank, sparse MCCompletePathV2 (threefry walks bit for bit
the JAX package's), the exact PPR oracle and the quality harness, with the
fused basket merge as a hand-written CUDA kernel (ops/merge_kernel.py).
Entry points run on the card unless the caller passes ``device="cpu"``.
"""

import os as _os

from .graph import Graph, load_csv_graph


def eat_graph_path() -> str:
    """Path of the Eat (Edinburgh Associative Thesaurus) edge list the
    repository bundles with the JAX package (23,132 nodes / 312,310 deduped
    edges, gzipped); the reference's canonical benchmark graph."""
    repo = _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))
    return _os.path.join(
        repo, "approximated_personalized_pagerank_tpu", "data", "eat.csv.gz"
    )


def load_eat_graph() -> Graph:
    """The bundled Eat graph as a :class:`Graph` (see eat_graph_path)."""
    return load_csv_graph(eat_graph_path())


from .models.benchmark import benchmark_algorithm, benchmark_sampled, sample_result
from .models.common import baskets_to_dict
from .models.grank import grank, grank_baskets
from .models.mccompletepathv2 import mccompletepathv2, mccompletepathv2_baskets
from .models.ppr_single_source import ppr_single_source, ppr_single_source_batch
from .ops.basket import Baskets
from .ops.merge_kernel import fused_merge_topl
from .ops.walk import walk_baskets

__all__ = [
    "Graph",
    "load_csv_graph",
    "eat_graph_path",
    "load_eat_graph",
    "grank",
    "grank_baskets",
    "mccompletepathv2",
    "mccompletepathv2_baskets",
    "walk_baskets",
    "ppr_single_source",
    "ppr_single_source_batch",
    "benchmark_algorithm",
    "benchmark_sampled",
    "sample_result",
    "baskets_to_dict",
    "Baskets",
    "fused_merge_topl",
]
