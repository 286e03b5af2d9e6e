"""Run configuration.

The reference has no config system: five to seven positional parameters
documented in its docstrings (include/grank.h:32-40) and README (L > K,
damping 0.85, tolerance 1e-4..1e-2, iterations 10-40).  This dataclass
carries the same parameters, with the JAX package's names and its
"negative tolerance = never stop early" convention, for the CLI and
programmatic runners.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class RunConfig:
    algorithm: str = "grank"  # grank | grank_multi | mccompletepathv2
    K: int = 50
    L: int = 100
    iterations: int = 30  # GRank: max half-sweeps; MCv2: walks per node (R)
    damping: float = 0.85
    tolerance: float = 1e-4  # negative => never stop early (grank only)
    n_shards: int = 1  # grank_multi parallelism degree
    seed: Optional[int] = None  # MCv2 PRNG seed (None = entropy)
    combine_passes: int = 2  # MCv2 propagation passes
    engine: str = "auto"  # auto | dense (matrix products) | sparse (bucketed)
    merge_algo: Optional[str] = None  # sparse merge: sort | kernel[:cap]
    device: Optional[str] = None  # cuda (None) | cpu
    # evaluation
    test_nodes: int = 200
    strict: bool = True

    def validate(self) -> None:
        from .ops.merge import resolve_merge_algo
        from .utils.validation import (
            check_basket_params,
            check_damping,
            check_iterations,
            check_shards,
        )

        if self.algorithm not in ("grank", "grank_multi", "mccompletepathv2"):
            raise ValueError(f"unknown algorithm {self.algorithm!r}")
        check_basket_params(self.K, self.L)
        check_iterations(self.iterations)
        check_damping(self.damping)
        if self.algorithm == "grank_multi" or self.n_shards != 1:
            check_shards(self.n_shards)
        if self.engine not in ("auto", "dense", "sparse"):
            raise ValueError(f"unknown engine {self.engine!r}")
        if self.merge_algo is not None:
            resolve_merge_algo(self.merge_algo, None)
