"""Parameter validation shared by all algorithms.

The reference validates parameters and exits with a message
(include/grank.h:51-55, include/mccompletepathv2.h:190-194,
include/internal/pprSingleSource.h:36-38, include/benchmarkAlgorithm.h:55).  This package raises ``ValueError`` with
the same messages instead.
"""

from __future__ import annotations

__all__ = [
    "check_basket_params",
    "check_iterations",
    "check_damping",
    "check_combine_passes",
    "check_successor_choice",
    "check_shards",
    "check_test_nodes",
]


def check_basket_params(K: int, L: int) -> None:
    if K <= 0:
        raise ValueError("K must be positive")
    if L <= 0:
        raise ValueError("L must be positive")
    if K > L:
        raise ValueError("K must be <= L")


def check_iterations(iterations: int) -> None:
    if iterations <= 0:
        raise ValueError("iterations must be positive")


def check_damping(damping: float) -> None:
    if damping < 0 or damping > 1:
        raise ValueError("damping must be [0,1]")


def check_combine_passes(combine_passes: int) -> None:
    if combine_passes < 1:
        raise ValueError("combine_passes must be positive")


def check_successor_choice(successor_choice: str) -> None:
    if successor_choice not in ("uniform", "stratified"):
        raise ValueError(
            f"unknown successor_choice {successor_choice!r} "
            "(expected 'uniform' or 'stratified')"
        )


def check_shards(n_shards: int) -> None:
    # grankMulti's "nThreads must be positive" (header-only/grankMulti.h:299-304)
    if n_shards <= 0:
        raise ValueError("n_shards must be positive")


def check_test_nodes(test_nodes: int) -> None:
    if test_nodes <= 0:
        raise ValueError("testNodes must be positive")
