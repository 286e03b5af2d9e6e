"""The program's own spans (``approximated_personalized_pagerank_tpu_torch
.utils.profiling``), which it records while the profiler runs: the traced
window's jobs.  Shared by the readers of the ``program_span`` and
``program_counter`` metrics, which read None where the program records no
such span (a program without the recorder among them)."""

from __future__ import annotations


def named(name: str) -> list:
    """The recorded spans ``name``; empty where the program has no recorder."""
    try:
        from approximated_personalized_pagerank_tpu_torch.utils import profiling
    except ImportError:
        return []
    recorded = getattr(profiling, "recorded", None)
    return [s for s in recorded() if s.name == name] if recorded is not None else []


def ms(spans) -> float:
    """The spans' summed length in milliseconds."""
    return sum(s.end_ns - s.start_ns for s in spans) / 1e6


def per(total: float, parts: list, unit: str):
    """``total`` (read from ``parts``) over the number of spans ``unit``, or
    None where either is missing."""
    n = len(named(unit))
    return total / n if parts and n else None
