"""Profiling hook: ``trace()`` wraps a region in ``torch.profiler`` and
writes a Chrome trace (viewable in ui.perfetto.dev or chrome://tracing).

Enabled by the CLI's ``--profile DIR`` flag or ``PPR_PROFILE_DIR``.
Throughput counters are built into the runners (``return_info=True``:
half-sweeps run, the dense engine's FLOPs, walk visits); the profiler
gives the device time by kernel (see also profile_port.py).
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

__all__ = ["trace"]


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """Profile the region into ``log_dir/ppr_trace_<ms>.json`` (host
    operators, and the card's kernels when one is present).  A no-op when
    no directory is given and ``PPR_PROFILE_DIR`` is unset."""
    if log_dir is None:
        log_dir = os.environ.get("PPR_PROFILE_DIR")
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(
        os.path.join(log_dir, f"ppr_trace_{int(time.time() * 1000)}.json")
    )
