"""What a traced window holds, read from ``torch.profiler``'s raw events.

The window is the benchmark's own span (``WINDOW``, a ``record_function``
around the traced jobs).  Device activities (kernels, copies, sets) are
clipped to it; their union is the busy time, so work that overlaps on two
streams counts once, and its complement the idle gaps.  Each gap is named
by the innermost host operator running at its middle, the host's part in
the wait.
"""

from __future__ import annotations

import bisect
import collections
from typing import Dict, List, NamedTuple, Tuple

WINDOW = "ppr_bench.window"
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10  # entries of each list of the breakdown


class Activity(NamedTuple):
    name: str
    kind: str  # one of DEVICE_KINDS
    start: float  # seconds from the window's start
    end: float


class TraceData(NamedTuple):
    """Everything a per-layer metric may read (metrics/<name>.py)."""

    window_s: float  # length of the traced window
    busy_s: float  # union of device activities within it
    device: Tuple[Activity, ...]  # device activities in it, by start
    gaps: Tuple[Tuple[float, float, str], ...]  # idle (start, end, host op)
    spans: Dict[str, float]  # the harness's host-clock spans, seconds
    counters: Dict[str, float]  # the program's counts over the traced jobs

    def kernels(self) -> List[Activity]:
        return [a for a in self.device if a.kind == "kernel"]


def _union(intervals: List[Tuple[float, float]], lo: float, hi: float):
    """(busy length, idle gaps) of sorted intervals within [lo, hi]."""
    busy, gaps, cur = 0.0, [], lo
    for s, e in intervals:
        s, e = max(s, lo), min(e, hi)
        if e <= cur:
            continue
        if s > cur:
            gaps.append((cur, s))
            cur = s
        busy += e - cur
        cur = e
    if cur < hi:
        gaps.append((cur, hi))
    return busy, gaps


def _host_at(host, starts, t: float) -> str:
    """Innermost host operator covering time ``t`` (latest start)."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - 50000, -1), -1):
        s, e, name = host[j]
        if e >= t:
            return name
    return "host outside operators"


def kind_of(e) -> str:
    """The event's kind, from its device and name: on the device a kernel,
    a copy, a set or the window's own span; on the host an operator or an
    annotation (the window's span)."""
    name = e.name()
    marked = name.startswith("ppr_bench.")
    if e.device_type().name != "CPU":
        if marked:
            return "gpu_user_annotation"
        if name.startswith("Memcpy"):
            return "gpu_memcpy"
        if name.startswith("Memset"):
            return "gpu_memset"
        return "kernel"
    return "user_annotation" if marked else "cpu_op"


def read(events, spans: Dict[str, float], counters: Dict[str, float]) -> TraceData:
    """A :class:`TraceData` from kineto events (``prof.profiler.kineto_results
    .events()``); raises when the window span or device activity is missing."""
    kinds = [kind_of(e) for e in events]
    win = [e for e, k in zip(events, kinds) if e.name() == WINDOW and k == "user_annotation"]
    if len(win) != 1:
        raise RuntimeError(f"the trace holds {len(win)} windows, not 1")
    t0, t1 = win[0].start_ns(), win[0].end_ns()
    device, host = [], []
    for e, kind in zip(events, kinds):
        s, t = e.start_ns(), e.end_ns()
        if t < t0 or s > t1:
            continue
        if kind in DEVICE_KINDS:
            device.append(Activity(e.name(), kind, (max(s, t0) - t0) / 1e9,
                                   (min(t, t1) - t0) / 1e9))
        elif kind == "cpu_op":
            host.append(((s - t0) / 1e9, (t - t0) / 1e9, e.name()))
    if not device:
        raise RuntimeError("no device activity in the traced window")
    device.sort(key=lambda a: a.start)
    host.sort()
    window_s = (t1 - t0) / 1e9
    busy, gaps = _union([(a.start, a.end) for a in device], 0.0, window_s)
    starts = [h[0] for h in host]
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]
    named = tuple((s, e, _host_at(host, starts, (s + e) / 2)) for s, e in longest)
    return TraceData(window_s, busy, tuple(device), named, dict(spans), dict(counters))


def breakdown(data: TraceData) -> dict:
    """The device operations that took most time and the longest idle gaps,
    by name, in seconds."""
    by_op = collections.Counter()
    for a in data.device:
        by_op[a.name] += a.end - a.start
    return {
        "device_ops": [[name[:200], t] for name, t in by_op.most_common(TOP)],
        "idle_gaps": [[name[:200], e - s] for s, e, name in data.gaps],
    }
