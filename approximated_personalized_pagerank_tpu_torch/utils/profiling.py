"""Profiling hooks: the program's spans and counters, and ``trace()``, which
wraps a region in ``torch.profiler`` and writes a Chrome trace (viewable in
ui.perfetto.dev or chrome://tracing).

**Spans.**  ``with span("grank.half_sweep") as s: ...; s.count("k", n)``
records the region's name, its id, its parent's id (spans nest by the call
stack), its job id (the id of the outermost span of the public call, so
every span of one call shares it), its start and end on ``time.time_ns()``
(the clock of ``torch.profiler``'s events, so spans and operators line up)
and the counts attached to it.  Recording is on while :func:`record` is
active or while a ``torch.profiler`` runs in the thread, so anything that
profiles the program (the CLI's ``--profile``, the benchmark's traced runs)
carries its spans.  Off, ``span`` checks those two flags and returns a
shared do-nothing handle, which is falsy: guard work done only for a count
with ``if s:``.  On or off, a span makes no device call, no
``record_function`` range and no synchronisation, so a trace's device
activities are the program's alone.  Spans are kept in memory, at most
``MAX_SPANS`` (later ones are counted in :func:`dropped`); :func:`recorded`
reads them and :func:`clear` empties the buffer.

The program's spans (PERF.md section 3 names the metric each one feeds):
``grank.job`` (every engine; count ``half_sweeps``) and in it, on every
engine, the main loop's (ops/loop.py) ``grank.half_sweep`` (counts
``merge_launches`` and ``graph_replays``) with its child ``grank.diff_wait``;
on the sparse engine without a mesh also ``grank.upload`` (count
``bytes``, host to device), ``grank.init_sweep`` (count ``graph_replays``),
the half-sweep's rows by merge route (``hub_rows``, ``gather_rows``,
``sort_rows``), on the card the job's ``sweep_graphs_reused`` and
``kept_bytes`` (what the kept CUDA graphs' state holds after the call) and,
at the init sweep's or a partition's first turn, ``grank.graph_capture``
inside that sweep;
``mc.job`` (every engine) and in it, on every engine, ``mc.walks``
(counts ``chunks``, ``walk_kernel_chunks`` and ``macro_steps``: the
walks' source chunks, those the walk cohort kernel walked, and the macro
steps they walked) and ``mc.combine`` (count ``passes``); inside
``mc.walks`` the walks' ``mc.alive_wait``, around the walker's one sync: on
the card one a source chunk, the read of the kernel's count of macro
steps; elsewhere one a macro step, the read of whether any walk is alive.
Code below a span adds to its counts through :func:`current`.

**Traces.**  ``trace(DIR)`` (the CLI's ``--profile DIR`` flag, or
``PPR_PROFILE_DIR``) writes the host operators, the card's kernels when one
is present, and the spans recorded in the region on a track of their own.
Throughput counters are built into the runners (``return_info=True``:
half-sweeps run, the dense engine's FLOPs, walk visits).
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from typing import Dict, List, NamedTuple, Optional

import torch

__all__ = ["Span", "clear", "current", "dropped", "record", "recorded", "span",
           "trace"]

MAX_SPANS = 1 << 16
# The Chrome trace's process that holds the program's spans.
TRACK = "Program spans"


class Span(NamedTuple):
    """One recorded span; times in nanoseconds on ``time.time_ns()``."""

    name: str
    id: int
    parent: Optional[int]  # None for the root of a job
    job: int  # the id of the job's root span
    start_ns: int
    end_ns: int
    counts: Dict[str, int]


_profiler_enabled = torch._C._autograd._profiler_enabled
_recording = 0  # depth of active record() contexts
_spans: List[Span] = []
_dropped = 0
_lock = threading.Lock()
_ids = itertools.count(1)
_local = threading.local()  # .stack: the open spans of this thread


class _Off:
    """The handle of a span that records nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None

    def __bool__(self):
        return False

    def count(self, key: str, n: int = 1) -> None:
        pass


_OFF = _Off()


class _On:
    """The handle of a span being recorded."""

    __slots__ = ("name", "id", "parent", "job", "start_ns", "counts")

    def __init__(self, name: str):
        self.name = name
        self.counts: Dict[str, int] = {}

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.id = next(_ids)
        self.parent = stack[-1].id if stack else None
        self.job = stack[-1].job if stack else self.id
        stack.append(self)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        end_ns = time.time_ns()
        _local.stack.pop()
        global _dropped
        with _lock:
            if len(_spans) < MAX_SPANS:
                _spans.append(Span(self.name, self.id, self.parent, self.job,
                                   self.start_ns, end_ns, self.counts))
            else:
                _dropped += 1
        return None

    def count(self, key: str, n: int = 1) -> None:
        self.counts[key] = self.counts.get(key, 0) + n


def span(name: str):
    """A context manager that records the region as span ``name`` while
    recording is on (module doc); its handle's ``count(key, n)`` adds ``n``
    to the span's count ``key``."""
    if _recording or _profiler_enabled():
        return _On(name)
    return _OFF


def current():
    """The handle of the innermost span open in this thread, or the
    do-nothing handle where none is being recorded: code called inside a
    span adds to its counts without being handed it."""
    stack = getattr(_local, "stack", None)
    return stack[-1] if stack else _OFF


@contextlib.contextmanager
def record():
    """Record spans in the region, with or without a profiler."""
    global _recording
    _recording += 1
    try:
        yield
    finally:
        _recording -= 1


def recorded() -> List[Span]:
    """The recorded spans, in the order they were opened."""
    with _lock:
        return sorted(_spans, key=lambda s: s.id)


def dropped() -> int:
    """Spans left out since the last :func:`clear` because the buffer held
    ``MAX_SPANS``."""
    return _dropped


def clear() -> None:
    """Empty the buffer of recorded spans."""
    global _dropped
    with _lock:
        _spans.clear()
        _dropped = 0


def _chrome_events(spans, base_ns: int) -> List[dict]:
    """The spans as Chrome trace complete events on the track ``TRACK``,
    ``ts`` and ``dur`` in microseconds from ``base_ns`` (the trace's
    ``baseTimeNanoseconds``)."""
    events = [{"ph": "M", "name": "process_name", "pid": TRACK, "tid": 0,
               "args": {"name": TRACK}}]
    for s in spans:
        events.append({
            "ph": "X", "cat": "program_span", "name": s.name, "pid": TRACK, "tid": 0,
            "ts": (s.start_ns - base_ns) / 1e3, "dur": (s.end_ns - s.start_ns) / 1e3,
            "args": {"id": s.id, "parent": s.parent, "job": s.job, **s.counts},
        })
    return events


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """Profile the region into ``log_dir/ppr_trace_<ms>.json`` (host
    operators, the card's kernels when one is present, and the program's
    spans of the region).  A no-op when no directory is given and
    ``PPR_PROFILE_DIR`` is unset."""
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
    t0 = time.time_ns()
    with profile(activities=activities) as prof:
        yield
    t1 = time.time_ns()
    path = os.path.join(log_dir, f"ppr_trace_{int(time.time() * 1000)}.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    spans = [s for s in recorded() if s.start_ns >= t0 and s.end_ns <= t1]
    doc["traceEvents"].extend(_chrome_events(spans, int(doc.get("baseTimeNanoseconds", 0))))
    with open(path, "w") as f:
        json.dump(doc, f)
