"""Per-layer metrics: ``metrics/<name>.py`` reads the metric ``<name>`` of
BENCHMARK.json from a traced run.

Each module has ``read(data) -> float | None``, ``data`` being the traced
window (``ppr_bench.trace.TraceData``: device activities, idle gaps, the
harness's host-clock spans, the program's counters over the traced jobs).
A reader that finds nothing to read returns None, and the run leaves the
metric out.  A metric ``<base>.<part>`` without a file of its own is read
by ``metrics/<base>.py``: the same reading, reported under the name of the
cells' own end-to-end metric that it moves.
"""
