"""Job adapters: ``algorithms/<name>.py`` drives the program under test for
the cells whose ``algorithm`` names it.

Each module has:

* ``setup(edges, job, span, device) -> state``: the program's set-up on the
  edges (host prep), its steps timed under ``span(name)``;
* ``run(state, job, seed, index) -> (output, counters)``: one job, the
  program's public call, not yet synchronised; ``counters`` are the
  program's own counts of the work (summed over the window);
* ``digest(output) -> tensor``: a device-side fingerprint of a job's output;
* ``DETERMINISTIC``: whether every job of a run must give the same output;
* ``check(edges, output, counters, job, limits, device) -> {name: (value,
  limit)}``: the numbers that decide ``correct`` for the last job's output
  and counters, each with its limit (a value above its limit fails), from
  the plain reference under ``reference/``.
"""
