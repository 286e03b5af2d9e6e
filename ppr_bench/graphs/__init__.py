"""Input generators: ``graphs/<name>.py`` makes the edge arrays of the
configurations whose ``graph.generator`` names it.

Each module has ``make(spec, seed, device) -> Edges``: ``spec`` is the
configuration's ``graph`` object, ``seed`` the run's ``--seed``, and
``device`` where to draw (the card in a run).  The same seed gives the same
edges.  The edges are handed back on the host; the program under test and
the reference each get them from there.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Edges(NamedTuple):
    num_nodes: int
    src: torch.Tensor  # int64[E] on the host
    dst: torch.Tensor  # int64[E] on the host


def seed64(seed: int) -> int:
    """A ``--seed`` (any whole number) as a generator seed."""
    return int(seed) & 0xFFFFFFFFFFFFFFFF
