"""Host prep: the host-clock seconds of the program's graph build
(``Graph.from_edges``), its predecessor structure (``csc``) and its
2-colouring (``partition``) in the run's set-up."""

PARTS = ("graph_build", "csc", "partition")


def read(data):
    if not all(p in data.spans for p in PARTS):
        return None
    return sum(data.spans[p] for p in PARTS)
