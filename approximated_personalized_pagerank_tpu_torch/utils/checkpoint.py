"""Basket save/load, in the JAX package's ``.npz`` format.

The reference keeps everything in memory; its thesis sketches persisting
score maps to secondary storage (thesis §6.1 p.23).  Basket tensors
round-trip to ``.npz`` (keys ``ids``, ``scores`` and, with a graph,
``keys``: the external key vocabulary), so an all-sources run is computed
once and served later.  Files written by either package load in the other.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..graph import Graph
from ..ops.basket import Baskets
from .device import resolve_device

__all__ = ["save_baskets", "load_baskets"]


def save_baskets(path: str, baskets: Baskets, graph: Optional[Graph] = None) -> None:
    arrays = {
        "ids": baskets.ids.cpu().numpy(),
        "scores": baskets.scores.cpu().numpy(),
    }
    if graph is not None:
        keys = np.asarray(graph.keys)
        arrays["keys"] = keys if keys.dtype.kind in "iuf" else keys.astype("U")
    np.savez_compressed(path, **arrays)


def load_baskets(path: str, device=None):
    """Returns ``(Baskets, keys-or-None)``; the baskets on ``device`` (None
    means ``"cuda"``, which raises without a card; pass ``"cpu"``)."""
    dev = resolve_device(device)
    with np.load(path, allow_pickle=False) as data:
        baskets = Baskets(
            torch.as_tensor(data["ids"]).to(dev),
            torch.as_tensor(data["scores"]).to(dev),
        )
        keys = data["keys"] if "keys" in data.files else None
    return baskets, keys
