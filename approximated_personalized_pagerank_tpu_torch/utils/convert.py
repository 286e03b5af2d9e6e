"""Build the port's state from plain numpy arrays.

The system's state is the graph and the basket set; there are no weights.
These helpers take the arrays another implementation (for example the JAX
package) holds, so a test can feed both implementations one exact state
and compare a single step.
"""

from __future__ import annotations

from typing import Hashable, Sequence, Tuple

import numpy as np
import torch

from ..graph import Graph
from ..ops.basket import Baskets


def graph_from_arrays(
    indptr: np.ndarray,
    indices: np.ndarray,
    keys: Sequence[Hashable] | None = None,
) -> Graph:
    """A :class:`Graph` over the given CSR arrays (and external keys)."""
    return Graph(np.asarray(indptr), np.asarray(indices), keys=keys)


def baskets_from_numpy(ids: np.ndarray, scores: np.ndarray, device) -> Baskets:
    """``Baskets`` on ``device`` from ``[N, W]`` id and score arrays."""
    ids = np.asarray(ids)
    scores = np.asarray(scores)
    if ids.shape != scores.shape or ids.ndim != 2:
        raise ValueError(
            f"ids and scores must be [N, W] of one shape, got {ids.shape}, {scores.shape}"
        )
    return Baskets(
        torch.as_tensor(ids.astype(np.int32)).to(device),
        torch.as_tensor(scores.astype(np.float32)).to(device),
    )


def dense_state_from_numpy(
    A0: np.ndarray, A1: np.ndarray, S: np.ndarray, device, dtype=torch.float32
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The dense engine's state (the partitions' adjacency rows ``A0``
    ``[n0, n_pad]`` and ``A1`` ``[n1, n_pad]``, the score matrix ``S``
    ``[n_pad, n_pad]``) on ``device`` in ``dtype``, from numpy arrays."""
    A0, A1, S = (np.asarray(x, dtype=np.float32) for x in (A0, A1, S))
    n_pad = S.shape[0]
    if S.shape != (n_pad, n_pad) or A0.shape[1:] != (n_pad,) or A1.shape[1:] != (n_pad,):
        raise ValueError(
            f"A0, A1 must be [n_p, n_pad] and S [n_pad, n_pad], got "
            f"{A0.shape}, {A1.shape}, {S.shape}"
        )
    return tuple(torch.tensor(x, dtype=dtype, device=device) for x in (A0, A1, S))
