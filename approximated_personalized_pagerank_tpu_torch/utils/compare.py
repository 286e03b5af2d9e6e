"""Comparing two top-L basket sets modulo ties.

Two correct merges of the same candidates can differ in two ways only:
equal scores at the truncation boundary may keep different ids, and the
summation order inside a run of equal ids changes the float sum in its
last bits.  :func:`topl_max_error` accepts exactly those differences.
"""

from __future__ import annotations

import hashlib

import numpy as np


class ToplMismatch(AssertionError):
    """Two basket sets differ beyond ties and the stated tolerance."""


def topl_max_error(a_ids, a_scores, b_ids, b_scores, atol: float) -> float:
    """Max score difference between two ``[R, W]`` top-L results, checking
    row by row that

    * both hold the same number of live (id >= 0) entries, ids distinct,
      scores descending;
    * the sorted live scores agree within ``atol``;
    * an id kept by both sides has one score on both within ``atol``;
    * an id kept by one side only has a score within ``atol`` of that
      side's last (smallest) live score: the cut fell inside a tie.

    Raises :class:`ToplMismatch` naming the first row that breaks a rule.
    """
    a_ids, b_ids = np.asarray(a_ids), np.asarray(b_ids)
    a_scores, b_scores = np.asarray(a_scores), np.asarray(b_scores)
    if a_ids.shape[0] != b_ids.shape[0]:
        raise ToplMismatch(f"row counts {a_ids.shape[0]} != {b_ids.shape[0]}")
    err = 0.0
    for r in range(a_ids.shape[0]):
        la, lb = a_ids[r] >= 0, b_ids[r] >= 0
        if la.sum() != lb.sum():
            raise ToplMismatch(f"row {r}: live counts {la.sum()} != {lb.sum()}")
        sa, sb = a_scores[r][la], b_scores[r][lb]
        if np.any(np.diff(sa) > 0) or np.any(np.diff(sb) > 0):
            raise ToplMismatch(f"row {r}: scores not descending")
        if sa.size == 0:
            continue
        err = max(err, float(np.abs(np.sort(sa) - np.sort(sb)).max()))
        da = dict(zip(a_ids[r][la].tolist(), sa.tolist()))
        db = dict(zip(b_ids[r][lb].tolist(), sb.tolist()))
        if len(da) != sa.size or len(db) != sb.size:
            raise ToplMismatch(f"row {r}: repeated ids")
        for k in set(da) | set(db):
            if k in da and k in db:
                err = max(err, abs(da[k] - db[k]))
            else:
                s, edge = (da[k], sa.min()) if k in da else (db[k], sb.min())
                if abs(s - edge) > atol:
                    raise ToplMismatch(
                        f"row {r}: id {k} (score {s}) kept by one side only, "
                        f"{abs(s - edge)} from the boundary {edge}"
                    )
        if err > atol:
            raise ToplMismatch(f"row {r}: score error {err} > {atol}")
    return err


def basket_sha256(baskets) -> str:
    """sha256 of a basket set's bits: the ids' int32 bytes, then the
    scores' float32 bits, row-major.  Two runs that agree bit for bit give
    one digest."""
    ids = np.ascontiguousarray(baskets.ids.cpu().numpy(), dtype=np.int32)
    bits = np.ascontiguousarray(baskets.scores.cpu().numpy(), dtype=np.float32).view(np.int32)
    h = hashlib.sha256(ids.tobytes())
    h.update(bits.tobytes())
    return h.hexdigest()
