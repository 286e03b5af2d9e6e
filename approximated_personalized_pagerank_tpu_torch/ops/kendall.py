"""Batched Kendall tau-b with tie correction.

Reference: ``kendallCorrelation`` (include/internal/kendall.h:22-179), which
counts discordant pairs with a merge sort.  Basket sizes are <= K (small),
so this is direct O(K^2) masked pair counting, batched over sources.

Formula parity (kendall.h:165-179):
    num = C - D                       (concordant minus discordant)
    den = sqrt((T - sameX) * (T - sameY))
    den == 0  ->  1.0 if sameX == sameY else 0.0
where T = n(n-1)/2 and sameX/sameY count pairs tied in x / in y.
"""

from __future__ import annotations

import torch

__all__ = ["kendall_tau_b"]


def kendall_tau_b(
    x: torch.Tensor, y: torch.Tensor, valid: torch.Tensor | None = None
) -> torch.Tensor:
    """Kendall tau-b over the last axis, batched over leading axes.

    ``valid`` masks live entries (rows may hold fewer than width items).
    Returns float32 with the reference's den==0 convention.
    """
    dtype = torch.float64 if x.dtype == torch.float64 else torch.float32
    x = x.to(dtype)
    y = y.to(dtype)
    if valid is None:
        valid = torch.ones(x.shape, dtype=torch.bool, device=x.device)
    w = x.shape[-1]
    upper = torch.triu(
        torch.ones((w, w), dtype=torch.bool, device=x.device), diagonal=1
    )
    pair_valid = valid[..., :, None] & valid[..., None, :] & upper
    # Direct comparisons, not sign(dx*dy): comparing two floats is exact,
    # while a product of two small differences can underflow to a false tie.
    gt_x = x[..., :, None] > x[..., None, :]
    lt_x = x[..., :, None] < x[..., None, :]
    gt_y = y[..., :, None] > y[..., None, :]
    lt_y = y[..., :, None] < y[..., None, :]
    tie_x = ~gt_x & ~lt_x & pair_valid
    tie_y = ~gt_y & ~lt_y & pair_valid
    dims = (-2, -1)
    concordant = (((gt_x & gt_y) | (lt_x & lt_y)) & pair_valid).sum(dim=dims)
    discordant = (((gt_x & lt_y) | (lt_x & gt_y)) & pair_valid).sum(dim=dims)
    same_x = tie_x.sum(dim=dims)
    same_y = tie_y.sum(dim=dims)
    total = pair_valid.sum(dim=dims)

    num = (concordant - discordant).to(torch.float32)
    den = torch.sqrt(
        (total - same_x).to(torch.float32) * (total - same_y).to(torch.float32)
    )
    tau = torch.where(den > 0, num / den.clamp(min=1e-30), torch.zeros_like(num))
    degenerate = (same_x == same_y).to(torch.float32)
    return torch.where(den == 0, degenerate, tau)
