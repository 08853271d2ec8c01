"""Masked softmax and pooling (counterpart of ``tagan_tpu.ops.masked``).

Masked entries take the finite ``NEG_INF``; a row with no valid entry
returns zeros instead of NaN."""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def masked_softmax(scores: torch.Tensor, mask: Optional[torch.Tensor],
                   dim: int = -1) -> torch.Tensor:
    """softmax(where(mask, scores, -inf)) with zero rows where every
    entry is masked."""
    if mask is None:
        return torch.softmax(scores, dim=dim)
    masked = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    m = masked.amax(dim=dim, keepdim=True)
    # dead rows: exp(NEG_INF - 0) underflows to exactly 0
    m = torch.where(m <= NEG_INF * 0.5, torch.zeros_like(m), m)
    e = torch.exp(masked - m)
    denom = e.sum(dim=dim, keepdim=True)
    return e / torch.where(denom == 0, torch.ones_like(denom), denom)


def _expand(mask: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    m = mask.to(x.dtype)
    return m[..., None] if mask.dim() == x.dim() - 1 else m


def masked_mean(x: torch.Tensor, mask: Optional[torch.Tensor], dim: int,
                eps: float = 1e-10) -> torch.Tensor:
    """Mean over ``dim`` counting only masked-in entries (denominator
    + eps)."""
    if mask is None:
        return x.mean(dim=dim)
    m = _expand(mask, x)
    return (x * m).sum(dim=dim) / (m.sum(dim=dim) + eps)


def masked_max(x: torch.Tensor, mask: Optional[torch.Tensor], dim: int
               ) -> torch.Tensor:
    """Max with masked-out entries at -1e9."""
    if mask is None:
        return x.amax(dim=dim)
    m = _expand(mask, x)
    return (x * m + (1.0 - m) * -1e9).amax(dim=dim)
