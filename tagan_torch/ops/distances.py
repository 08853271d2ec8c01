"""Pairwise distance / similarity metrics (counterpart of
``tagan_tpu.ops.distances``).

Each metric is one batched expression over ``q [..., H, N, D]`` and
``k [..., H, N, D]`` giving scores ``[..., H, N, N]``, with the JAX
package's numerics: squared distances subtract then square (not the
norm expansion the flash kernel uses), cosine guards zero norms with
1e-8 and clips to [-1, 1], euclidean and mahalanobis add 1e-8 inside
the square root. ``pairwise_scores`` negates the distance-like metrics
into similarities. Per-head parameters (sigma/gamma ``[H]``, cov_inv
``[H, D, D]``) broadcast over the head axis. ``edgewise_scores`` is the
same arithmetic on pairs gathered per edge (the csr path).
"""

from __future__ import annotations

import math
from typing import Optional, Union

import torch

from ..core import module as M

DISTANCE_LIKE = ("euclidean", "squared_euclidean", "manhattan",
                 "cosine_distance", "mahalanobis")
SIMILARITY_LIKE = ("cosine_similarity", "dot_product", "scaled_dot_product",
                   "gaussian_kernel", "rbf_kernel")
ALL_METRICS = DISTANCE_LIKE + SIMILARITY_LIKE

Scale = Union[float, torch.Tensor]


def _diff(q, k):
    return q[..., :, None, :] - k[..., None, :, :]


def _sq_dists(q, k):
    return _diff(q, k).square().sum(-1)


def pairwise_euclidean(q, k):
    return torch.sqrt(_sq_dists(q, k) + 1e-8)


def pairwise_squared_euclidean(q, k):
    return _sq_dists(q, k)


def pairwise_manhattan(q, k):
    return _diff(q, k).abs().sum(-1)


def _safe_norm(x):
    n = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    return torch.where(n == 0, torch.full_like(n, 1e-8), n)


def pairwise_cosine_similarity(q, k):
    dots = M.matmul(q, k.transpose(-1, -2))
    sim = dots / (_safe_norm(q) * _safe_norm(k).transpose(-1, -2))
    return sim.clamp(-1.0, 1.0)


def pairwise_cosine_distance(q, k):
    return 1.0 - pairwise_cosine_similarity(q, k)


def pairwise_dot(q, k):
    return M.matmul(q, k.transpose(-1, -2))


def pairwise_scaled_dot(q, k):
    return pairwise_dot(q, k) / math.sqrt(q.shape[-1])


def pairwise_mahalanobis(q, k, cov_inv: Optional[torch.Tensor] = None):
    """cov_inv: [D, D] or per-head [H, D, D]; None = identity."""
    diff = _diff(q, k)                               # [..., H, N, N, D]
    if cov_inv is None:
        m = diff.square().sum(-1)
    else:
        ci = cov_inv[:, None] if cov_inv.dim() == 3 else cov_inv
        m = (M.matmul(diff, ci) * diff).sum(-1)
    return torch.sqrt(m + 1e-8)


def _per_head(s: Scale, like: torch.Tensor):
    s = torch.as_tensor(s, dtype=like.dtype, device=like.device)
    return s[..., :, None, None] if s.dim() > 0 else s


def pairwise_gaussian_kernel(q, k, sigma: Scale = 1.0):
    sigma = _per_head(sigma, q)
    return torch.exp(-_sq_dists(q, k) / (2.0 * sigma ** 2))


def pairwise_rbf_kernel(q, k, gamma: Scale = 1.0):
    gamma = _per_head(gamma, q)
    return torch.exp(-gamma * _sq_dists(q, k))


def pairwise_scores(
    metric: str,
    q: torch.Tensor,
    k: torch.Tensor,
    *,
    sigma: Optional[torch.Tensor] = None,
    gamma: Optional[torch.Tensor] = None,
    cov_inv: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Attention scores (similarities) for any metric; distance metrics
    are negated."""
    if metric == "scaled_dot_product":
        return pairwise_scaled_dot(q, k)
    if metric == "dot_product":
        return pairwise_dot(q, k)
    if metric == "cosine_similarity":
        return pairwise_cosine_similarity(q, k)
    if metric == "euclidean":
        return -pairwise_euclidean(q, k)
    if metric == "squared_euclidean":
        return -pairwise_squared_euclidean(q, k)
    if metric == "manhattan":
        return -pairwise_manhattan(q, k)
    if metric == "cosine_distance":
        return -pairwise_cosine_distance(q, k)
    if metric == "gaussian_kernel":
        return pairwise_gaussian_kernel(q, k, 1.0 if sigma is None else sigma)
    if metric == "rbf_kernel":
        return pairwise_rbf_kernel(q, k, 1.0 if gamma is None else gamma)
    if metric == "mahalanobis":
        return -pairwise_mahalanobis(q, k, cov_inv)
    raise ValueError(f"Unknown distance metric: {metric}")


def _edge_norm(x):
    n = torch.linalg.vector_norm(x, dim=-1)
    return torch.where(n == 0, torch.full_like(n, 1e-8), n)


def _edge_per_head(s: Scale, like: torch.Tensor):
    s = torch.as_tensor(s, dtype=like.dtype, device=like.device)
    return s[..., :, None] if s.dim() > 0 else s


def edgewise_scores(
    metric: str,
    q_e: torch.Tensor,
    k_e: torch.Tensor,
    *,
    sigma: Optional[torch.Tensor] = None,
    gamma: Optional[torch.Tensor] = None,
    cov_inv: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Scores of gathered pairs (the csr path): q_e, k_e
    ``[..., H, E, D]`` -> ``[..., H, E]``, with `pairwise_scores`'s
    numerics per pair."""
    if metric == "scaled_dot_product":
        return (q_e * k_e).sum(-1) / math.sqrt(q_e.shape[-1])
    if metric == "dot_product":
        return (q_e * k_e).sum(-1)
    if metric in ("cosine_similarity", "cosine_distance"):
        sim = ((q_e * k_e).sum(-1) / (_edge_norm(q_e) * _edge_norm(k_e))
               ).clamp(-1.0, 1.0)
        return sim if metric == "cosine_similarity" else -(1.0 - sim)
    diff = q_e - k_e
    if metric == "euclidean":
        return -torch.sqrt(diff.square().sum(-1) + 1e-8)
    if metric == "squared_euclidean":
        return -diff.square().sum(-1)
    if metric == "manhattan":
        return -diff.abs().sum(-1)
    if metric == "gaussian_kernel":
        s = _edge_per_head(1.0 if sigma is None else sigma, q_e)
        return torch.exp(-diff.square().sum(-1) / (2.0 * s ** 2))
    if metric == "rbf_kernel":
        g = _edge_per_head(1.0 if gamma is None else gamma, q_e)
        return torch.exp(-g * diff.square().sum(-1))
    if metric == "mahalanobis":
        m = diff.square().sum(-1) if cov_inv is None \
            else (M.matmul(diff, cov_inv) * diff).sum(-1)
        return -torch.sqrt(m + 1e-8)
    raise ValueError(f"Unknown distance metric: {metric}")
