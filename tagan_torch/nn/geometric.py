"""Geometric (within-snapshot) multi-head attention.

Counterpart of ``tagan_tpu.nn.geometric``: ``GeometricAttention`` with
its dense path (``forward``: pre-LN, QKV, metric scores, masked softmax,
attention @ V, output projection, residual, post-LN) and its flash path
(``apply_flash``: the same layer through the block-sparse attention in
``ops.flash_geometric``), and the ``GraphAttention`` adapter.

Dropout runs when a ``torch.Generator`` is passed (the training forward)
and never otherwise. The dense path drops the attention weights and the
projected output; the flash path drops the attention weights inside the
kernel (one int32 hash seed per folded snapshot, drawn from the
generator) and the projected output outside it. Parameter names follow
the JAX tree.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..core.module import (LayerNorm, Linear, default_generator, dropout,
                           xavier_uniform)
from ..ops import distances as D
from ..ops import flash_geometric as FG
from ..ops.masked import masked_softmax

INT32_MAX = 2 ** 31 - 1


class GeometricAttention(nn.Module):
    def __init__(self, hidden_dim: int, num_heads: int = 8,
                 distance_metric: str = "scaled_dot_product",
                 use_layer_norm: bool = True,
                 learnable_distance: bool = False, *,
                 dropout: float = 0.1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if hidden_dim % num_heads != 0:
            raise ValueError(
                "Hidden dimension must be divisible by number of heads")
        g = default_generator(generator)
        self.hidden_dim = hidden_dim
        self.num_heads = num_heads
        self.head_dim = hidden_dim // num_heads
        self.distance_metric = distance_metric
        self.use_layer_norm = use_layer_norm
        self.learnable_distance = learnable_distance
        self.dropout = dropout
        h = hidden_dim
        self.q = Linear(h, h, generator=g)
        self.k = Linear(h, h, generator=g)
        self.v = Linear(h, h, generator=g)
        self.o = Linear(h, h, generator=g)
        if use_layer_norm:
            self.ln1 = LayerNorm(h)
            self.ln2 = LayerNorm(h)
        if learnable_distance:
            if distance_metric == "gaussian_kernel":
                self.distance_param = nn.Parameter(torch.ones(num_heads))
            elif distance_metric == "rbf_kernel":
                self.distance_param = nn.Parameter(
                    torch.full((num_heads,), 0.1))
            elif distance_metric == "mahalanobis":
                rank = min(16, hidden_dim // 4)
                self.cov_factors = nn.Parameter(xavier_uniform(
                    (num_heads, rank, self.head_dim), g))

    def _metric_params(self):
        sigma = gamma = cov_inv = None
        if self.learnable_distance:
            if self.distance_metric == "gaussian_kernel":
                sigma = self.distance_param
            elif self.distance_metric == "rbf_kernel":
                gamma = self.distance_param
            elif self.distance_metric == "mahalanobis":
                f = self.cov_factors                          # [H, R, Dh]
                cov_inv = torch.einsum("hrd,hre->hde", f, f)
        return sigma, gamma, cov_inv

    def _split_heads(self, x: torch.Tensor) -> torch.Tensor:
        # [..., N, hidden] -> [..., H, N, Dh]
        *lead, n, _ = x.shape
        return x.reshape(*lead, n, self.num_heads,
                         self.head_dim).movedim(-2, -3)

    def _merge_heads(self, x: torch.Tensor) -> torch.Tensor:
        # [..., H, N, Dh] -> [..., N, hidden]
        x = x.movedim(-3, -2)
        return x.reshape(*x.shape[:-2], self.hidden_dim)

    def _qkv(self, x):
        h = self.ln1(x) if self.use_layer_norm else x
        return (self._split_heads(self.q(h)), self._split_heads(self.k(h)),
                self._split_heads(self.v(h)))

    def _finish(self, ctx, identity, generator):
        ctx = dropout(self.o(self._merge_heads(ctx)), self.dropout, generator)
        out = ctx + identity
        return self.ln2(out) if self.use_layer_norm else out

    def forward(self, x: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        """Dense path. x [..., N, hidden], attention_mask bool
        [..., N, N]; dropout from ``generator`` when given."""
        q, k, v = self._qkv(x)
        sigma, gamma, cov_inv = self._metric_params()
        scores = D.pairwise_scores(self.distance_metric, q, k, sigma=sigma,
                                   gamma=gamma, cov_inv=cov_inv)
        mask = attention_mask
        if mask is not None and mask.dim() == scores.dim() - 1:
            mask = mask[..., None, :, :]
        weights = dropout(masked_softmax(scores, mask), self.dropout,
                          generator)
        return self._finish(weights @ v, x, generator)

    def apply_flash(self, x: torch.Tensor, mask: torch.Tensor,
                    generator: Optional[torch.Generator] = None
                    ) -> torch.Tensor:
        """Flash path: the same layer with the attention core in the
        block-sparse kernels (forward and, under autograd, backward).
        x [..., N, hidden], mask [..., N, N] (nonzero where query i
        attends to key j). Manhattan is not written through q.k and takes
        the dense path; mahalanobis runs euclidean in factor space
        (|Fq - Fk|^2 = maha(q, k; F^T F))."""
        plan, plan_t = FG.make_block_plans_from_mask(mask)
        return self._apply_flash(x, mask, plan, plan_t, generator)

    def _apply_flash(self, x, mask, plan, plan_t=None, generator=None):
        """`apply_flash` with the walk plans built by the model
        (``flash_structures``), shared by every layer."""
        metric = self.distance_metric
        if metric not in FG.MXU_METRICS and metric != "mahalanobis":
            return self(x, mask != 0, generator)
        sigma, gamma, _ = self._metric_params()
        scale = sigma if sigma is not None else gamma
        rate, seed = 0.0, None
        if generator is not None and self.dropout > 0.0:
            # one int32 hash seed per folded snapshot
            rate = self.dropout
            seed = torch.randint(0, INT32_MAX, (math.prod(x.shape[:-2]),),
                                 generator=generator, device=generator.device,
                                 dtype=torch.int32)
        q, k, v = self._qkv(x)
        if metric == "mahalanobis":
            metric = "euclidean"
            if self.learnable_distance:
                f = self.cov_factors                          # [H, R, Dh]
                q = torch.einsum("...hnd,hrd->...hnr", q, f)
                k = torch.einsum("...hnd,hrd->...hnr", k, f)
        ctx = FG._flash_attention(q, k, v, mask, metric, scale, plan,
                                  dropout_rate=rate, dropout_seed=seed,
                                  plan_t=plan_t)
        return self._finish(ctx, x, generator)


class GraphAttention(nn.Module):
    """Adapter: graph snapshot -> geometric attention over the edge mask
    (adjacency + self loops). Edge-feature bias is not ported yet."""

    def __init__(self, hidden_dim: int, num_heads: int = 8,
                 distance_metric: str = "scaled_dot_product",
                 use_layer_norm: bool = True,
                 learnable_distance: bool = False,
                 use_edge_bias: bool = False, *, dropout: float = 0.1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if use_edge_bias:
            raise NotImplementedError(
                "edge-feature bias needs the edge-biased kernels, which "
                "are not ported yet")
        self.attn = GeometricAttention(
            hidden_dim, num_heads, distance_metric, use_layer_norm,
            learnable_distance, dropout=dropout, generator=generator)

    def forward(self, x: torch.Tensor, adj_mask: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        return self.attn(x, adj_mask, generator)
