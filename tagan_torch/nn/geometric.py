"""Geometric (within-snapshot) multi-head attention.

Counterpart of ``tagan_tpu.nn.geometric``: ``GeometricAttention`` with
its dense path (``forward``: pre-LN, QKV, metric scores, masked softmax,
the optional edge-bias re-softmax, attention @ V, output projection,
residual, post-LN), its flash path (``apply_flash``: the same layer
through the block-sparse attention in ``ops.flash_geometric``), its csr
path (``apply_sparse``: over an edge list, ``ops.sparse``) and its hybrid
path (``apply_hybrid``: band edges through the compact-store kernels,
residual edges through the csr partial, merged exactly), and the
``GraphAttention`` adapter.

Dropout runs when a ``torch.Generator`` is passed (the training forward)
and never otherwise. The dense and csr paths drop the attention weights
(after each softmax when biased) and the projected output; the flash
path drops the attention weights inside the kernel (one int32 hash seed
per folded snapshot, drawn from the generator; the biased variant
derives its second seed from it) and the projected output outside it.
Parameter names follow the JAX tree.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..core.module import (LayerNorm, Linear, default_generator, dropout,
                           xavier_uniform)
from ..core import module as M
from ..ops import distances as D
from ..ops import flash_geometric as FG
from ..ops import hybrid_biased as HB
from ..ops import sparse as S
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
                cov_inv = M.einsum("hrd,hre->hde", f, f)
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
                generator: Optional[torch.Generator] = None,
                geometric_bias: Optional[torch.Tensor] = None,
                return_weights: bool = False):
        """Dense path. x [..., N, hidden], attention_mask bool
        [..., N, N]; dropout from ``generator`` when given.
        ``geometric_bias`` [..., N, N] (shared by the heads) adds the
        re-softmax: the dropped weights plus the bias go through a second
        masked softmax (restricted to the mask, so padding gets no
        weight) and a second dropout. ``return_weights`` also returns the
        attention weights [..., H, N, N] as they multiply V."""
        q, k, v = self._qkv(x)
        sigma, gamma, cov_inv = self._metric_params()
        scores = D.pairwise_scores(self.distance_metric, q, k, sigma=sigma,
                                   gamma=gamma, cov_inv=cov_inv)
        mask = attention_mask
        if mask is not None and mask.dim() == scores.dim() - 1:
            mask = mask[..., None, :, :]
        weights = dropout(masked_softmax(scores, mask), self.dropout,
                          generator)
        if geometric_bias is not None:
            gb = geometric_bias
            if gb.dim() == weights.dim() - 1:
                gb = gb[..., None, :, :]
            weights = dropout(masked_softmax(weights + gb, mask),
                              self.dropout, generator)
        out = self._finish(M.matmul(weights, v), x, generator)
        return (out, weights) if return_weights else out

    def apply_flash(self, x: torch.Tensor, mask: torch.Tensor,
                    generator: Optional[torch.Generator] = None,
                    bias: Optional[torch.Tensor] = None,
                    bf16: bool = False) -> torch.Tensor:
        """Flash path: the same layer with the attention core in the
        block-sparse kernels (forward and, under autograd, backward).
        x [..., N, hidden], mask [..., N, N] (nonzero where query i
        attends to key j). Manhattan is not written through q.k and takes
        the dense path; mahalanobis runs euclidean in factor space
        (|Fq - Fk|^2 = maha(q, k; F^T F)). ``bias`` [..., N, N] is the
        dense path's ``geometric_bias``, served by the edge-biased
        kernels (forward and backward). ``bf16`` takes the kernels' bf16
        forms (bf16 dot operands, float32 sums; the biased kernels' too);
        the layer's other contractions follow
        `core.module.default_matmul_precision`."""
        plan, plan_t = FG.make_block_plans_from_mask(mask)
        return self._apply_flash(x, mask, plan, plan_t, generator, bias,
                                 bf16)

    def _apply_flash(self, x, mask, plan, plan_t=None, generator=None,
                     bias=None, bf16=False):
        """`apply_flash` with the walk plans built by the model
        (``flash_structures``), shared by every layer."""
        metric = self.distance_metric
        if metric not in FG.MXU_METRICS and metric != "mahalanobis":
            return self(x, mask != 0, generator, geometric_bias=bias)
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
                q = M.einsum("...hnd,hrd->...hnr", q, f)
                k = M.einsum("...hnd,hrd->...hnr", k, f)
        ctx = FG._flash_attention(q, k, v, mask, metric, scale, plan,
                                  dropout_rate=rate, dropout_seed=seed,
                                  plan_t=plan_t, bias=bias, bf16=bf16)
        return self._finish(ctx, x, generator)

    def apply_hybrid(self, x: torch.Tensor, store: torch.Tensor, plan,
                     res, node_mask: torch.Tensor,
                     generator: Optional[torch.Generator] = None,
                     band_bias: Optional[torch.Tensor] = None,
                     res_bias: Optional[torch.Tensor] = None,
                     plan_t=None, bf16: bool = False) -> torch.Tensor:
        """Hybrid path (the JAX package's ``apply_hybrid``): the same
        layer with the BAND edges (self loops included) through the
        compact-store kernels and the long-range RESIDUAL edges through
        the O(E) partial, merged exactly through their logsumexps
        (`ops.sparse.merge_attention_partials`). x [..., N, hidden];
        ``store`` and ``plan`` (jlist, jcount, jslot) the band's compact
        store and walk, ``res`` (edge_q, edge_k, edge_mask) [..., Er] the
        residual, node_mask [..., N]; all as `SnapshotSequence.
        with_hybrid_plan` builds them. ``band_bias`` f32[..., S, BM, BN]
        (the band edges' bias in the store's slots) and ``res_bias``
        [..., Er] take the edge-biased double softmax
        (`ops.hybrid_biased`). Mahalanobis runs euclidean in factor space
        on both parts; inactive nodes keep their input. ``plan_t`` is the
        band's transposed walk (ilist, icount, islot), which the band's
        backward needs (B3a c + B3b c, or with the biases B6c, B7a c and
        B7b c): without it a backward raises ValueError. ``bf16`` takes
        the band kernels' bf16 forms (B1c, B3a c, B3b c, or with the
        biases B4c, B5c, B6c, B7a c and B7b c); the residual and the
        merge hold no contraction and stay float32, and the layer's other
        contractions follow `core.module.default_matmul_precision`."""
        metric = self.distance_metric
        if metric not in FG.MXU_METRICS and metric != "mahalanobis":
            raise NotImplementedError(
                f"metric {metric} is not written through q.k; the hybrid "
                "backend needs the flash kernels - use 'csr'")
        sigma, gamma, _ = self._metric_params()
        scale = sigma if sigma is not None else gamma
        biased = band_bias is not None
        rate, seed = 0.0, None
        if generator is not None and self.dropout > 0.0:
            # one int32 hash seed per folded snapshot for the band; the
            # residual draws from the generator itself
            rate = self.dropout
            seed = torch.randint(0, INT32_MAX, (math.prod(x.shape[:-2]),),
                                 generator=generator, device=generator.device,
                                 dtype=torch.int32)
        q, k, v = self._qkv(x)
        if metric == "mahalanobis":
            metric = "euclidean"
            if self.learnable_distance:
                f = self.cov_factors                          # [H, R, Dh]
                q = M.einsum("...hnd,hrd->...hnr", q, f)
                k = M.einsum("...hnd,hrd->...hnr", k, f)
        if biased:
            ctx = HB.hybrid_biased_attention(
                q, k, v, store, plan, res, band_bias, res_bias, metric,
                scale, rate, seed, generator, plan_t, bf16)
        else:
            band = FG._flash_compact(q, k, v, store, plan, metric, scale,
                                     rate, seed, plan_t, bf16)
            part = S.edge_attention_partial(
                metric, q, k, v, *res, x.shape[-2], sigma=sigma, gamma=gamma,
                dropout_rate=rate, generator=generator)
            ctx, _ = S.merge_attention_partials([band, part])
        out = self._finish(ctx, x, generator)
        return torch.where(node_mask[..., None], out, x)

    def apply_sparse(self, x: torch.Tensor, edge_q: torch.Tensor,
                     edge_k: torch.Tensor, edge_mask: torch.Tensor,
                     node_mask: torch.Tensor,
                     generator: Optional[torch.Generator] = None,
                     edge_bias: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
        """csr path: the same layer on an explicit edge list, O(E).
        x [..., N, hidden], edge arrays [..., E'] with the self loops
        already appended (`ops.sparse.add_self_loops`), node_mask
        [..., N]. ``edge_bias`` [..., E'] is the per-edge re-softmax
        bias (zero on the appended self loops). Inactive nodes keep
        their input, unlike on the flash path."""
        q, k, v = self._qkv(x)
        sigma, gamma, cov_inv = self._metric_params()
        ctx = S.edge_attention(
            self.distance_metric, q, k, v, edge_q, edge_k, edge_mask,
            x.shape[-2], sigma=sigma, gamma=gamma, cov_inv=cov_inv,
            edge_bias=edge_bias, dropout_rate=self.dropout,
            generator=generator)
        out = self._finish(ctx, x, generator)
        return torch.where(node_mask[..., None], out, x)


class GraphAttention(nn.Module):
    """Adapter: graph snapshot -> geometric attention over the edge mask
    (adjacency + self loops). With ``use_edge_bias`` the embedded edge
    features, projected to one scalar per pair (``edge_bias``), bias the
    re-softmax."""

    def __init__(self, hidden_dim: int, num_heads: int = 8,
                 distance_metric: str = "scaled_dot_product",
                 use_layer_norm: bool = True,
                 learnable_distance: bool = False,
                 use_edge_bias: bool = False, *, dropout: float = 0.1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = default_generator(generator)
        self.attn = GeometricAttention(
            hidden_dim, num_heads, distance_metric, use_layer_norm,
            learnable_distance, dropout=dropout, generator=g)
        self.use_edge_bias = use_edge_bias
        if use_edge_bias:
            self.edge_bias = Linear(hidden_dim, 1, generator=g)

    def forward(self, x: torch.Tensor, adj_mask: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                edge_features: Optional[torch.Tensor] = None,
                edge_presence: Optional[torch.Tensor] = None,
                return_weights: bool = False):
        """Dense path. ``edge_features`` [..., N, N, hidden] (the embedded
        edge features scattered per pair); the bias exists only where
        ``edge_presence`` (default: the mask) marks a real edge, so the
        implicit self loops carry none. ``return_weights``: (out, the
        attention weights [..., H, N, N])."""
        bias = None
        if self.use_edge_bias and edge_features is not None:
            bias = self.edge_bias(edge_features)[..., 0]
            present = adj_mask if edge_presence is None else edge_presence
            bias = torch.where(present, bias, torch.zeros_like(bias))
        return self.attn(x, adj_mask, generator, geometric_bias=bias,
                         return_weights=return_weights)
