"""Temporal attention over the snapshot axis.

Counterpart of ``tagan_tpu.nn.temporal_attention``: ``causal_mask``,
``TemporalAttention`` (pre-LN multi-head attention over time, the base
of the asymmetric layer) and ``AsymmetricTemporalAttention`` (adds the
relative-position bias table, the learned asymmetric past/future kernel,
continuous-time scores through `TimeEncoding` and the |dt| time mask).
Inputs are ``[..., T, hidden]``; masks are boolean.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..core.module import (LayerNorm, Linear, default_generator, dropout,
                           xavier_uniform)
from ..ops.masked import masked_softmax
from .time_encoding import TimeEncoding


def causal_mask(seq_len: int, device=None) -> torch.Tensor:
    """Lower-triangular causal mask."""
    return torch.tril(torch.ones(seq_len, seq_len, dtype=torch.bool,
                                 device=device))


class TemporalAttention(nn.Module):
    def __init__(self, hidden_dim: int, num_heads: int = 8,
                 causal: bool = False, use_layer_norm: bool = True, *,
                 dropout: float = 0.1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if hidden_dim % num_heads != 0:
            raise ValueError("hidden_dim must be divisible by num_heads")
        g = default_generator(generator)
        self.hidden_dim = hidden_dim
        self.num_heads = num_heads
        self.head_dim = hidden_dim // num_heads
        self.causal = causal
        self.use_layer_norm = use_layer_norm
        self.dropout = dropout
        h = hidden_dim
        self.q = Linear(h, h, generator=g)
        self.k = Linear(h, h, generator=g)
        self.v = Linear(h, h, generator=g)
        self.o = Linear(h, h, generator=g)
        if use_layer_norm:
            self.ln1 = LayerNorm(h)
            self.ln2 = LayerNorm(h)

    def _qkv(self, x: torch.Tensor):
        *lead, t, _ = x.shape

        def split(y):   # [..., T, hidden] -> [..., H, T, Dh]
            return y.reshape(*lead, t, self.num_heads,
                             self.head_dim).movedim(-2, -3)
        h = self.ln1(x) if self.use_layer_norm else x
        return split(self.q(h)), split(self.k(h)), split(self.v(h))

    def _finish(self, weights, v, identity, generator):
        ctx = (weights @ v).movedim(-3, -2)
        ctx = ctx.reshape(*ctx.shape[:-2], self.hidden_dim)
        out = dropout(self.o(ctx), self.dropout, generator) + identity
        return self.ln2(out) if self.use_layer_norm else out

    def _scores(self, q, k):
        return q @ k.transpose(-1, -2) / math.sqrt(self.head_dim)

    def _softmax_finish(self, scores, mask, v, x, generator):
        t = x.shape[-2]
        if self.causal:
            cm = causal_mask(t, x.device)
            mask = cm if mask is None else mask & cm
        if mask is not None and mask.dim() == scores.dim() - 1:
            mask = mask[..., None, :, :]
        weights = dropout(masked_softmax(scores, mask), self.dropout,
                          generator)
        return self._finish(weights, v, x, generator)

    def forward(self, x: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        """x [..., T, hidden], attention_mask bool [T, T] or
        [..., T, T]; dropout from ``generator`` when given."""
        q, k, v = self._qkv(x)
        return self._softmax_finish(self._scores(q, k), attention_mask, v, x,
                                    generator)


class AsymmetricTemporalAttention(TemporalAttention):
    def __init__(self, hidden_dim: int, num_heads: int = 8,
                 causal: bool = False, time_aware: bool = True,
                 use_layer_norm: bool = True,
                 asymmetric_window_size: int = 5,
                 future_discount: float = 0.8,
                 relative_position_bias: bool = True,
                 max_relative_position: int = 32,
                 time_encoding_type: str = "basis",
                 use_time_masks: bool = True, max_time_diff: float = 10.0,
                 orient_past_high: bool = False, *,
                 dropout: float = 0.1,
                 generator: Optional[torch.Generator] = None):
        g = default_generator(generator)
        super().__init__(hidden_dim, num_heads, causal, use_layer_norm,
                         dropout=dropout, generator=g)
        self.time_aware = time_aware
        self.window = asymmetric_window_size
        self.future_discount = future_discount
        self.relative_position_bias = relative_position_bias
        self.max_relative_position = max_relative_position
        self.use_time_masks = use_time_masks
        self.max_time_diff = max_time_diff
        # False keeps the reference's init, whose high weights land on
        # future keys; True puts them on past keys (rel = i - j > 0)
        self.orient_past_high = orient_past_high
        if relative_position_bias:
            self.relative_pos_table = nn.Parameter(xavier_uniform(
                (2 * max_relative_position + 1, num_heads), g))
        if time_aware:
            self.time_encoding = TimeEncoding(
                d_model=hidden_dim, learnable=True,
                encoding_type=time_encoding_type,
                num_bases=hidden_dim // 4, dropout=dropout, generator=g)
            self.time_q_proj = Linear(hidden_dim, num_heads, generator=g)
        self.asymmetric_kernel = nn.Parameter(self._init_asymmetric_kernel())

    def _init_asymmetric_kernel(self) -> torch.Tensor:
        """1 - 0.5 d/W on the high side, discount * (1 - 0.5 d/W) on the
        low side, 1 at the centre; [2W+1, H]."""
        w = self.window
        idx = torch.arange(2 * w + 1)
        base = 1.0 - 0.5 * ((idx - w).abs().float() / w)
        high = (idx > w) if self.orient_past_high else (idx < w)
        low = (idx < w) if self.orient_past_high else (idx > w)
        vals = torch.where(high, base, torch.where(
            low, self.future_discount * base, torch.ones_like(base)))
        return vals[:, None].repeat(1, self.num_heads)

    def _rel(self, t: int, device) -> torch.Tensor:
        pos = torch.arange(t, device=device)
        return pos[:, None] - pos[None, :]

    def time_mask(self, time_stamps: torch.Tensor) -> torch.Tensor:
        """|dt| <= max_time_diff, [..., T, T]."""
        td = (time_stamps[..., :, None] - time_stamps[..., None, :]).abs()
        return td <= self.max_time_diff

    def forward(self, x: torch.Tensor,
                time_stamps: Optional[torch.Tensor] = None,
                attention_mask: Optional[torch.Tensor] = None,
                batch_dims: int = 0,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        """x [..., T, hidden], time_stamps [..., T] (broadcast against
        x's leading dims), attention_mask bool [..., T, T]. The first
        ``batch_dims`` dims of ``time_stamps`` are independent sequences
        for the time encoding's normalisation. Dropout (time encoding,
        weights, output) from ``generator`` when given."""
        t = x.shape[-2]
        q, k, v = self._qkv(x)
        scores = self._scores(q, k)                       # [..., H, T, T]
        rel = self._rel(t, x.device)
        if self.relative_position_bias:
            idx = torch.clamp(rel + self.max_relative_position, 0,
                              2 * self.max_relative_position)
            scores = scores + self.relative_pos_table[idx].movedim(-1, 0)
        within = (rel >= -self.window) & (rel <= self.window)
        kern = self.asymmetric_kernel[torch.clamp(rel + self.window, 0,
                                                  2 * self.window)]
        scores = scores + (kern * within[..., None]).movedim(-1, 0)

        mask = attention_mask
        if mask is not None and mask.dtype != torch.bool:
            mask = mask != 0
        if self.time_aware and time_stamps is not None:
            diffs = time_stamps[..., :, None] - time_stamps[..., None, :]
            enc = self.time_encoding(diffs, batch_dims=batch_dims,
                                     generator=generator)
            scores = scores + self.time_q_proj(enc).movedim(-1, -3)
            if self.use_time_masks:
                tm = self.time_mask(time_stamps)
                mask = tm if mask is None else mask & tm
        return self._softmax_finish(scores, mask, v, x, generator)
