"""Time encodings, 5 types (counterpart of ``tagan_tpu.nn.time_encoding``).

  sinusoidal  Transformer table
  linear      position / max_len, repeated over d
  log         log(position) / log(max_len), repeated
  learned     free [max_len, d] parameter
  basis       learnable RBF centres/widths + projection (the default)

Continuous times are min-max normalised over the whole input, then
basis-evaluated (basis) or quantised to table rows (the others).
``batch_dims`` leading dims are independent inputs: each is normalised
on its own, as the JAX package does per sequence under ``vmap``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..core.module import Linear, default_generator, dropout


def sinusoidal_table(max_len: int, d_model: int) -> torch.Tensor:
    pe = torch.zeros(max_len, d_model)
    position = torch.arange(max_len, dtype=torch.float32)[:, None]
    div_term = torch.exp(torch.arange(0, d_model, 2, dtype=torch.float32)
                         * (-math.log(10000.0) / d_model))
    pe[:, 0::2] = torch.sin(position * div_term)
    pe[:, 1::2] = torch.cos(position * div_term[:d_model // 2])
    return pe


def _min_max(t: torch.Tensor, batch_dims: int):
    flat = t.reshape(*t.shape[:batch_dims], -1)
    shape = t.shape[:batch_dims] + (1,) * (t.dim() - batch_dims)
    return flat.amin(-1).reshape(shape), flat.amax(-1).reshape(shape)


class TimeEncoding(nn.Module):
    def __init__(self, d_model: int, max_len: int = 5000,
                 learnable: bool = False, encoding_type: str = "sinusoidal",
                 num_bases: int = 16, scale: float = 1.0, *,
                 dropout: float = 0.1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = default_generator(generator)
        self.d_model = d_model
        self.max_len = max_len
        self.encoding_type = encoding_type
        self.scale = scale
        self.dropout = dropout
        if encoding_type == "basis":
            self.basis_mu = nn.Parameter(torch.linspace(0.0, 1.0, num_bases))
            self.basis_sigma = nn.Parameter(torch.full((num_bases,), 0.1))
            self.basis_proj = Linear(num_bases, d_model, generator=g)
        elif encoding_type == "learned":
            self.pe = nn.Parameter(torch.randn(max_len, d_model, generator=g))
        elif learnable:
            self.pe = nn.Parameter(self._fixed_table())

    def _fixed_table(self) -> torch.Tensor:
        t = self.encoding_type
        if t == "sinusoidal":
            return sinusoidal_table(self.max_len, self.d_model)
        if t == "linear":
            pos = torch.arange(self.max_len, dtype=torch.float32) / self.max_len
            return pos[:, None].repeat(1, self.d_model)
        if t == "log":
            pos = torch.log(torch.arange(1, self.max_len + 1,
                                         dtype=torch.float32)
                            ) / math.log(self.max_len)
            return pos[:, None].repeat(1, self.d_model)
        return torch.zeros(self.max_len, self.d_model)

    def _basis_encode(self, time_norm: torch.Tensor) -> torch.Tensor:
        sigma_safe = torch.clamp(self.basis_sigma, min=1e-7)
        dist = (time_norm[..., None] - self.basis_mu).square()
        exponent = torch.clamp(-(dist / (2.0 * sigma_safe ** 2)), -88.0, 88.0)
        vals = torch.nan_to_num(torch.exp(exponent), nan=0.0)
        return torch.nan_to_num(self.basis_proj(vals), nan=0.0)

    def forward(self, time_values: Optional[torch.Tensor] = None,
                x: Optional[torch.Tensor] = None,
                batch_dims: int = 0,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        """The encoding (shape of ``time_values`` + [d]), or
        ``x + encoding`` when ``x`` is given; the encoding is dropped
        out with ``generator``."""
        if time_values is None and x is None:
            raise ValueError("Either time_values or x must be provided")
        if self.encoding_type == "basis" and time_values is None:
            s = x.shape[-2]
            pos = (torch.arange(s, dtype=x.dtype, device=x.device)
                   / max(s - 1, 1)).expand(x.shape[:-1])
            encoding = self._basis_encode(pos)
        elif self.encoding_type == "basis":
            tv = torch.nan_to_num(time_values, nan=0.0)
            tmin, tmax = _min_max(tv, batch_dims)
            ok = (tmax - tmin) > 1e-7
            time_norm = torch.where(
                ok, (tv - tmin) / torch.where(ok, tmax - tmin,
                                              torch.ones_like(tmax)),
                torch.zeros_like(tv))
            encoding = self._basis_encode(time_norm)
        else:
            if time_values is not None:
                tmin, tmax = _min_max(time_values, batch_dims)
                ok = tmax > tmin
                pos = torch.where(
                    ok, (time_values - tmin)
                    / torch.where(ok, tmax - tmin, torch.ones_like(tmax))
                    * (self.max_len - 1),
                    torch.zeros_like(time_values)).to(torch.int32)
                pos = torch.clamp(pos, 0, self.max_len - 1)
            else:
                s = x.shape[-2]
                pos = torch.arange(s, device=x.device).expand(x.shape[:-1])
            table = self.pe if hasattr(self, "pe") else \
                self._fixed_table().to(pos.device)
            encoding = table[pos.long()]
        encoding = dropout(encoding * self.scale, self.dropout, generator)
        return x + encoding if x is not None else encoding
