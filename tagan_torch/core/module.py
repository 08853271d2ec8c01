"""Parameter primitives of the PyTorch port.

Counterpart of ``tagan_tpu.core.module``. Weights keep the JAX
package's layout: a linear weight is stored ``[in, out]`` (the transpose
of ``torch.nn.Linear``) under the name ``w``, its bias under ``b``, and a
LayerNorm's scale and shift under ``g`` and ``b``. Module attribute
names follow the JAX parameter tree, so a converted JAX tree loads with
``load_state_dict`` (``tagan_torch.convert``).

Initialisation draws from an explicit ``torch.Generator`` on the CPU:
Xavier/Glorot-uniform weights, constant biases, LayerNorm scale 1 and
shift 0, as the JAX package does. The numbers differ from JAX's for the
same seed, so parity tests load converted weights. Dropout, likewise,
draws from an explicit generator and is off without one.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn


def resolve_device(device) -> torch.device:
    """``torch.device(device)``; raises when CUDA is asked for and absent
    (the port never carries on silently on the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch path")
    return dev


def default_generator(generator: Optional[torch.Generator]
                      ) -> torch.Generator:
    return generator if generator is not None \
        else torch.Generator().manual_seed(0)


def xavier_uniform(shape: Sequence[int],
                   generator: torch.Generator) -> torch.Tensor:
    """Glorot-uniform init for the ``[..., in, out]`` layout: the
    trailing two dims are the fans, leading dims the receptive field; a
    vector counts as ``[1, n]``."""
    if len(shape) < 2:
        fan_in, fan_out = 1, shape[0]
    else:
        receptive = math.prod(shape[:-2])
        fan_in, fan_out = shape[-2] * receptive, shape[-1] * receptive
    bound = math.sqrt(6.0 / (fan_in + fan_out))
    u = torch.rand(tuple(shape), generator=generator, dtype=torch.float32)
    return u * (2.0 * bound) - bound


def linear(x: torch.Tensor, w: torch.Tensor,
           b: Optional[torch.Tensor] = None) -> torch.Tensor:
    y = x @ w
    return y if b is None else y + b


class Linear(nn.Module):
    """``y = x @ w + b`` with ``w`` stored ``[in, out]``."""

    def __init__(self, in_dim: int, out_dim: int, bias: bool = True,
                 bias_init: float = 0.0, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = default_generator(generator)
        self.w = nn.Parameter(xavier_uniform((in_dim, out_dim), g))
        if bias:
            self.b = nn.Parameter(torch.full((out_dim,), float(bias_init)))
        else:
            self.register_parameter("b", None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(x, self.w, self.b)


def layer_norm(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """Biased variance, eps inside the square root (torch's LayerNorm)."""
    return F.layer_norm(x, x.shape[-1:], g, b, eps)


class LayerNorm(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.g = nn.Parameter(torch.ones(dim))
        self.b = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.g, self.b)


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout: keep each entry with probability 1 - rate and
    scale it by 1 / (1 - rate). The identity when ``generator`` is None
    (the deterministic forward) or at rate 0. The keep mask is drawn from
    ``generator`` on the generator's device, so the same generator state
    gives the same mask."""
    if generator is None or rate <= 0.0:
        return x
    keep = 1.0 - rate
    u = torch.rand(x.shape, generator=generator, device=generator.device)
    return torch.where(u.to(x.device) < keep, x / keep,
                       torch.zeros((), dtype=x.dtype, device=x.device))


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x)


def activation(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    """Activation by name; unknown names give relu. ``"gelu"`` is the
    tanh approximation, because the JAX package maps it to
    ``jax.nn.gelu``, whose default is the approximation;
    ``"gelu_exact"`` is the erf form."""
    return {
        "relu": F.relu,
        "leaky_relu": lambda x: F.leaky_relu(x, 0.01),
        "gelu": lambda x: F.gelu(x, approximate="tanh"),
        "gelu_exact": gelu_exact,
        "elu": F.elu,
        "tanh": torch.tanh,
        "sigmoid": torch.sigmoid,
    }.get(name, F.relu)
