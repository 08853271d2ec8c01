"""Parameter primitives of the PyTorch port.

Counterpart of ``tagan_tpu.core.module``. Weights keep the JAX
package's layout: a linear weight is stored ``[in, out]`` (the transpose
of ``torch.nn.Linear``) under the name ``w``, its bias under ``b``, and a
LayerNorm's scale and shift under ``g`` and ``b``. Module attribute
names follow the JAX parameter tree, so a converted JAX tree loads with
``load_state_dict`` (``tagan_torch.convert``).

``default_matmul_precision("bfloat16")`` is the counterpart of JAX's
context of the same name, which the model enters under
``bf16_matmul``: every contraction that goes through `matmul` or
`einsum` (and so `linear`) then rounds both operands to bfloat16 and
multiplies in float32, the TPU's single-pass bf16 contraction.

Initialisation draws from an explicit ``torch.Generator`` on the CPU:
Xavier/Glorot-uniform weights, constant biases, LayerNorm scale 1 and
shift 0, as the JAX package does. The numbers differ from JAX's for the
same seed, so parity tests load converted weights. Dropout, likewise,
draws from an explicit generator and is off without one.
"""

from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Callable, Iterator, Optional, Sequence

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


_PRECISION = contextvars.ContextVar("tagan_matmul_precision",
                                    default="highest")


@contextlib.contextmanager
def default_matmul_precision(precision: str) -> Iterator[None]:
    """Within the block, `matmul` and `einsum` run at ``precision``:
    "highest" (float32) or "bfloat16" (operands rounded to bf16, float32
    products and sums). JAX's ``jax.default_matmul_precision``."""
    if precision not in ("highest", "bfloat16"):
        raise ValueError(f"unknown matmul precision {precision!r}")
    token = _PRECISION.set(precision)
    try:
        yield
    finally:
        _PRECISION.reset(token)


def bf16_contractions() -> bool:
    """Whether contractions round their operands to bf16 here."""
    return _PRECISION.get() == "bfloat16"


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to the nearest bfloat16 (ties to even), kept in its
    dtype."""
    return x.to(torch.bfloat16).to(x.dtype)


class _Bf16Operand(torch.autograd.Function):
    """A contraction's operand rounded to bf16, its cotangent passed on
    as it is: the cotangent's rounding is `_Bf16Cotangent`'s."""

    @staticmethod
    def forward(ctx, x):
        return round_bf16(x)

    @staticmethod
    def backward(ctx, g):
        return g


class _Bf16Cotangent(torch.autograd.Function):
    """The identity on a contraction's result, whose cotangent is rounded
    to bf16: the backward's products then take bf16 operands too, as the
    transposes of a bf16 ``dot_general`` do under JAX."""

    @staticmethod
    def forward(ctx, y):
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return round_bf16(g)


def _contract(fn, *operands):
    if not bf16_contractions():
        return fn(*operands)
    # a product of two bf16 values is exact in float32 (and in TF32), so
    # the result is the single-pass bf16 contraction up to the order of
    # the sum, on the CPU and on the card alike
    return _Bf16Cotangent.apply(fn(*(_Bf16Operand.apply(t)
                                      for t in operands)))


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` at the current precision (`default_matmul_precision`)."""
    return _contract(torch.matmul, a, b)


def einsum(equation: str, *operands: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` of a contraction at the current precision; only
    for equations that contract an index, as JAX's ``dot_general``."""
    return _contract(lambda *t: torch.einsum(equation, *t), *operands)


def linear(x: torch.Tensor, w: torch.Tensor,
           b: Optional[torch.Tensor] = None) -> torch.Tensor:
    y = matmul(x, w)
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
