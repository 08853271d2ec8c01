"""Classification head and loss.

Counterpart of the parts of ``tagan_tpu.nn.heads`` that the model's
forward reaches: ``temporal_loss`` for the classification (BCE with
logits) and multi-class (cross entropy) tasks, ``pool_temporal``, the
MLP builder/apply (here the `MLP` module), ``TemporalClassificationHead``
and the single-task ``ClassificationModule``. The other loss families
and the multi-task head are outside the port's first slice and raise.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..core.module import (LayerNorm, Linear, activation, default_generator,
                           dropout)
from ..ops.masked import masked_max, masked_mean


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor,
                    pos_weight: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """Elementwise, numerically stable BCE with logits."""
    log_p = F.logsigmoid(logits)
    log_not_p = F.logsigmoid(-logits)
    if pos_weight is not None:
        return -(pos_weight * targets * log_p + (1.0 - targets) * log_not_p)
    return -(targets * log_p + (1.0 - targets) * log_not_p)


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  class_weights: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """Per-example cross entropy with integer targets."""
    logp = torch.log_softmax(logits, dim=-1)
    t = targets.long()
    nll = -torch.take_along_dim(logp, t[..., None], dim=-1)[..., 0]
    if class_weights is not None:
        nll = nll * class_weights[t]
    return nll


def temporal_loss(predictions: torch.Tensor, targets: torch.Tensor,
                  task_type: str = "classification", *,
                  reduction: str = "mean",
                  pos_weight: Optional[torch.Tensor] = None,
                  class_weights: Optional[torch.Tensor] = None,
                  time_weights: Optional[torch.Tensor] = None,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The loss family for the tasks the model's forward reaches:
    classification/bce and multi_class/ce. Shapes must already agree."""
    p, t = predictions, targets
    if task_type in ("classification", "bce"):
        loss = bce_with_logits(p, t, pos_weight)
    elif task_type in ("multi_class", "ce"):
        if t.dim() == p.dim() and p.shape[-1] == t.shape[-1]:
            t = t.argmax(-1)          # one-hot -> indices
        loss = cross_entropy(p, t, class_weights)
    else:
        raise NotImplementedError(
            f"loss task {task_type!r} is not ported yet")
    if mask is not None:
        loss = loss * mask
    if time_weights is not None:
        tw = time_weights
        while tw.dim() < loss.dim():
            tw = tw[..., None]
        loss = loss * tw
    if reduction == "mean":
        if mask is not None:
            return loss.sum() / (mask.sum() + 1e-8)
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


class AttentionPool(nn.Module):
    """Attention pooling scorer: w2(tanh(w1 x)). The temporal pool's w2
    has no bias; the model's node pool has one."""

    def __init__(self, hidden_dim: int, score_bias: bool = False, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = default_generator(generator)
        self.w1 = Linear(hidden_dim, hidden_dim, generator=g)
        self.w2 = Linear(hidden_dim, 1, bias=score_bias, generator=g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.w2(torch.tanh(self.w1(x)))


def pool_temporal(pooling_type: str, x: torch.Tensor,
                  mask: Optional[torch.Tensor] = None,
                  attn: Optional[AttentionPool] = None) -> torch.Tensor:
    """Pool [B, T, H] -> [B, H]."""
    if pooling_type == "mean":
        return masked_mean(x, mask, dim=1)
    if pooling_type == "max":
        return masked_max(x, mask, dim=1)
    if pooling_type == "last":
        if mask is not None:
            lengths = torch.clamp(mask.long().sum(1) - 1, min=0)
            return torch.take_along_dim(
                x, lengths[:, None, None].expand(-1, 1, x.shape[-1]),
                dim=1)[:, 0]
        return x[:, -1]
    if pooling_type == "first":
        return x[:, 0]
    if pooling_type == "attention":
        scores = attn(x)                                    # [B, T, 1]
        if mask is not None:
            m = mask[..., None].to(x.dtype)
            scores = scores * m + (1.0 - m) * -1e9
        return (x * torch.softmax(scores, dim=1)).sum(1)
    return x.mean(1)


class MLP(nn.Module):
    """``num_layers`` linears with LayerNorm + activation (+ dropout)
    between them (the JAX package's ``_build_mlp`` / ``_apply_mlp``)."""

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int,
                 num_layers: int, use_layer_norm: bool,
                 act: str = "relu", final_bias_init: float = 0.0, *,
                 dropout: float = 0.1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = default_generator(generator)
        self.num_layers = num_layers
        self.dropout = dropout
        self.use_layer_norm = use_layer_norm
        self.act = activation(act)
        for i in range(num_layers):
            fi = in_dim if i == 0 else hidden_dim
            last = i == num_layers - 1
            fo = out_dim if last else hidden_dim
            setattr(self, f"linear_{i}", Linear(
                fi, fo, bias_init=final_bias_init if last else 0.0,
                generator=g))
            if use_layer_norm and not last:
                setattr(self, f"ln_{i}", LayerNorm(fo))

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        for i in range(self.num_layers):
            x = getattr(self, f"linear_{i}")(x)
            if i < self.num_layers - 1:
                if self.use_layer_norm:
                    x = getattr(self, f"ln_{i}")(x)
                x = dropout(self.act(x), self.dropout, generator)
        return x


class TemporalClassificationHead(nn.Module):
    """Temporal pooling + MLP classifier."""

    def __init__(self, hidden_dim: int, num_classes: int,
                 pooling_type: str = "attention", act: str = "relu",
                 num_layers: int = 2, use_layer_norm: bool = True,
                 multi_label: bool = False, *, dropout: float = 0.1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = default_generator(generator)
        self.pooling_type = pooling_type
        self.num_classes = num_classes
        self.multi_label = multi_label
        self.classifier = MLP(hidden_dim, hidden_dim, num_classes,
                              num_layers, use_layer_norm, act,
                              dropout=dropout, generator=g)
        if pooling_type == "attention":
            self.attention = AttentionPool(hidden_dim, generator=g)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                labels: Optional[torch.Tensor] = None,
                class_weights: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        """x [B, T, H], mask bool[B, T] -> logits [B, C] (and the mean
        loss first when ``labels`` is given); dropout in the classifier
        from ``generator`` when given."""
        pooled = pool_temporal(self.pooling_type, x, mask,
                               getattr(self, "attention", None))
        logits = self.classifier(pooled, generator)
        if labels is None:
            return logits
        if self.multi_label:
            t = labels
            if t.dim() == 1:
                t = F.one_hot(t.long(), self.num_classes).to(logits.dtype)
            loss = bce_with_logits(logits, t, class_weights).mean()
        else:
            loss = cross_entropy(logits, labels, class_weights).mean()
        return loss, logits


class ClassificationModule(TemporalClassificationHead):
    """Single-task facade over `TemporalClassificationHead`."""

    def __init__(self, hidden_dim: int, output_dim: int = 1,
                 task_type: str = "classification",
                 pooling_type: str = "attention", act: str = "relu",
                 num_layers: int = 2, use_layer_norm: bool = True,
                 multi_task: bool = False, *, dropout: float = 0.1,
                 generator: Optional[torch.Generator] = None):
        if multi_task:
            raise NotImplementedError("the multi-task head is not ported yet")
        super().__init__(hidden_dim, output_dim, pooling_type, act,
                         num_layers, use_layer_norm,
                         multi_label=(task_type == "multi_label"),
                         dropout=dropout, generator=generator)
