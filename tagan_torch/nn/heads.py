"""Prediction heads and loss families.

Counterpart of ``tagan_tpu.nn.heads``: ``temporal_loss`` (BCE with
logits, multi-class cross entropy, multi-label BCE, MSE, sequence MSE,
binary and multi-class focal, Huber and quantile, with an optional
element mask and time weights), ``asymmetric_focal_loss``,
``TemporalLossModule`` (the multi-task loss), ``pool_temporal``, the
MLP (``_build_mlp``/``_apply_mlp`` there, the `MLP` module here),
``TemporalPredictionHead``, ``MultiTaskPredictionHead``,
``TemporalClassificationHead`` (the head the model wires), and the
``ClassificationModule`` and ``RegressionModule`` facades. Module
attribute names follow the JAX parameter tree, so converted weights load
under the strict load.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple, Union

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


def mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.square(pred - target)


def mae(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.abs(pred - target)


def smooth_l1(pred: torch.Tensor, target: torch.Tensor,
              beta: float = 1.0) -> torch.Tensor:
    """Smooth L1 with ``beta`` (Huber scaled by 1 / beta)."""
    d = torch.abs(pred - target)
    return torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta)


def quantile_loss(pred: torch.Tensor, target: torch.Tensor,
                  tau: float = 0.5) -> torch.Tensor:
    diff = target - pred
    return torch.maximum(tau * diff, (tau - 1.0) * diff)


def _focal(p: torch.Tensor, t: torch.Tensor, gamma: float,
           alpha: Optional[float],
           class_weights: Optional[torch.Tensor]) -> torch.Tensor:
    """Elementwise focal loss: binary on [..., 1] or 1-D logits,
    multi-class on [..., C] with index or one-hot/probability targets."""
    if p.dim() == 1 or p.shape[-1] == 1:
        probs = torch.sigmoid(p)
        pos = t == 1
        p_t = torch.where(pos, probs, 1.0 - probs)
        alpha_t = torch.ones_like(p_t) if alpha is None else torch.where(
            pos, p.new_tensor(alpha), p.new_tensor(1.0 - alpha))
        base = bce_with_logits(p, t)
    else:
        probs = torch.softmax(p, dim=-1)
        if t.dim() == p.dim() - 1:
            one_hot = F.one_hot(t.long(), p.shape[-1]).to(p.dtype)
        else:
            one_hot = t.to(p.dtype)
        p_t = (probs * one_hot).sum(-1)
        alpha_t = torch.ones_like(p_t) if alpha is None \
            else torch.full_like(p_t, alpha)
        w = class_weights if class_weights is not None \
            else torch.ones(p.shape[-1], dtype=p.dtype, device=p.device)
        base = -(one_hot * torch.log_softmax(p, dim=-1) * w).sum(-1)
    return alpha_t * torch.pow(1.0 - p_t, gamma) * base


def temporal_loss(predictions: torch.Tensor, targets: torch.Tensor,
                  task_type: str = "classification", *,
                  reduction: str = "mean",
                  pos_weight: Optional[torch.Tensor] = None,
                  class_weights: Optional[torch.Tensor] = None,
                  focal_gamma: float = 2.0,
                  focal_alpha: Optional[float] = None,
                  huber_delta: float = 1.0,
                  quantile_tau: float = 0.5,
                  time_weights: Optional[torch.Tensor] = None,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The loss family by ``task_type``: classification/bce, multi_class/
    ce, multi_label, regression/mse, sequence, focal, huber, quantile;
    any other name takes the MSE. Shapes must already agree (squeeze
    trailing singleton dims first). ``mask`` weights the elements and
    makes the mean a masked mean; ``time_weights`` broadcast from the
    left."""
    p, t = predictions, targets
    if task_type in ("classification", "bce"):
        loss = bce_with_logits(p, t, pos_weight)
    elif task_type in ("multi_class", "ce"):
        if t.dim() == p.dim() and p.shape[-1] == t.shape[-1]:
            t = t.argmax(-1)          # one-hot -> indices
        loss = cross_entropy(p, t, class_weights)
    elif task_type == "multi_label":
        loss = bce_with_logits(p, t)
    elif task_type == "focal":
        loss = _focal(p, t, focal_gamma, focal_alpha, class_weights)
    elif task_type == "huber":
        loss = smooth_l1(p, t, huber_delta)
    elif task_type == "quantile":
        loss = quantile_loss(p, t, quantile_tau)
    else:
        # regression, mse, sequence and any unnamed task
        loss = mse(p, t)
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


def asymmetric_focal_loss(predictions: torch.Tensor, targets: torch.Tensor,
                          gamma_pos: float = 0.0, gamma_neg: float = 4.0,
                          clip: float = 0.05, reduction: str = "mean",
                          eps: float = 1e-8,
                          weights: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Asymmetric focal loss for imbalanced multi-label classification:
    probabilities clipped to [clip, 1 - clip], positives weighted by
    (1 - p)^gamma_pos and negatives by p^gamma_neg; ``weights`` per
    example."""
    probs = torch.sigmoid(predictions)
    if clip > 0:
        probs = probs.clamp(clip, 1.0 - clip)
    pos = (targets == 1).to(probs.dtype)
    neg = (targets == 0).to(probs.dtype)
    loss = -(pos * torch.pow(1.0 - probs, gamma_pos) * torch.log(probs + eps)
             + neg * torch.pow(probs, gamma_neg)
             * torch.log(1.0 - probs + eps))
    if weights is not None:
        loss = loss * weights[..., None]
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


def _frozen(configs: Dict[str, Dict[str, Any]]
            ) -> Tuple[Tuple[str, Tuple[Tuple[str, Any], ...]], ...]:
    """Task configs as sorted (name, sorted items) tuples: the JAX
    package's hashable form, and the order its heads are built in."""
    return tuple(sorted((n, tuple(sorted(c.items())))
                        for n, c in configs.items()))


@dataclasses.dataclass(frozen=True)
class TemporalLossModule:
    """Multi-task loss: ``task_configs`` maps a task name to its
    ``task_type``, optional loss parameters and ``loss_weight``; the
    combined loss is the weighted sum of the tasks' losses."""
    task_configs: Tuple[Tuple[str, Tuple[Tuple[str, Any], ...]], ...]
    default_task_type: str = "classification"
    default_reduction: str = "mean"
    focal_alpha: Optional[float] = None
    focal_gamma: float = 2.0
    huber_delta: float = 1.0
    quantile_tau: float = 0.5

    @classmethod
    def create(cls, task_configs: Dict[str, Dict[str, Any]],
               loss_config: Optional[Dict[str, Any]] = None,
               default_task_type: str = "classification",
               default_reduction: str = "mean") -> "TemporalLossModule":
        lc = loss_config or {}
        return cls(task_configs=_frozen(task_configs),
                   default_task_type=default_task_type,
                   default_reduction=lc.get("reduction", default_reduction),
                   focal_alpha=lc.get("focal_alpha"),
                   focal_gamma=lc.get("focal_gamma", 2.0),
                   huber_delta=lc.get("huber_delta", 1.0),
                   quantile_tau=lc.get("quantile_tau", 0.5))

    def _cfg(self, name: str) -> Dict[str, Any]:
        return dict(dict(self.task_configs).get(name, ()))

    def __call__(self, predictions: Union[torch.Tensor,
                                          Dict[str, torch.Tensor]],
                 targets: Union[torch.Tensor, Dict[str, torch.Tensor]],
                 return_task_losses: bool = False):
        if isinstance(predictions, dict) and isinstance(targets, dict):
            task_losses = {}
            for name, pred in predictions.items():
                if name not in targets:
                    continue
                cfg = self._cfg(name)
                loss = temporal_loss(
                    pred, targets[name],
                    task_type=cfg.get("task_type", self.default_task_type),
                    reduction=cfg.get("reduction", self.default_reduction),
                    focal_gamma=cfg.get("focal_gamma", self.focal_gamma),
                    focal_alpha=cfg.get("focal_alpha", self.focal_alpha),
                    huber_delta=cfg.get("huber_delta", self.huber_delta),
                    quantile_tau=cfg.get("quantile_tau", self.quantile_tau))
                task_losses[name] = cfg.get("loss_weight", 1.0) * loss
        else:
            task_losses = {"default": temporal_loss(
                predictions, targets, task_type=self.default_task_type,
                reduction=self.default_reduction)}
        combined = sum(task_losses.values())
        if return_task_losses:
            return combined, task_losses
        return combined


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


class TemporalPredictionHead(MLP):
    """MLP prediction head; the sigmoid of its output for the
    classification and multi_label tasks. A binary classification head
    starts its final bias at 0.5."""

    def __init__(self, hidden_dim: int, output_dim: int,
                 task_type: str = "classification", num_layers: int = 2,
                 act: str = "relu", use_layer_norm: bool = True, *,
                 dropout: float = 0.1,
                 generator: Optional[torch.Generator] = None):
        fb = 0.5 if task_type == "classification" and output_dim == 1 \
            else 0.0
        super().__init__(hidden_dim, hidden_dim, output_dim, num_layers,
                         use_layer_norm, act, final_bias_init=fb,
                         dropout=dropout, generator=generator)
        self.task_type = task_type

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        y = super().forward(x, generator)
        if self.task_type in ("classification", "multi_label"):
            y = torch.sigmoid(y)
        return y


class TemporalClassificationHead(nn.Module):
    """Temporal pooling + MLP classifier (the JAX tree ``classifier``,
    ``attention``)."""

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


class MultiTaskPredictionHead(nn.Module):
    """Shared trunk (``shared_layers`` of linear, LayerNorm, activation,
    dropout) + one `TemporalPredictionHead` per task (the JAX tree
    ``shared`` {linear_i, ln_i}, ``heads`` {task: ...}); ``task_configs``
    maps a task name to its ``output_dim``, ``task_type`` and
    ``num_layers`` (defaults 1, classification, 1)."""

    def __init__(self, hidden_dim: int,
                 task_configs: Dict[str, Dict[str, Any]],
                 shared_layers: int = 1, act: str = "relu",
                 use_layer_norm: bool = True, *, dropout: float = 0.1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = default_generator(generator)
        self.task_configs = _frozen(task_configs)
        self.dropout = dropout
        self.act = activation(act)
        self.use_layer_norm = use_layer_norm
        self.shared_layers = shared_layers
        shared = {}
        for i in range(shared_layers):
            shared[f"linear_{i}"] = Linear(hidden_dim, hidden_dim,
                                           generator=g)
            if use_layer_norm:
                shared[f"ln_{i}"] = LayerNorm(hidden_dim)
        self.shared = nn.ModuleDict(shared)
        self.heads = nn.ModuleDict({
            name: TemporalPredictionHead(
                hidden_dim, c.get("output_dim", 1),
                c.get("task_type", "classification"), c.get("num_layers", 1),
                act, use_layer_norm, dropout=dropout, generator=g)
            for name, c in ((n, dict(items))
                            for n, items in self.task_configs)})

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        h = x
        for i in range(self.shared_layers):
            h = self.shared[f"linear_{i}"](h)
            if self.use_layer_norm:
                h = self.shared[f"ln_{i}"](h)
            h = dropout(self.act(h), self.dropout, generator)
        return {name: head(h, generator) for name, head in self.heads.items()}


class MultiTaskClassificationHead(MultiTaskPredictionHead):
    """`MultiTaskPredictionHead` with the classification facade's call
    and its multi-task loss."""

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                labels=None, class_weights: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        """The heads' predictions {task: [..., out]} on ``x`` as it is
        (``mask`` and ``class_weights`` unused), and with a ``labels``
        dict the sum of the tasks' mean losses first: probability-space
        BCE (clipped to [1e-7, 1 - 1e-7]) for the classification and
        multi_label tasks, whose heads already applied the sigmoid, cross
        entropy for multi_class, MSE else."""
        preds = super().forward(x, generator)
        if not isinstance(labels, dict):
            return preds
        cfgs = dict(self.task_configs)
        losses = {}
        for name, pr in preds.items():
            if name not in labels:
                continue
            t = labels[name]
            kind = dict(cfgs[name]).get("task_type", "classification")
            if kind in ("classification", "multi_label"):
                pc = pr.clamp(1e-7, 1.0 - 1e-7)
                losses[name] = (-(t * torch.log(pc)
                                  + (1.0 - t) * torch.log1p(-pc))).mean()
            elif kind == "multi_class":
                losses[name] = cross_entropy(pr, t).mean()
            else:
                losses[name] = mse(pr, t).mean()
        if losses:
            return sum(losses.values()), preds
        return preds


def ClassificationModule(hidden_dim: int, output_dim: int = 1,
                         task_type: str = "classification",
                         pooling_type: str = "attention", act: str = "relu",
                         num_layers: int = 2, use_layer_norm: bool = True,
                         multi_task: bool = False,
                         task_configs: Optional[Dict[str, Dict[str, Any]]]
                         = None, *, dropout: float = 0.1,
                         generator: Optional[torch.Generator] = None
                         ) -> nn.Module:
    """The classification facade: one task -> a
    `TemporalClassificationHead` (``classifier``, ``attention``),
    ``multi_task`` -> a `MultiTaskClassificationHead` over
    ``task_configs`` with one shared layer (``shared``, ``heads``), as the
    JAX facade's parameters are its inner head's tree."""
    if multi_task:
        if task_configs is None:
            raise ValueError("multi_task=True needs task_configs")
        return MultiTaskClassificationHead(
            hidden_dim, task_configs, 1, act, use_layer_norm,
            dropout=dropout, generator=generator)
    return TemporalClassificationHead(
        hidden_dim, output_dim, pooling_type, act, num_layers,
        use_layer_norm, multi_label=(task_type == "multi_label"),
        dropout=dropout, generator=generator)


class RegressionModule(nn.Module):
    """Temporal pooling + MLP regressor (the JAX tree ``regressor``,
    ``attention``); with ``targets`` the mean loss by ``loss_type``
    (mae, huber with ``huber_delta``, else mse) first."""

    def __init__(self, hidden_dim: int, output_dim: int = 1,
                 pooling_type: str = "attention", act: str = "relu",
                 num_layers: int = 2, use_layer_norm: bool = True,
                 loss_type: str = "mse", huber_delta: float = 1.0, *,
                 dropout: float = 0.1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = default_generator(generator)
        self.pooling_type = pooling_type
        self.loss_type = loss_type
        self.huber_delta = huber_delta
        self.regressor = MLP(hidden_dim, hidden_dim, output_dim, num_layers,
                             use_layer_norm, act, dropout=dropout,
                             generator=g)
        if pooling_type == "attention":
            self.attention = AttentionPool(hidden_dim, generator=g)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                targets: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        pooled = pool_temporal(self.pooling_type, x, mask,
                               getattr(self, "attention", None))
        preds = self.regressor(pooled, generator)
        if targets is None:
            return preds
        if self.loss_type == "mae":
            loss = mae(preds, targets).mean()
        elif self.loss_type == "huber":
            loss = smooth_l1(preds, targets, self.huber_delta).mean()
        else:
            loss = mse(preds, targets).mean()
        return loss, preds
