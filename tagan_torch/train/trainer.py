"""Training loop of the PyTorch port.

Counterpart of ``tagan_tpu.train.trainer``: ``make_optimizer`` (global-norm
gradient clipping, then AdamW on a cosine or exponential-staircase
learning-rate schedule), ``TAGANTrainer`` (the training step, epochs,
early stopping on a validation metric, reduce-on-plateau, evaluate, test,
predict, checkpoints) and ``cross_validate``.

The optimizer reproduces ``optax.chain(clip_by_global_norm,
adamw(schedule, weight_decay))``: the clip scales the gradients by
``max / |g|`` when ``|g| >= max`` (no epsilon), then ``torch.optim.AdamW``
with optax's defaults (betas 0.9/0.999, eps 1e-8, decay decoupled from
the gradient) takes a step at the scheduled rate of the step count
before the update. The plateau scale multiplies the whole update, as the
JAX trainer scales its updates.

The trainer owns a ``torch.Generator`` on the model's device, seeded from
``experiment.seed``, and draws every dropout mask of the training forward
from it. ``fused_epochs`` runs the same per-step loop (the JAX package
scans an epoch into one device program with identical math).
"""

from __future__ import annotations

import logging
import math
import os
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from ..core.config import ExperimentConfig, TAGANConfig
from ..nn.model import TAGAN
from .checkpoint import load_checkpoint, save_checkpoint
from .metrics import MetricsTracker, calculate_metrics

logger = logging.getLogger("tagan_torch")


def make_schedule(cfg: TAGANConfig, exp: ExperimentConfig,
                  steps_per_epoch: int = 100) -> Callable[[int], float]:
    """The learning rate at a step count: constant, optax's
    ``cosine_decay_schedule`` over ``num_epochs * steps_per_epoch`` steps,
    or its ``exponential_decay`` by ``lr_scheduler_factor`` every
    ``lr_scheduler_step_size`` epochs (staircase)."""
    lr = cfg.learning_rate
    if exp.lr_scheduler == "cosine":
        decay_steps = exp.num_epochs * steps_per_epoch

        def cosine(step: int) -> float:
            frac = min(step, decay_steps) / decay_steps
            return lr * 0.5 * (1.0 + math.cos(math.pi * frac))
        return cosine
    if exp.lr_scheduler == "step":
        every = steps_per_epoch * exp.lr_scheduler_step_size

        def staircase(step: int) -> float:
            return lr * exp.lr_scheduler_factor ** (step // every)
        return staircase
    return lambda step: lr


class Optimizer:
    """Global-norm clip, then AdamW at the scheduled rate (see the module
    docstring). ``step(lr_scale)`` updates the parameters from their
    ``.grad``; a parameter without a gradient counts as a zero gradient,
    as optax sees it (its weight still decays)."""

    def __init__(self, params: Iterable[torch.nn.Parameter],
                 cfg: TAGANConfig, exp: ExperimentConfig,
                 steps_per_epoch: int = 100):
        self.params = [p for p in params if p.requires_grad]
        self.max_norm = cfg.gradient_clip_val
        self.schedule = make_schedule(cfg, exp, steps_per_epoch)
        self.adamw = torch.optim.AdamW(
            self.params, lr=cfg.learning_rate, betas=(0.9, 0.999), eps=1e-8,
            weight_decay=cfg.weight_decay)
        self.count = 0

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def clip(self) -> None:
        """optax.clip_by_global_norm: g * max / |g| where |g| >= max."""
        grads = [p.grad for p in self.params]
        norm = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g) for g in grads]))
        for g in grads:
            g.copy_(torch.where(norm < self.max_norm, g,
                                g / norm * self.max_norm))

    def step(self, lr_scale: float = 1.0) -> None:
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if self.max_norm > 0:
            self.clip()
        for group in self.adamw.param_groups:
            group["lr"] = self.schedule(self.count) * lr_scale
        self.adamw.step()
        self.count += 1

    def state_dict(self) -> dict:
        return {"count": self.count, "adamw": self.adamw.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        self.count = state["count"]
        self.adamw.load_state_dict(state["adamw"])


def make_optimizer(cfg: TAGANConfig, exp: ExperimentConfig,
                   params: Iterable[torch.nn.Parameter],
                   steps_per_epoch: int = 100) -> Optimizer:
    """AdamW with weight decay and global-norm clipping over ``params``."""
    return Optimizer(params, cfg, exp, steps_per_epoch)


class TAGANTrainer:
    """Epoch-driven trainer of a `TAGAN` model (train / evaluate / test /
    predict, checkpoints). The model holds the parameters; batches come
    from a `TemporalGraphDataLoader` as (batch, labels, sample_mask)."""

    def __init__(self, model: TAGAN,
                 experiment: Optional[ExperimentConfig] = None,
                 generator: Optional[torch.Generator] = None):
        self.model = model
        self.config = model.config
        self.device = model.device
        self.experiment = experiment or ExperimentConfig(model=model.config)
        self.log_file: Optional[str] = None
        if self.experiment.log_dir:
            self._setup_logging(self.experiment.log_dir)
        self.generator = generator if generator is not None else \
            torch.Generator(device=self.device).manual_seed(
                self.experiment.seed)
        self.optimizer = make_optimizer(self.config, self.experiment,
                                        model.parameters())
        self.tracker = MetricsTracker(
            primary_metric=self.experiment.early_stopping_metric)
        self.epoch = 0
        self.global_step = 0
        self._plateau_lr_scale = 1.0
        self._plateau_best = -np.inf
        self._plateau_wait = 0

    def _setup_logging(self, log_dir: str):
        """Every `logger` line also goes to
        ``<log_dir>/training_<timestamp>.log`` and the console."""
        os.makedirs(log_dir, exist_ok=True)
        ts = time.strftime("%Y%m%d_%H%M%S")
        self.log_file = os.path.join(log_dir, f"training_{ts}.log")
        fmt = logging.Formatter(
            "%(asctime)s - %(name)s - %(levelname)s - %(message)s")
        fh = logging.FileHandler(self.log_file)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
        if not any(type(h) is logging.StreamHandler
                   for h in logger.handlers):
            ch = logging.StreamHandler()
            ch.setFormatter(fmt)
            logger.addHandler(ch)
        if logger.level > logging.INFO or logger.level == logging.NOTSET:
            logger.setLevel(logging.INFO)

    # -- steps --------------------------------------------------------------
    def _loss(self, batch, labels, mask, train: bool):
        """(mean loss over the real sequences, model output)."""
        out = self.model(batch, labels, deterministic=not train,
                         generator=self.generator if train else None,
                         reduction="none")
        m = mask.to(self.device, out.loss.dtype)
        return (out.loss * m).sum() / torch.clamp(m.sum(), min=1.0), out

    def _train_step(self, batch, labels, mask):
        self.optimizer.zero_grad()
        loss, out = self._loss(batch, labels, mask, True)
        loss.backward()
        self.optimizer.step(self._plateau_lr_scale)
        self.global_step += 1
        return loss.detach(), out.predictions.detach()

    def _run_epoch(self, loader, train: bool
                   ) -> Tuple[float, Dict[str, float]]:
        losses, all_preds, all_labels = [], [], []
        for batch, labels, mask in loader:
            if train:
                loss, preds = self._train_step(batch, labels, mask)
            else:
                with torch.no_grad():
                    loss, out = self._loss(batch, labels, mask, False)
                preds = out.predictions
            m = np.asarray(mask)
            losses.append(float(loss))
            all_preds.append(preds.cpu().numpy()[m])
            all_labels.append(np.asarray(labels)[m])
        preds = np.concatenate(all_preds) if all_preds else np.zeros((0, 1))
        labels = np.concatenate(all_labels) if all_labels else np.zeros((0,))
        if self.config.output_dim == 1:
            metrics = calculate_metrics(preds.reshape(-1), labels,
                                        threshold=0.5)
        else:
            metrics = calculate_metrics(preds, labels)
        return float(np.mean(losses)) if losses else 0.0, metrics

    # -- training -----------------------------------------------------------
    def train(self, train_loader, val_loader=None,
              num_epochs: Optional[int] = None,
              checkpoint_dir: Optional[str] = None,
              verbose: bool = True) -> Dict[str, Any]:
        """Training with early stopping on the validation metric, the
        plateau scale, the best checkpoint and periodic checkpoints."""
        exp = self.experiment
        if exp.plot_history:
            raise NotImplementedError(
                "plot_history needs tagan_torch.viz, which is not ported yet")
        num_epochs = num_epochs or exp.num_epochs
        ckpt_dir = checkpoint_dir or exp.checkpoint_dir
        patience = exp.early_stopping_patience
        best_metric = -np.inf
        best_epoch = -1
        wait = 0
        history: Dict[str, List[float]] = {
            "train_loss": [], "val_loss": [], "train_f1": [], "val_f1": []}

        for epoch in range(num_epochs):
            self.epoch = epoch
            t0 = time.time()
            train_loss, train_metrics = self._run_epoch(train_loader, True)
            self.tracker.update("train", {**train_metrics,
                                          "loss": train_loss})
            history["train_loss"].append(train_loss)
            history["train_f1"].append(train_metrics.get("f1", 0.0))

            val_metrics = {}
            if val_loader is not None:
                val_loss, val_metrics = self._run_epoch(val_loader, False)
                self.tracker.update("val", {**val_metrics, "loss": val_loss})
                history["val_loss"].append(val_loss)
                history["val_f1"].append(val_metrics.get("f1", 0.0))
                monitored = val_metrics.get(exp.early_stopping_metric, 0.0)

                if exp.lr_scheduler == "plateau":
                    if monitored > self._plateau_best + 1e-6:
                        self._plateau_best = monitored
                        self._plateau_wait = 0
                    else:
                        self._plateau_wait += 1
                        if self._plateau_wait >= exp.lr_scheduler_patience:
                            self._plateau_lr_scale *= exp.lr_scheduler_factor
                            self._plateau_wait = 0

                if monitored > best_metric:
                    best_metric = monitored
                    best_epoch = epoch
                    wait = 0
                    if ckpt_dir:
                        self.save_checkpoint(
                            os.path.join(ckpt_dir, "best_model.ckpt"),
                            metrics=val_metrics)
                else:
                    wait += 1
            if verbose:
                msg = (f"epoch {epoch}: train_loss={train_loss:.4f} "
                       f"f1={train_metrics.get('f1', 0):.3f}")
                if val_metrics:
                    msg += (f" val_f1={val_metrics.get('f1', 0):.3f}"
                            f" ({time.time() - t0:.1f}s)")
                logger.info(msg)
            if ckpt_dir and exp.checkpoint_every \
                    and (epoch + 1) % exp.checkpoint_every == 0:
                self.save_checkpoint(
                    os.path.join(ckpt_dir, f"epoch_{epoch}.ckpt"))
            if val_loader is not None and wait >= patience:
                logger.info(f"early stopping at epoch {epoch} "
                            f"(best {exp.early_stopping_metric}="
                            f"{best_metric:.4f} @ {best_epoch})")
                break
        return {"history": history, "best_metric": best_metric,
                "best_epoch": best_epoch, "tracker": self.tracker}

    def evaluate(self, loader) -> Dict[str, float]:
        loss, metrics = self._run_epoch(loader, False)
        return {**metrics, "loss": loss}

    def test(self, loader) -> Dict[str, float]:
        metrics = self.evaluate(loader)
        self.tracker.update("test", metrics)
        return metrics

    @torch.no_grad()
    def predict(self, loader) -> np.ndarray:
        """Predictions of the real sequences, label-free: the loader's
        labels (dummies for an unlabeled dataset) are never read."""
        preds = []
        for item in loader:
            batch, mask = item[0], item[-1]
            p = self.model(batch).predictions
            preds.append(p.cpu().numpy()[np.asarray(mask)])
        return np.concatenate(preds) if preds else np.zeros((0,))

    # -- checkpoints: parameters, optimizer state and configs in one file --
    def save_checkpoint(self, path: str,
                        metrics: Optional[Dict[str, float]] = None):
        save_checkpoint(path, {
            "epoch": self.epoch,
            "global_step": self.global_step,
            "params": self.model.state_dict(),
            "opt_state": self.optimizer.state_dict(),
            "config": self.config.to_dict(),
            "experiment": self.experiment.to_dict(),
            "metrics": metrics or {},
        })

    def load_checkpoint(self, path: str):
        payload = load_checkpoint(path)
        self.model.load_state_dict(payload["params"])
        self.optimizer.load_state_dict(payload["opt_state"])
        self.epoch = payload.get("epoch", 0)
        self.global_step = payload.get("global_step", 0)
        return payload.get("metrics", {})


def cross_validate(model: TAGAN, dataset, experiment: ExperimentConfig,
                   num_epochs: Optional[int] = None,
                   loader_kwargs: Optional[Dict[str, Any]] = None,
                   verbose: bool = False) -> Dict[str, Any]:
    """K-fold cross-validation over a ``TemporalGraphDataset``: each fold
    trains a fresh model of ``model``'s config and device, initialised
    from the fold's seed (``experiment.seed + fold``), on k-1 folds and
    evaluates it on the held-out fold. Every fold's loaders pad to the
    whole dataset's dims.

    Returns {"folds": [per-fold val metrics], "mean": {...}, "std": {...}}.
    """
    from ..data.dataset import TemporalGraphDataLoader, pad_dims_for

    kw = dict(loader_kwargs or {})
    Tm, Nm, Em, Fe = pad_dims_for(dataset.sequences)
    kw.setdefault("max_time", Tm)
    kw.setdefault("max_nodes", Nm)
    kw.setdefault("max_edges", max(Em, 1))
    kw.setdefault("edge_feature_dim", Fe)
    kw.setdefault("batch_size", experiment.batch_size)

    fold_metrics: List[Dict[str, float]] = []
    for f, (train_ds, val_ds) in enumerate(
            dataset.kfold(experiment.num_folds, seed=experiment.seed)):
        exp_f = experiment.replace(seed=experiment.seed + f,
                                   checkpoint_dir="")
        fresh = type(model)(model.config, device=model.device,
                            generator=torch.Generator().manual_seed(
                                exp_f.seed))
        trainer = TAGANTrainer(fresh, exp_f)
        train_loader = TemporalGraphDataLoader(
            train_ds, shuffle=experiment.shuffle, seed=exp_f.seed, **kw)
        val_loader = TemporalGraphDataLoader(val_ds, **kw)
        trainer.train(train_loader, val_loader, num_epochs=num_epochs,
                      checkpoint_dir="", verbose=verbose)
        metrics = trainer.evaluate(val_loader)
        fold_metrics.append(metrics)
        logger.info(f"fold {f}: " + " ".join(
            f"{k}={v:.4f}" for k, v in metrics.items()
            if isinstance(v, float)))

    keys = [k for k, v in fold_metrics[0].items()
            if isinstance(v, (int, float))]
    mean = {k: float(np.mean([m[k] for m in fold_metrics])) for k in keys}
    std = {k: float(np.std([m[k] for m in fold_metrics])) for k in keys}
    return {"folds": fold_metrics, "mean": mean, "std": std}
