"""Evaluation metrics (numpy only).

A copy of ``tagan_tpu.train.metrics``, which the port keeps so that it
never imports the JAX package:

* ``calculate_metrics``: accuracy, precision, recall, F1 (binary at a
  threshold, macro for multi-class), ROC-AUC, average precision,
  confusion counts, specificity.
* ``calculate_regression_metrics``: mse/rmse/mae/mape/r2.
* ``calculate_graph_metrics``: density and degree statistics.
* ``MetricsTracker``: per-split history and best tracking.

ROC-AUC and AP use the standard rank-based formulations, matching
sklearn on untied inputs.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np


def _to_np(x) -> np.ndarray:
    return np.asarray(x)


def binary_counts(preds: np.ndarray, labels: np.ndarray):
    tp = int(np.sum((preds == 1) & (labels == 1)))
    tn = int(np.sum((preds == 0) & (labels == 0)))
    fp = int(np.sum((preds == 1) & (labels == 0)))
    fn = int(np.sum((preds == 0) & (labels == 1)))
    return tp, tn, fp, fn


def roc_auc(scores: np.ndarray, labels: np.ndarray) -> float:
    """Rank-based AUC (equivalent to the trapezoidal ROC integral)."""
    pos = scores[labels == 1]
    neg = scores[labels == 0]
    if len(pos) == 0 or len(neg) == 0:
        return float("nan")
    order = np.argsort(np.concatenate([pos, neg]))
    ranks = np.empty_like(order, dtype=np.float64)
    ranks[order] = np.arange(1, len(order) + 1)
    # average ranks for ties
    allv = np.concatenate([pos, neg])
    sorted_v = allv[order]
    i = 0
    while i < len(sorted_v):
        j = i
        while j + 1 < len(sorted_v) and sorted_v[j + 1] == sorted_v[i]:
            j += 1
        if j > i:
            avg = (i + j) / 2.0 + 1.0
            ranks[order[i:j + 1]] = avg
        i = j + 1
    r_pos = np.sum(ranks[: len(pos)])
    n_p, n_n = len(pos), len(neg)
    return float((r_pos - n_p * (n_p + 1) / 2.0) / (n_p * n_n))


def average_precision(scores: np.ndarray, labels: np.ndarray) -> float:
    if labels.sum() == 0:
        return float("nan")
    order = np.argsort(-scores, kind="stable")
    l_sorted = labels[order]
    cum_tp = np.cumsum(l_sorted)
    precision = cum_tp / np.arange(1, len(l_sorted) + 1)
    return float(np.sum(precision * l_sorted) / labels.sum())


def calculate_metrics(
    predictions, labels, *, probabilities=None, threshold: float = 0.5,
) -> Dict[str, float]:
    """Binary or multi-class classification metrics.

    predictions: probabilities/scores (binary) or class-probability rows /
    class indices (multi-class). labels: ints.
    """
    preds = _to_np(predictions)
    labels = _to_np(labels)
    out: Dict[str, float] = {}

    multi_class = preds.ndim > 1 and preds.shape[-1] > 1
    if multi_class:
        probs = preds
        hard = np.argmax(preds, axis=-1)
        labels = labels.astype(np.int64).reshape(-1)
        n_classes = preds.shape[-1]
        out["accuracy"] = float(np.mean(hard == labels))
        precs, recs, f1s = [], [], []
        for c in range(n_classes):
            tp = np.sum((hard == c) & (labels == c))
            fp = np.sum((hard == c) & (labels != c))
            fn = np.sum((hard != c) & (labels == c))
            p = tp / (tp + fp) if tp + fp > 0 else 0.0
            r = tp / (tp + fn) if tp + fn > 0 else 0.0
            f = 2 * p * r / (p + r) if p + r > 0 else 0.0
            precs.append(p); recs.append(r); f1s.append(f)
        out["precision"] = float(np.mean(precs))
        out["recall"] = float(np.mean(recs))
        out["f1"] = float(np.mean(f1s))
        return out

    scores = _to_np(probabilities) if probabilities is not None else preds
    scores = scores.reshape(-1).astype(np.float64)
    labels = labels.reshape(-1).astype(np.int64)
    hard = (scores > threshold).astype(np.int64) \
        if scores.dtype != np.int64 or probabilities is not None \
        else preds.reshape(-1).astype(np.int64)
    # if predictions were already hard labels (0/1 values only) keep them
    uniq = np.unique(preds.reshape(-1))
    if np.all(np.isin(uniq, [0, 1])) and probabilities is None \
            and len(uniq) <= 2:
        hard = preds.reshape(-1).astype(np.int64)

    tp, tn, fp, fn = binary_counts(hard, labels)
    total = max(tp + tn + fp + fn, 1)
    out["accuracy"] = (tp + tn) / total
    out["precision"] = tp / (tp + fp) if tp + fp > 0 else 0.0
    out["recall"] = tp / (tp + fn) if tp + fn > 0 else 0.0
    pr = out["precision"] + out["recall"]
    out["f1"] = 2 * out["precision"] * out["recall"] / pr if pr > 0 else 0.0
    out["specificity"] = tn / (tn + fp) if tn + fp > 0 else 0.0
    out["true_positives"] = tp
    out["true_negatives"] = tn
    out["false_positives"] = fp
    out["false_negatives"] = fn
    if len(np.unique(labels)) > 1:
        out["roc_auc"] = roc_auc(scores, labels)
        out["average_precision"] = average_precision(scores, labels)
    return out


def calculate_regression_metrics(predictions, targets) -> Dict[str, float]:
    """mse/rmse/mae/mape/r2."""
    p = _to_np(predictions).reshape(-1).astype(np.float64)
    t = _to_np(targets).reshape(-1).astype(np.float64)
    mse = float(np.mean((p - t) ** 2))
    mae = float(np.mean(np.abs(p - t)))
    nz = np.abs(t) > 1e-8
    mape = float(np.mean(np.abs((t[nz] - p[nz]) / t[nz])) * 100) \
        if nz.any() else float("nan")
    ss_res = np.sum((t - p) ** 2)
    ss_tot = np.sum((t - np.mean(t)) ** 2)
    r2 = float(1.0 - ss_res / ss_tot) if ss_tot > 0 else float("nan")
    return {"mse": mse, "rmse": float(np.sqrt(mse)), "mae": mae,
            "mape": mape, "r2": r2}


def calculate_graph_metrics(num_nodes: int, edge_index) -> Dict[str, float]:
    """density/degree stats."""
    ei = _to_np(edge_index)
    num_edges = ei.shape[1] if ei.ndim == 2 else 0
    possible = num_nodes * (num_nodes - 1)
    density = num_edges / possible if possible > 0 else 0.0
    deg = np.zeros(num_nodes)
    if num_edges:
        np.add.at(deg, ei[0], 1)
    return {"num_nodes": num_nodes, "num_edges": num_edges,
            "density": density,
            "avg_degree": float(deg.mean()) if num_nodes else 0.0,
            "max_degree": float(deg.max()) if num_nodes else 0.0}


class MetricsTracker:
    """Per-split metric history + best tracking."""

    def __init__(self, splits: Sequence[str] = ("train", "val", "test"),
                 primary_metric: str = "f1", mode: str = "max"):
        self.history: Dict[str, List[Dict[str, float]]] = {
            s: [] for s in splits}
        self.primary_metric = primary_metric
        self.mode = mode

    def update(self, split: str, metrics: Dict[str, float]):
        self.history.setdefault(split, []).append(dict(metrics))

    def best(self, split: str = "val") -> Optional[Dict[str, float]]:
        hist = [m for m in self.history.get(split, [])
                if self.primary_metric in m]
        if not hist:
            return None
        key = (max if self.mode == "max" else min)
        return key(hist, key=lambda m: m[self.primary_metric])

    def best_epoch(self, split: str = "val") -> int:
        hist = self.history.get(split, [])
        vals = [m.get(self.primary_metric,
                      -np.inf if self.mode == "max" else np.inf)
                for m in hist]
        if not vals:
            return -1
        return int(np.argmax(vals) if self.mode == "max"
                   else np.argmin(vals))

    def latest(self, split: str) -> Optional[Dict[str, float]]:
        hist = self.history.get(split, [])
        return hist[-1] if hist else None

    def plot_metrics(self, metrics: Optional[Sequence[str]] = None,
                     save_path: Optional[str] = None):
        """Per-split metric curves: needs the plotting module, which is
        not ported yet."""
        raise NotImplementedError(
            "MetricsTracker.plot_metrics needs tagan_torch.viz, which is "
            "not ported yet")
