"""Batched inference over ragged snapshot sequences.

Counterpart of ``tagan_tpu.serve.Predictor``: sequences in the wire
format are packed into a shape bucket (``dims``), stacked into batches of
``batch_size`` and run through the model with autograd off. PyTorch runs
eagerly, so there is no compile cache and the final batch is not padded.
``StreamingSession``, artifact export and ``from_checkpoint`` are not
ported yet and raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from .core.graph import (SnapshotSequence, batch_sequences, build_sequence,
                         pad_dims_for)
from .nn.model import TAGAN


class Predictor:
    """Probabilities for ragged sequences.

    model:      a `TAGAN` (it holds its weights and device).
    dims:       the bucket ``(max_time, max_nodes, max_edges,
                edge_feature_dim)`` every input is padded into; ``None``
                computes it per call.
    batch_size: sequences per forward.
    dense_adj:  pack the dense adjacency (default: only for the dense
                backend, which needs it).
    """

    def __init__(self, model: TAGAN, *,
                 dims: Optional[Tuple[int, int, int, int]] = None,
                 batch_size: int = 8, dense_adj: Optional[bool] = None):
        self.model = model
        self.dims = dims
        self.batch_size = int(batch_size)
        if dense_adj is None:
            dense_adj = model.config.spatial_backend == "dense"
        self.dense_adj = dense_adj

    @classmethod
    def from_checkpoint(cls, path: str, **kw) -> "Predictor":
        raise NotImplementedError(
            "Predictor.from_checkpoint is not ported yet")

    def _pack(self, sequences) -> List[SnapshotSequence]:
        if isinstance(sequences, SnapshotSequence):
            if not sequences.is_batched:
                return [sequences]
            return [sequences.map(lambda t, i=i: t[i])
                    for i in range(sequences.x.shape[0])]
        T, N, E, Fe = self.dims or pad_dims_for(sequences)
        return [build_sequence(s, max_nodes=N, max_edges=max(E, 1),
                               max_time=T, edge_feature_dim=Fe,
                               dense_adj=self.dense_adj)
                for s in sequences]

    def predict_proba(self, sequences) -> np.ndarray:
        """``[num, 1]`` sigmoid probabilities for binary models,
        ``[num, C]`` softmax for multi-class."""
        seqs = self._pack(sequences)
        probs = []
        with torch.inference_mode():
            for i in range(0, len(seqs), self.batch_size):
                batch = batch_sequences(seqs[i:i + self.batch_size])
                probs.append(self.model(batch).predictions.cpu().numpy())
        return np.concatenate(probs, axis=0).reshape(len(seqs), -1)

    def predict(self, sequences, threshold: float = 0.5) -> np.ndarray:
        """Hard labels: ``proba > threshold`` for binary, argmax for
        multi-class."""
        p = self.predict_proba(sequences)
        if p.shape[-1] == 1:
            return (p[:, 0] > threshold).astype(np.int32)
        return np.argmax(p, axis=-1).astype(np.int32)

    __call__ = predict_proba

    def warmup(self, num_sequences: int = 1) -> None:
        """Run one request of tiny sequences padded to the pinned
        ``dims`` (builds the kernels and initialises the device)."""
        if self.dims is None:
            raise ValueError("warmup needs pinned dims")
        Fe = self.dims[3]
        snap = {"x": np.zeros((2, self.model.config.node_feature_dim),
                              np.float32),
                "edge_index": np.zeros((2, 1), np.int64),
                "edge_attr": np.zeros((1, Fe), np.float32) if Fe else None,
                "node_ids": [0, 1], "timestep": 0.0}
        self.predict_proba([[snap]] * max(num_sequences, 1))


class StreamingSession:
    """Streaming inference with memory carry: not ported yet."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError("StreamingSession is not ported yet")


def export_artifact(*args, **kwargs):
    raise NotImplementedError("serving artifacts are not ported yet")


def load_artifact(*args, **kwargs):
    raise NotImplementedError("serving artifacts are not ported yet")
