"""PyTorch/CUDA port of TAGAN (first slice: the serving path).

Beside ``tagan_tpu`` (the JAX reference), never importing it or JAX.
Entry points run on CUDA unless ``device="cpu"`` is passed."""

from .core.config import TAGANConfig
from .core.graph import (SnapshotSequence, batch_sequences, build_sequence,
                         pad_dims_for)
from .convert import params_from_jax
from .nn.model import TAGAN, batched_forward
from .serve import Predictor

__all__ = ["TAGANConfig", "SnapshotSequence", "batch_sequences",
           "build_sequence", "pad_dims_for", "params_from_jax", "TAGAN",
           "batched_forward", "Predictor"]
