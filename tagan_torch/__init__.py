"""PyTorch/CUDA port of TAGAN: serving and training of the dense and
flash models.

Beside ``tagan_tpu`` (the JAX reference), never importing it or JAX.
Entry points run on CUDA unless ``device="cpu"`` is passed."""

from .core.config import ExperimentConfig, TAGANConfig
from .core.graph import (SnapshotSequence, batch_sequences, build_sequence,
                         pad_dims_for)
from .convert import params_from_jax
from .data.dataset import TemporalGraphDataLoader, TemporalGraphDataset
from .nn.model import TAGAN, batched_forward
from .serve import Predictor
from .train.trainer import TAGANTrainer, cross_validate

__all__ = ["TAGANConfig", "ExperimentConfig", "SnapshotSequence",
           "batch_sequences", "build_sequence", "pad_dims_for",
           "params_from_jax", "TemporalGraphDataset",
           "TemporalGraphDataLoader", "TAGAN", "batched_forward",
           "Predictor", "TAGANTrainer", "cross_validate"]
