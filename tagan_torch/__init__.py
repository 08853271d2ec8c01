"""PyTorch/CUDA port of TAGAN: serving and training of the dense, csr,
flash and hybrid (band + residual) models, with and without edge
features, every loss family, and attention weights for inspection; host
packing in the port's own C++ packer with the reverse Cuthill-McKee slot
order (``native``); the graph-sharded ring over a mesh of ranks
(``dist``, ``ops.ring_gather``, ``ops.ring_flash``).

Beside ``tagan_tpu`` (the JAX reference), never importing it or JAX.
Entry points run on CUDA unless ``device="cpu"`` is passed."""

from .core.config import ExperimentConfig, TAGANConfig
from .core.graph import (SnapshotSequence, batch_sequences, build_sequence,
                         pad_dims_for)
from .convert import params_from_jax
from .data.dataset import TemporalGraphDataLoader, TemporalGraphDataset
from .nn.heads import (ClassificationModule, MultiTaskPredictionHead,
                       RegressionModule, TemporalClassificationHead,
                       TemporalLossModule, TemporalPredictionHead,
                       asymmetric_focal_loss, pool_temporal, temporal_loss)
from .nn.model import TAGAN, TAGANOutput, batched_forward
from .serve import Predictor
from .train.trainer import TAGANTrainer, cross_validate

__all__ = ["TAGANConfig", "ExperimentConfig", "SnapshotSequence",
           "batch_sequences", "build_sequence", "pad_dims_for",
           "params_from_jax", "TemporalGraphDataset",
           "TemporalGraphDataLoader", "TAGAN", "TAGANOutput",
           "batched_forward", "TemporalPredictionHead",
           "MultiTaskPredictionHead", "TemporalClassificationHead",
           "ClassificationModule", "RegressionModule", "TemporalLossModule",
           "temporal_loss", "asymmetric_focal_loss", "pool_temporal",
           "Predictor", "TAGANTrainer", "cross_validate"]
