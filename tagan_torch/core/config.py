"""Model and experiment configuration for the PyTorch port.

Copies of ``tagan_tpu.core.config.TAGANConfig`` and ``ExperimentConfig``:
field names, defaults, validation and the dict/JSON round trip are
identical to the JAX package's. The port keeps its own copies so that it
never imports the JAX package. Two fields are TPU geometry that the
port does not read:
``flash_block_m``/``flash_block_n`` pick the Pallas kernel's block
shape; the CUDA kernel has its own fixed tile
(``tagan_torch.ops.flash_geometric.BLOCK_M``/``BLOCK_N``).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Optional

VALID_LOSS_TYPES = ("ce", "bce", "mse", "focal", "classification",
                    "multi_class", "multi_label", "regression", "sequence",
                    "huber", "quantile")

VALID_DISTANCE_METRICS = (
    "euclidean", "squared_euclidean", "manhattan", "cosine_similarity",
    "cosine_distance", "dot_product", "scaled_dot_product", "mahalanobis",
    "gaussian_kernel", "rbf_kernel",
)


@dataclass(frozen=True)
class TAGANConfig:
    # Model architecture
    hidden_dim: int = 64
    num_layers: int = 2
    num_heads: int = 4
    temporal_attention_dim: int = 64

    # Feature dimensions
    node_feature_dim: int = 16
    edge_feature_dim: int = 0
    output_dim: int = 2

    # Training parameters
    learning_rate: float = 1e-3
    weight_decay: float = 1e-5
    dropout: float = 0.1
    memory_decay_factor: float = 0.8
    max_inactivity: int = 5
    gradient_clip_val: float = 1.0
    num_epochs: int = 50

    # Architecture options
    use_layer_norm: bool = True
    edge_importance: bool = True
    gru_bias: bool = True
    leaky_relu_slope: float = 0.2
    use_edge_features: bool = False
    concat_heads: bool = True
    learnable_distance: bool = False
    distance_metric: Optional[str] = None  # None -> effective_distance_metric

    # Temporal propagation options
    time_aware: bool = True
    bidirectional: bool = False
    use_skip_connection: bool = True
    use_gating: bool = True
    temporal_window_size: int = 3
    aggregation_method: str = "mean"
    use_residual: bool = True

    # Temporal attention options
    causal_attention: bool = False
    asymmetric_temporal_bias: bool = True
    window_size: int = 5
    future_discount: float = 0.8
    max_relative_position: int = 32
    time_encoding_type: str = "basis"
    use_time_masks: bool = True
    max_time_diff: float = 10.0
    temporal_attention_type: str = "asymmetric"
    num_time_scales: int = 3
    scale_fusion: str = "concat"   # concat | sum | weighted_sum | attention

    # Loss parameters
    loss_type: str = "ce"
    focal_alpha: float = 0.25
    focal_gamma: float = 2.0

    # Head options
    pooling_type: str = "attention"
    head_num_layers: int = 2
    # Node -> graph pooling per timestep: mean | max | attention | logit
    node_pooling: str = "mean"

    # Padded sizes and compute path
    max_nodes: int = 0
    max_edges: int = 0
    spatial_backend: str = "dense"
    compat_mode: str = "intended"
    bf16_matmul: bool = False
    remat: bool = False
    flash_block_m: int = 0
    flash_block_n: int = 0

    def __post_init__(self):
        self.validate()

    def validate(self):
        if self.hidden_dim <= 0:
            raise ValueError(f"hidden_dim must be positive, got {self.hidden_dim}")
        if self.num_layers <= 0:
            raise ValueError(f"num_layers must be positive, got {self.num_layers}")
        if self.num_heads <= 0:
            raise ValueError(f"num_heads must be positive, got {self.num_heads}")
        if self.hidden_dim % self.num_heads != 0:
            raise ValueError("hidden_dim must be divisible by num_heads")
        if self.node_feature_dim <= 0:
            raise ValueError("node_feature_dim must be positive")
        if self.edge_feature_dim < 0:
            raise ValueError("edge_feature_dim must be non-negative")
        if self.output_dim <= 0:
            raise ValueError("output_dim must be positive")
        if self.learning_rate <= 0:
            raise ValueError("learning_rate must be positive")
        if not 0 <= self.dropout < 1:
            raise ValueError("dropout must be in [0, 1)")
        if not 0 < self.memory_decay_factor <= 1:
            raise ValueError("memory_decay_factor must be in (0, 1]")
        if self.max_inactivity <= 0:
            raise ValueError("max_inactivity must be positive")
        if self.loss_type not in VALID_LOSS_TYPES:
            raise ValueError(
                f"loss_type must be one of {VALID_LOSS_TYPES}, got {self.loss_type}")
        if self.distance_metric is not None and \
                self.distance_metric not in VALID_DISTANCE_METRICS:
            raise ValueError(f"unknown distance_metric {self.distance_metric}")
        if self.temporal_attention_type not in ("asymmetric", "standard",
                                                "multi_scale"):
            raise ValueError(
                "temporal_attention_type must be 'asymmetric', 'standard',"
                f" or 'multi_scale', got {self.temporal_attention_type}")
        if self.scale_fusion not in ("concat", "sum", "weighted_sum",
                                     "attention"):
            raise ValueError(f"unknown scale_fusion {self.scale_fusion}")
        if self.spatial_backend not in ("dense", "csr", "flash", "ring",
                                        "hybrid"):
            raise ValueError("spatial_backend must be 'dense', 'csr', "
                             "'flash', 'ring', or 'hybrid'")
        if self.compat_mode not in ("intended", "executed"):
            raise ValueError("compat_mode must be 'intended' or 'executed'")
        if self.node_pooling not in ("mean", "max", "attention",
                                     "logit"):
            raise ValueError("node_pooling must be 'mean', 'max', "
                             "'attention', or 'logit', got "
                             f"{self.node_pooling}")

    @property
    def effective_distance_metric(self) -> str:
        """The geometric metric: the explicit one, else scaled dot
        product when the distance is learnable, else euclidean."""
        if self.distance_metric is not None:
            return self.distance_metric
        return "scaled_dot_product" if self.learnable_distance else "euclidean"

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "TAGANConfig":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})


@dataclass(frozen=True)
class ExperimentConfig:
    """Training-run settings: batching, epochs, early stopping on a
    validation metric, the learning-rate schedule, checkpoints, logging
    and the loader's shuffle and workers."""
    model: TAGANConfig = field(default_factory=TAGANConfig)
    experiment_name: str = "tagan_experiment"
    data_path: str = "data/"
    output_path: str = "outputs/"
    batch_size: int = 16
    num_epochs: int = 50
    num_folds: int = 5                     # folds of `cross_validate`
    seed: int = 42
    eval_every: int = 1
    early_stopping_patience: int = 10
    early_stopping_metric: str = "f1"
    lr_scheduler: Optional[str] = None     # None | 'cosine' | 'plateau' | 'step'
    lr_scheduler_factor: float = 0.5
    lr_scheduler_patience: int = 5
    lr_scheduler_step_size: int = 10       # epochs per 'step' decay
    checkpoint_dir: str = "checkpoints"
    checkpoint_every: int = 0              # 0 = only the best
    log_every: int = 10
    # a timestamped training_<ts>.log and a console handler when set
    log_dir: str = ""
    # training_history.png/json into checkpoint_dir at the end of train()
    plot_history: bool = False
    shuffle: bool = True
    num_workers: int = 0                   # loader prefetch threads
    # the JAX package runs an epoch as one scanned device program; the
    # port runs the same per-step loop either way
    fused_epochs: bool = False

    def __post_init__(self):
        if self.num_folds <= 0:
            raise ValueError(
                f"Number of folds must be positive, got {self.num_folds}")
        if self.batch_size <= 0:
            raise ValueError(
                f"batch_size must be positive, got {self.batch_size}")

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "ExperimentConfig":
        d = dict(d)
        if "model" in d and isinstance(d["model"], dict):
            d["model"] = TAGANConfig.from_dict(d["model"])
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})

    def to_json(self, path: str):
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2)

    @classmethod
    def from_json(cls, path: str) -> "ExperimentConfig":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    def replace(self, **kw) -> "ExperimentConfig":
        return dataclasses.replace(self, **kw)
