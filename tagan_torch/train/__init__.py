from .metrics import (MetricsTracker, calculate_graph_metrics,
                      calculate_metrics, calculate_regression_metrics)
from .trainer import TAGANTrainer, cross_validate, make_optimizer
from .checkpoint import load_checkpoint, save_checkpoint
