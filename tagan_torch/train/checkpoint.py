"""Checkpoints: one file per payload (the trainer's holds the parameters,
the optimizer state and the configs).

Counterpart of ``tagan_tpu.train.checkpoint`` with its ``pickle``
backend. Payloads are dicts of torch state dicts, tensors, config dicts
and scalars, written with ``torch.save`` and loaded onto the CPU, so a
checkpoint written on the card loads on a machine without one. Load only
checkpoints this program wrote: loading unpickles. The ``orbax`` backend
of the JAX package is not ported.
"""

from __future__ import annotations

import os
from typing import Any, Dict

import torch


def _check_backend(backend: str) -> None:
    if backend == "orbax":
        raise NotImplementedError(
            "the orbax checkpoint backend is not ported; use 'pickle'")
    if backend != "pickle":
        raise ValueError(f"unknown checkpoint backend {backend}")


def save_checkpoint(path: str, payload: Dict[str, Any],
                    backend: str = "pickle") -> None:
    """Write ``payload`` (state dicts, tensors, config dicts, scalars) to
    the single file ``path``."""
    _check_backend(backend)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save(payload, path)


def load_checkpoint(path: str, backend: str = "pickle") -> Dict[str, Any]:
    """The payload written by `save_checkpoint`, tensors on the CPU."""
    _check_backend(backend)
    return torch.load(path, map_location="cpu", weights_only=False)
