"""JAX parameters -> the port's module state.

``params_from_jax(tree)`` takes the JAX package's parameter tree (nested
dicts of arrays, e.g. ``TAGAN(cfg).init(key)`` mapped through
``np.asarray``) and returns a flat state dict whose keys are the tree's
paths joined with dots. The port's modules are named after that tree, so
``model.load_state_dict(params_from_jax(tree))`` loads it, and a missing
or extra name fails the strict load. Weights keep the ``[in, out]``
layout on both sides.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def params_from_jax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    flat: Dict[str, torch.Tensor] = {}

    def walk(prefix: str, node: Any) -> None:
        if isinstance(node, dict):
            for key, child in node.items():
                walk(f"{prefix}{key}.", child)
        else:
            flat[prefix[:-1]] = torch.from_numpy(
                np.array(node, dtype=np.float32))

    walk("", tree)
    return flat
