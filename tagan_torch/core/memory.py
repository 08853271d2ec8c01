"""Per-node memory state.

Counterpart of ``tagan_tpu.core.memory`` (``MemoryState``,
``init_memory``, ``memory_update``, ``memory_read``): a fixed-size state
over the slot space, updated with masked vector ops. Every array may
carry leading batch dims (one memory per sequence of a batch):

    states      f32[..., N, H]
    valid       bool[..., N]
    last_seen   i32[..., N]     (-1 = never)
    inactivity  i32[..., N]
    frequency   i32[..., N]

The update is the JAX package's, step for step: inactivity ticks on
live slots; NaN states recover from the previous state (else 0.005);
reappearing slots blend ``w*prev + (1-w)*cur`` with
``w = max(0.4, decay^min(gap, 3))``; inactive live slots decay by
``decay^inactivity``; slots past ``max_inactivity`` are pruned.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from .module import resolve_device

# a reappearing slot keeps at least this share of its old state, and the
# gap that sets the share is counted up to this many steps
REAPPEAR_MIN_WEIGHT = 0.4
REAPPEAR_MAX_GAP = 3


@dataclasses.dataclass(frozen=True)
class MemoryState:
    states: torch.Tensor
    valid: torch.Tensor
    last_seen: torch.Tensor
    inactivity: torch.Tensor
    frequency: torch.Tensor

    def where(self, cond: torch.Tensor, other: "MemoryState"
              ) -> "MemoryState":
        """Field-wise ``cond ? self : other``; ``cond`` is bool[...]
        over the leading batch dims."""
        def pick(a, b):
            c = cond.reshape(cond.shape + (1,) * (a.dim() - cond.dim()))
            return torch.where(c, a, b)
        return MemoryState(*(pick(getattr(self, f.name), getattr(other, f.name))
                             for f in dataclasses.fields(self)))


def init_memory(max_nodes: int, hidden_dim: int, *, batch: Tuple[int, ...] = (),
                dtype=torch.float32, device="cuda") -> MemoryState:
    """An empty memory over ``max_nodes`` slots, on ``cuda`` unless
    ``device="cpu"`` is given."""
    lead = tuple(batch)
    device = resolve_device(device)
    return MemoryState(
        states=torch.zeros(lead + (max_nodes, hidden_dim), dtype=dtype,
                           device=device),
        valid=torch.zeros(lead + (max_nodes,), dtype=torch.bool,
                          device=device),
        last_seen=torch.full(lead + (max_nodes,), -1, dtype=torch.int32,
                             device=device),
        inactivity=torch.zeros(lead + (max_nodes,), dtype=torch.int32,
                               device=device),
        frequency=torch.zeros(lead + (max_nodes,), dtype=torch.int32,
                              device=device),
    )


def memory_update(
    mem: MemoryState,
    active: torch.Tensor,        # bool[..., N]
    new_states: torch.Tensor,    # f32[..., N, H]
    timestep: int,
    decay_factor: float = 0.8,
    max_inactivity: int = 5,
) -> MemoryState:
    """One memory update step."""
    t = int(timestep)
    inactivity = torch.where(mem.valid, mem.inactivity + 1, mem.inactivity)

    has_nan = torch.isnan(new_states).any(-1, keepdim=True)
    recovered = torch.where(mem.valid[..., None], mem.states,
                            torch.full_like(new_states, 0.005))
    cur = torch.where(has_nan, recovered, new_states)

    reappearing = mem.valid & (mem.last_seen < t - 1) & active
    gap = torch.clamp(t - mem.last_seen, 0, REAPPEAR_MAX_GAP).to(cur.dtype)
    w = torch.clamp(decay_factor ** gap, min=REAPPEAR_MIN_WEIGHT)[..., None]
    blended = w * mem.states + (1.0 - w) * cur
    written = torch.where(reappearing[..., None], blended, cur)

    states = torch.where(active[..., None], written, mem.states)
    frequency = torch.where(active, mem.frequency + 1, mem.frequency)
    inactivity = torch.where(active, torch.zeros_like(inactivity), inactivity)
    last_seen = torch.where(active, torch.full_like(mem.last_seen, t),
                            mem.last_seen)
    valid = mem.valid | active

    inactive_live = valid & ~active
    d = decay_factor ** inactivity.to(states.dtype)
    states = torch.where(inactive_live[..., None], states * d[..., None],
                         states)

    pruned = inactivity > max_inactivity
    states = torch.where(pruned[..., None], torch.zeros_like(states), states)
    valid = valid & ~pruned
    last_seen = torch.where(pruned, torch.full_like(last_seen, -1), last_seen)
    inactivity = torch.where(pruned, torch.zeros_like(inactivity), inactivity)

    return MemoryState(states=states, valid=valid, last_seen=last_seen,
                       inactivity=inactivity, frequency=frequency)


def memory_read(mem: MemoryState) -> Tuple[torch.Tensor, torch.Tensor]:
    """(states, has_state); missing slots read as zeros."""
    return torch.where(mem.valid[..., None], mem.states,
                       torch.zeros_like(mem.states)), mem.valid
