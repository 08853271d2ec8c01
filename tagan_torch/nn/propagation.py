"""Temporal propagation: GRU evolution, window skips, gating, memory.

Counterpart of ``tagan_tpu.nn.propagation`` (``TemporalGRUCell``,
``TemporalEvolutionLayer``, ``TemporalSkipConnection``,
``TemporalGatingUnit``, ``TemporalPropagation``). The JAX package scans
over time with ``lax.scan`` on one sequence; here the same steps run in
a Python loop over T on a batch of sequences at once:

    x_seq      [B, T, N, F]     node features per sequence and step
    node_mask  bool[B, T, N]
    time_stamps [B, T], time_mask bool[B, T]

Dropout (the cell's new state, the evolution and skip projections, the
gate output and the propagation output) runs when a ``torch.Generator``
is passed and never otherwise.

The cell runs per node only on its active steps (inactive steps carry
the state and emit zeros), which also keeps LayerNorm off all-zero rows.
The memory pass gates reappearing nodes with bias
``max(0.5, 0.9 - 0.1 min(gap, 4))`` and continuing nodes with 0.6, and
padded steps leave the memory untouched.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from ..core import module as M
from ..core.memory import MemoryState, init_memory, memory_read, memory_update
from ..core.module import (LayerNorm, Linear, default_generator, dropout,
                           gelu_exact)


class TemporalGRUCell(nn.Module):
    def __init__(self, input_dim: int, hidden_dim: int,
                 use_layer_norm: bool = True, *, dropout: float = 0.1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = default_generator(generator)
        self.hidden_dim = hidden_dim
        self.use_layer_norm = use_layer_norm
        self.dropout = dropout
        d = input_dim + hidden_dim
        # gate biases start at 1.0
        self.reset = Linear(d, hidden_dim, bias_init=1.0, generator=g)
        self.update = Linear(d, hidden_dim, bias_init=1.0, generator=g)
        self.candidate = Linear(d, hidden_dim, generator=g)
        if use_layer_norm:
            self.ln_x = LayerNorm(input_dim)
            self.ln_h = LayerNorm(hidden_dim)
            self.ln_out = LayerNorm(hidden_dim)

    def forward(self, x: torch.Tensor, h: Optional[torch.Tensor] = None,
                time_diff: Optional[torch.Tensor] = None, *,
                h_is_initial: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        """One GRU step; ``h_is_initial`` marks a state that must not be
        layer-normalised (the zero initial state)."""
        if self.use_layer_norm:
            x = self.ln_x(x)
        if h is None:
            h = x.new_zeros(*x.shape[:-1], self.hidden_dim)
        elif self.use_layer_norm and not h_is_initial:
            h = self.ln_h(h)
        if time_diff is not None:
            h = h * torch.exp(-torch.clamp(time_diff, 0.0, 10.0))[..., None]
        xh = torch.cat([x, h], dim=-1)
        r = torch.sigmoid(self.reset(xh))
        z = torch.sigmoid(self.update(xh))
        h_tilde = torch.tanh(self.candidate(torch.cat([x, r * h], dim=-1)))
        h_new = dropout((1.0 - z) * h + z * h_tilde, self.dropout, generator)
        return self.ln_out(h_new) if self.use_layer_norm else h_new


class TemporalEvolutionLayer(nn.Module):
    def __init__(self, input_dim: int, hidden_dim: int,
                 time_aware: bool = True, bidirectional: bool = False,
                 use_layer_norm: bool = True, residual: bool = True, *,
                 dropout: float = 0.1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = default_generator(generator)
        self.input_dim, self.hidden_dim = input_dim, hidden_dim
        self.dropout = dropout
        self.time_aware = time_aware
        self.bidirectional = bidirectional
        self.use_layer_norm = use_layer_norm
        self.residual = residual
        cell_dim = hidden_dim // 2 if bidirectional else hidden_dim
        self.forward_cell = TemporalGRUCell(input_dim, cell_dim,
                                            use_layer_norm, dropout=dropout,
                                            generator=g)
        if bidirectional:
            self.backward_cell = TemporalGRUCell(input_dim, cell_dim,
                                                 use_layer_norm,
                                                 dropout=dropout,
                                                 generator=g)
            self.proj = Linear(hidden_dim, hidden_dim, generator=g)
        else:
            self.proj = Linear(cell_dim, hidden_dim, generator=g)
        if use_layer_norm:
            self.ln = LayerNorm(hidden_dim)

    @staticmethod
    def _scan_cell(cell: TemporalGRUCell, xs, tds, valid, generator):
        """Run the cell over the time axis of xs [B, T, N, F]; tds
        [B, T, N] are per-step time diffs, valid bool[B, T, N]. A node's
        first valid step starts from the un-normalised zero state."""
        B, T, N, _ = xs.shape
        h = xs.new_zeros(B, N, cell.hidden_dim)
        started = torch.zeros(B, N, dtype=torch.bool, device=xs.device)
        outs = []
        for t in range(T):
            h_prev = cell.ln_h(h) if cell.use_layer_norm else h
            h_in = torch.where(started[..., None], h_prev,
                               torch.zeros_like(h))
            h_new = cell(xs[:, t], h_in, tds[:, t], h_is_initial=True,
                         generator=generator)
            v_t = valid[:, t, :, None]
            h = torch.where(v_t, h_new, h)
            outs.append(torch.where(v_t, h_new, torch.zeros_like(h_new)))
            started = started | valid[:, t]
        return torch.stack(outs, dim=1)

    def forward(self, x_seq: torch.Tensor,
                time_stamps: Optional[torch.Tensor] = None,
                time_mask: Optional[torch.Tensor] = None,
                node_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        B, T, N, _ = x_seq.shape
        if time_stamps is not None and self.time_aware:
            td = torch.cat([x_seq.new_zeros(B, 1),
                            time_stamps[:, 1:] - time_stamps[:, :-1]], dim=1)
        else:
            td = x_seq.new_zeros(B, T)
        tds = td[:, :, None].expand(B, T, N)

        valid = node_mask
        if time_mask is not None:
            tm = time_mask[:, :, None]
            valid = tm.expand(B, T, N) if valid is None else valid & tm
        run_valid = valid if valid is not None else torch.ones(
            B, T, N, dtype=torch.bool, device=x_seq.device)

        h = self._scan_cell(self.forward_cell, x_seq, tds, run_valid,
                            generator)
        if self.bidirectional:
            if time_stamps is not None and self.time_aware:
                tdb = torch.cat([time_stamps[:, 1:] - time_stamps[:, :-1],
                                 x_seq.new_zeros(B, 1)], dim=1)
            else:
                tdb = x_seq.new_zeros(B, T)
            tdsb = tdb[:, :, None].expand(B, T, N)
            bwd = self._scan_cell(self.backward_cell, x_seq.flip(1),
                                  tdsb.flip(1), run_valid.flip(1),
                                  generator).flip(1)
            h = torch.cat([h, bwd], dim=-1)

        out = dropout(self.proj(h), self.dropout, generator)
        if self.residual and self.input_dim == self.hidden_dim:
            out = out + x_seq
        if self.use_layer_norm:
            out = self.ln(out)
        if valid is not None:
            out = torch.where(valid[..., None], out, torch.zeros_like(out))
        return out


class TemporalSkipConnection(nn.Module):
    def __init__(self, input_dim: int, hidden_dim: Optional[int] = None,
                 window_size: int = 3, aggregation: str = "mean",
                 use_layer_norm: bool = True, apply_activation: bool = True,
                 residual: bool = True, *, dropout: float = 0.1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = default_generator(generator)
        h_dim = hidden_dim if hidden_dim is not None else input_dim
        self.dropout = dropout
        self.window_size = window_size
        self.aggregation = aggregation
        self.use_layer_norm = use_layer_norm
        self.apply_activation = apply_activation
        self.residual = residual
        self.in_proj = Linear(input_dim, h_dim, generator=g)
        self.out_proj = Linear(h_dim, input_dim, generator=g)
        if use_layer_norm:
            self.ln1 = LayerNorm(h_dim)
            self.ln2 = LayerNorm(input_dim)

    def _band(self, T: int, time_mask: Optional[torch.Tensor], device):
        """bool[T, T] (or [B, T, T] with a time mask): row t covers the
        valid steps within the window around t."""
        idx = torch.arange(T, device=device)
        band = (idx[:, None] - idx[None, :]).abs() <= self.window_size
        if time_mask is not None:
            band = band & time_mask[:, None, :]
        return band

    def forward(self, x_seq: torch.Tensor,
                time_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        """x_seq [B, T, N, F], time_mask bool[B, T]."""
        B, T = x_seq.shape[:2]
        proj = self.in_proj(x_seq)
        if self.apply_activation:
            proj = gelu_exact(proj)
        if self.use_layer_norm:
            proj = self.ln1(proj)
        proj = dropout(proj, self.dropout, generator)
        band = self._band(T, time_mask, x_seq.device).expand(B, T, T)
        if self.aggregation == "max":
            expanded = torch.where(band[:, :, :, None, None],
                                   proj[:, None], torch.full_like(
                                       proj[:, None], -1e30))
            agg = expanded.amax(dim=2)
        else:   # mean or sum through the banded [T, T] operator
            op = band.to(proj.dtype)
            if self.aggregation == "mean":
                op = op / torch.clamp(op.sum(-1, keepdim=True), min=1.0)
            agg = M.einsum("bts,bsnh->btnh", op, proj)
        out = dropout(self.out_proj(gelu_exact(agg)), self.dropout,
                      generator)
        if self.residual:
            out = out + x_seq
        return self.ln2(out) if self.use_layer_norm else out


class TemporalGatingUnit(nn.Module):
    def __init__(self, input_dim: int, use_layer_norm: bool = True,
                 residual: bool = True, *, dropout: float = 0.1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = default_generator(generator)
        d = input_dim
        self.dropout = dropout
        self.use_layer_norm = use_layer_norm
        self.residual = residual
        self.update_gate = Linear(2 * d, d, generator=g)
        self.reset_gate = Linear(2 * d, d, generator=g)
        self.output_gate = Linear(2 * d, d, generator=g)
        if use_layer_norm:
            self.ln_in1 = LayerNorm(d)
            self.ln_in2 = LayerNorm(d)
            self.ln_out = LayerNorm(d)

    def forward(self, current_feat: torch.Tensor,
                previous_feat: torch.Tensor,
                memory_bias: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        """GRU-style merge of current features with memory;
        ``memory_bias`` in (0, 1) (per node) adds logit(bias) to the
        update gate, 0.5 being neutral."""
        if self.use_layer_norm:
            current_feat = self.ln_in1(current_feat)
            previous_feat = self.ln_in2(previous_feat)
        combined = torch.cat([current_feat, previous_feat], dim=-1)
        update_logits = self.update_gate(combined)
        if memory_bias is not None:
            b = torch.clamp(torch.as_tensor(memory_bias,
                                            dtype=update_logits.dtype,
                                            device=update_logits.device),
                            1e-4, 1.0 - 1e-4)
            logit = torch.log(b) - torch.log1p(-b)
            update_logits = update_logits + logit.reshape(
                logit.shape + (1,) * (update_logits.dim() - logit.dim()))
        update = torch.sigmoid(update_logits)
        reset = torch.sigmoid(self.reset_gate(combined))
        candidate = torch.tanh(self.output_gate(
            torch.cat([current_feat, reset * previous_feat], dim=-1)))
        output = dropout((1.0 - update) * current_feat + update * candidate,
                         self.dropout, generator)
        if self.residual:
            output = output + current_feat
        return self.ln_out(output) if self.use_layer_norm else output


class PropagationOutput(NamedTuple):
    features: torch.Tensor     # [B, T, N, hidden]
    memory: MemoryState


class TemporalPropagation(nn.Module):
    def __init__(self, input_dim: int, hidden_dim: int,
                 time_aware: bool = True, bidirectional: bool = False,
                 use_layer_norm: bool = True,
                 use_skip_connection: bool = True, use_gating: bool = True,
                 window_size: int = 3, aggregation: str = "mean",
                 residual: bool = True, memory_decay_factor: float = 0.8,
                 max_inactivity: int = 5, add_timestep_marker: bool = True,
                 *, dropout: float = 0.1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = default_generator(generator)
        self.hidden_dim = hidden_dim
        self.dropout = dropout
        self.use_layer_norm = use_layer_norm
        self.memory_decay_factor = memory_decay_factor
        self.max_inactivity = max_inactivity
        self.add_timestep_marker = add_timestep_marker
        self.evolution = TemporalEvolutionLayer(
            input_dim, hidden_dim, time_aware, bidirectional,
            use_layer_norm, residual, dropout=dropout, generator=g)
        self.out_proj = Linear(hidden_dim, hidden_dim, generator=g)
        if use_skip_connection:
            self.skip = TemporalSkipConnection(
                input_dim=hidden_dim, window_size=window_size,
                aggregation=aggregation, use_layer_norm=use_layer_norm,
                residual=residual, dropout=dropout, generator=g)
        if use_gating:
            self.gating = TemporalGatingUnit(
                hidden_dim, use_layer_norm=use_layer_norm,
                residual=residual, dropout=dropout, generator=g)
        if use_layer_norm:
            self.ln = LayerNorm(hidden_dim)

    def forward(self, x_seq: torch.Tensor,
                node_mask: Optional[torch.Tensor] = None,
                time_stamps: Optional[torch.Tensor] = None,
                memory: Optional[MemoryState] = None,
                time_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None
                ) -> PropagationOutput:
        B, T, N, _ = x_seq.shape
        dev = x_seq.device
        if node_mask is None:
            node_mask = torch.ones(B, T, N, dtype=torch.bool, device=dev)
        if time_mask is not None:
            # padded snapshots are inert: no active nodes, no memory work
            node_mask = node_mask & time_mask[:, :, None]
        if memory is None:
            memory = init_memory(N, self.hidden_dim, batch=(B,),
                                 dtype=x_seq.dtype, device=dev)

        evolved = self.evolution(x_seq, time_stamps, time_mask, node_mask,
                                 generator)
        if hasattr(self, "skip"):
            evolved = self.skip(evolved, time_mask, generator)

        gating = getattr(self, "gating", None)
        last_seen = torch.zeros(B, N, dtype=torch.int32, device=dev)
        seen = torch.zeros(B, N, dtype=torch.bool, device=dev)
        merged_steps = []
        for t in range(T):
            feats, active = evolved[:, t], node_mask[:, t]
            prev, has_prev = memory_read(memory)
            gap = t - torch.where(seen, last_seen, torch.zeros_like(last_seen))
            was_prev = seen & (last_seen == t - 1)
            reappearing = active & has_prev & ~was_prev
            continuing = active & has_prev & was_prev
            gapf = gap.to(feats.dtype)
            if gating is not None:
                bias_reappear = torch.clamp(
                    0.9 - 0.1 * torch.clamp(gapf, max=4.0), min=0.5)
                bias = torch.where(reappearing, bias_reappear,
                                   torch.full_like(bias_reappear, 0.6))
                gated = gating(feats, prev, memory_bias=bias,
                               generator=generator)
                merged = torch.where((reappearing | continuing)[..., None],
                                     gated, feats)
            else:
                w_mem = torch.clamp(
                    0.9 - 0.1 * torch.clamp(gapf, max=5.0), min=0.4)[..., None]
                blend = w_mem * prev + (1.0 - w_mem) * feats
                merged = torch.where(reappearing[..., None], blend, feats)

            # memory write: the detached state plus a 0.01*t marker
            write = merged.detach()
            if self.add_timestep_marker and t > 0:
                write = write + torch.full((), float(t), dtype=write.dtype,
                                           device=dev) * 0.01
            new_mem = memory_update(memory, active, write, t,
                                    decay_factor=self.memory_decay_factor,
                                    max_inactivity=self.max_inactivity)
            if time_mask is not None:
                new_mem = new_mem.where(time_mask[:, t], memory)
            memory = new_mem
            last_seen = torch.where(active, torch.full_like(last_seen, t),
                                    last_seen)
            seen = seen | active
            merged_steps.append(merged)

        out = dropout(self.out_proj(torch.stack(merged_steps, dim=1)),
                      self.dropout, generator)
        if self.use_layer_norm:
            out = self.ln(out)
        return PropagationOutput(features=out, memory=memory)
