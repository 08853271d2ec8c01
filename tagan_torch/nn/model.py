"""TAGAN model assembly.

Counterpart of ``tagan_tpu.nn.model``: ``TAGAN`` (``encode_spatial``
for the dense, csr, flash and hybrid backends, with or without edge
features;
``forward`` = the JAX ``_forward`` in ``compat_mode="intended"``,
``compute_loss``, ``infer``) and ``batched_forward``.

The JAX package runs one sequence per call and ``vmap``s over a batch,
with ``lax.map`` over snapshots. Here the batch and the snapshots are
written-out leading dims: every op takes ``[B, T, N, ...]``, and the
flash and hybrid backends fold the B*T snapshots into one kernel launch
per attention layer. A single (unbatched) sequence runs as a batch of
one. The hybrid backend reads the band + residual plan a sequence
carries (`SnapshotSequence.with_hybrid_plan`; `Predictor` attaches it,
the loader's ``plan="hybrid"`` with the transposed walk that training's
backward reads), with or without edge features. The bias store's
gradient (`hybrid_bias_store`) is autograd's gather of its segment sum:
each band edge reads the store's cotangent at its pair, duplicates
alike, and residual and invalid edges get 0 there.

Pipeline: node embedding; ``num_layers`` geometric attention layers per
snapshot with the first layer's skip ``x = attn(x) + LN(skip)``;
temporal propagation with the memory bank; asymmetric temporal attention
per node slot over time; node -> graph pooling per step (mean, max,
attention, or the per-node ``logit`` readout); classification head.

Entry points run on ``cuda`` unless ``device="cpu"`` is given; on the
CPU the flash and hybrid backends run the kernels' plain versions.

``forward(..., deterministic=False, generator=g)`` is the training
forward: dropout at every site the JAX package has, drawn from the
``torch.Generator`` ``g``. Dropout never keys on ``nn.Module.training``:
a model is in training mode from construction, and serving must not
drop.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from ..core.config import TAGANConfig
from ..core.graph import HYBRID_TILE, SnapshotSequence
from ..core import module as M
from ..core.memory import MemoryState
from ..core.module import (LayerNorm, Linear, default_generator,
                           default_matmul_precision, resolve_device)
from ..ops.flash_geometric import make_block_plans_from_edges
from ..ops.sparse import add_self_loops, segment_sum
from .geometric import GraphAttention
from .heads import AttentionPool, ClassificationModule, temporal_loss
from .propagation import TemporalPropagation
from .temporal_attention import AsymmetricTemporalAttention


class TAGANOutput(NamedTuple):
    logits: torch.Tensor
    predictions: torch.Tensor
    loss: Optional[torch.Tensor]
    memory: Optional[MemoryState]
    # with return_attention_weights: the temporal attention's weights
    # [B, N, H, T, T] and the first geometric layer's [B, T, H, N, N]
    # (no leading B for one sequence)
    temporal_attention_weights: Optional[torch.Tensor] = None
    geometric_attention_weights: Optional[torch.Tensor] = None


def check_in_slice(c: TAGANConfig) -> None:
    """Raise NotImplementedError for what the port does not run yet."""
    missing = []
    if c.spatial_backend not in ("dense", "csr", "flash", "hybrid"):
        missing.append(f"spatial_backend={c.spatial_backend!r}")
    if c.compat_mode != "intended":
        missing.append(f"compat_mode={c.compat_mode!r}")
    if c.temporal_attention_type != "asymmetric":
        missing.append(f"temporal_attention_type={c.temporal_attention_type!r}")
    if missing:
        raise NotImplementedError(
            "not ported to tagan_torch yet: " + ", ".join(missing))


def flash_structures(edge_src: torch.Tensor, edge_dst: torch.Tensor,
                     edge_mask: torch.Tensor, node_mask: torch.Tensor,
                     n: int) -> Tuple[torch.Tensor, Tuple, Tuple]:
    """The flash backend's per-snapshot attention mask and walk plans,
    shared by every layer: (mask, plan, plan_t), the forward walk for B1
    and B3a and the transposed walk for B2 and B3b, both from one
    occupancy. Leading dims of the edge arrays ([..., E]) are
    snapshots/sequences. The mask is int8 [..., n, n]: the valid edges
    (src, dst) scattered in, then the diagonal set to the key node's
    activity."""
    lead = edge_src.shape[:-1]
    mask = torch.zeros(lead + (n, n), dtype=torch.int8, device=edge_src.device)
    flat = mask.view(-1, n, n)
    em = edge_mask.reshape(-1, edge_mask.shape[-1])
    gi = torch.arange(em.shape[0], device=em.device)[:, None].expand_as(em)
    flat[gi[em], edge_src.reshape(em.shape)[em].long(),
         edge_dst.reshape(em.shape)[em].long()] = 1
    mask.diagonal(dim1=-2, dim2=-1).copy_(node_mask)
    plan, plan_t = make_block_plans_from_edges(edge_src, edge_dst, edge_mask,
                                               node_mask, n)
    return mask, plan, plan_t


def _scatter_pairs(values: torch.Tensor, edge_src: torch.Tensor,
                   edge_dst: torch.Tensor, n: int) -> torch.Tensor:
    """values [..., E, *F] added into [..., n, n, *F] at (src, dst) per
    leading index: duplicate edges add up."""
    out = segment_sum(values, edge_src.long() * n + edge_dst.long(), n * n)
    return out.reshape(edge_src.shape[:-1] + (n, n)
                       + values.shape[edge_src.dim():])


def edge_bias_matrix(b: torch.Tensor, edge_src: torch.Tensor,
                     edge_dst: torch.Tensor, edge_mask: torch.Tensor,
                     n: int) -> torch.Tensor:
    """The flash backend's per-layer bias f32[..., n, n]: the per-edge
    scalar ``b`` [..., E] of the valid edges added at (src, dst). The
    mask sets a duplicate edge's pair once, so that pair gets the sum of
    its copies' biases; the diagonal is 0 unless a self edge is given.
    Built just before the layer's launch and freed after it."""
    b = torch.where(edge_mask, b, torch.zeros_like(b)).to(torch.float32)
    return _scatter_pairs(b, edge_src, edge_dst, n)


def hybrid_bias_store(b: torch.Tensor, seq: SnapshotSequence
                      ) -> torch.Tensor:
    """The hybrid band's per-layer bias in the store's slots,
    f32[..., S, 64, 64]: the per-edge scalar ``b`` [..., E] of each band
    edge added at (its slot, src % 64, dst % 64), so duplicates add (the
    JAX ``_scatter_bias_store``); self loops, residual and invalid edges
    (slot -1) carry none. Flat positions are int64: S * 64 * 64 passes
    2**31 past ~130K slots. Its backward is autograd's (the JAX custom
    vjp's ``_sbs_bwd``): the store's cotangent gathered at each band
    edge's position, 0 for the others."""
    store, tile = seq.hyb_mask_blocks, HYBRID_TILE
    S = store.shape[-2 if store.dtype == torch.int64 else -3]
    slot = seq.hyb_band_slot.long()
    pos = (slot * tile + seq.edge_src.long() % tile) * tile \
        + seq.edge_dst.long() % tile
    on = slot >= 0
    vals = torch.where(on, b, torch.zeros_like(b)).to(torch.float32)
    flat = segment_sum(vals, torch.where(on, pos, torch.zeros_like(pos)),
                       S * tile * tile)
    return flat.reshape(*b.shape[:-1], S, tile, tile)


def hybrid_residual_bias(b: torch.Tensor, seq: SnapshotSequence
                         ) -> torch.Tensor:
    """The per-edge scalar ``b`` [..., E] at the residual slots
    [..., Er] (0 on padding)."""
    eid = seq.hyb_res_eid.long()
    got = b.gather(-1, eid.clamp(min=0))
    return torch.where(eid >= 0, got, torch.zeros_like(got))


class TAGAN(nn.Module):
    def __init__(self, config: TAGANConfig, *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        check_in_slice(config)
        dev = resolve_device(device)
        g = default_generator(generator)
        c = self.config = config
        h = c.hidden_dim
        self.edge_bias_on = c.use_edge_features and c.edge_feature_dim > 0
        self.node_embedding = Linear(c.node_feature_dim, h, generator=g)
        if c.node_pooling == "attention":
            self.node_pool = AttentionPool(h, score_bias=True, generator=g)
        if c.edge_feature_dim > 0:
            self.edge_embedding = Linear(c.edge_feature_dim, h, generator=g)
        self.geometric_layers = nn.ModuleDict({
            f"layer_{i}": GraphAttention(
                h, c.num_heads, c.effective_distance_metric,
                c.use_layer_norm, c.learnable_distance,
                use_edge_bias=self.edge_bias_on, dropout=c.dropout,
                generator=g)
            for i in range(c.num_layers)})
        self.temporal_propagation = TemporalPropagation(
            input_dim=h, hidden_dim=h, time_aware=c.time_aware,
            bidirectional=c.bidirectional, use_layer_norm=c.use_layer_norm,
            use_skip_connection=c.use_skip_connection,
            use_gating=c.use_gating, window_size=c.temporal_window_size,
            aggregation=c.aggregation_method, residual=c.use_residual,
            memory_decay_factor=0.8, max_inactivity=c.temporal_window_size,
            dropout=c.dropout, generator=g)
        self.temporal_attention = AsymmetricTemporalAttention(
            h, c.num_heads, causal=c.causal_attention, time_aware=True,
            use_layer_norm=c.use_layer_norm,
            asymmetric_window_size=c.window_size,
            future_discount=c.future_discount,
            relative_position_bias=c.asymmetric_temporal_bias,
            max_relative_position=c.max_relative_position,
            time_encoding_type=c.time_encoding_type,
            use_time_masks=c.use_time_masks, max_time_diff=c.max_time_diff,
            orient_past_high=True, dropout=c.dropout, generator=g)
        self.classification_head = ClassificationModule(
            h, c.output_dim, task_type=c.loss_type,
            pooling_type=c.pooling_type, num_layers=c.head_num_layers,
            use_layer_norm=c.use_layer_norm, dropout=c.dropout, generator=g)
        if c.use_layer_norm:
            self.skip_layer_norm = LayerNorm(h)
        self.device = dev
        self.to(dev)

    # -- forward ----------------------------------------------------------
    def encode_spatial(self, seq: SnapshotSequence,
                       generator: Optional[torch.Generator] = None,
                       return_weights: bool = False):
        """Node embedding + geometric attention per snapshot of a batched
        sequence; [B, T, N, hidden]. Dropout from ``generator`` when
        given. With edge features, each layer's bias comes from the
        embedded ``edge_attr``: scattered per pair over hidden on the
        dense backend, projected per edge to a scalar on csr and flash.
        Under ``bf16_matmul`` its contractions run at bf16
        (`precision`).

        ``return_weights`` also returns the first layer's attention
        weights [B, T, H, N, N]. Only the dense path forms them: the
        other backends take it when the sequence carries its dense
        adjacency (then the [T, N, N] tensors fit by construction) and
        raise ValueError when it was packed with ``dense_adj=False``."""
        with self.precision():
            return self._encode_spatial(seq, generator, return_weights)

    def precision(self):
        """The contraction precision of the config: JAX's
        ``default_matmul_precision("bfloat16")`` under ``bf16_matmul``
        (`core.module.default_matmul_precision`), else float32."""
        return default_matmul_precision(
            "bfloat16" if self.config.bf16_matmul else "highest")

    def _encode_spatial(self, seq, generator, return_weights=False):
        c = self.config
        backend = c.spatial_backend
        if return_weights and backend != "dense":
            if not seq.has_dense_adj:
                raise ValueError(
                    f"return_attention_weights=True is not supported on "
                    f"spatial_backend={backend!r} for sequences built with "
                    "dense_adj=False: returning weights requires the dense "
                    "O(N^2)-per-snapshot attention path (at this scale the "
                    "[T, N, N] weight tensors would not fit device memory). "
                    "Rebuild the sequence with dense_adj=True on a small "
                    "graph to introspect, or run without attention weights.")
            backend = "dense"
        x = self.node_embedding(seq.x)
        skip = x
        layers = list(self.geometric_layers.values())
        ea = self.edge_embedding(seq.edge_attr) if self.edge_bias_on else None
        if backend == "hybrid":
            if seq.hyb_mask_blocks is None:
                raise ValueError(
                    "spatial_backend='hybrid' requires sequences built "
                    "with SnapshotSequence.with_hybrid_plan()")

            def attend(layer, xx):
                bb = rb = None
                if ea is not None:
                    # one bias store per layer, built just before the
                    # layer's launch and freed after it
                    b = layer.edge_bias(ea)[..., 0]
                    b = torch.where(seq.edge_mask, b, torch.zeros_like(b))
                    bb = hybrid_bias_store(b, seq)
                    rb = hybrid_residual_bias(b, seq)
                return layer.attn.apply_hybrid(
                    xx, seq.hyb_mask_blocks, seq.hyb_plan, seq.hyb_res,
                    seq.node_mask, generator, bb, rb, seq.hyb_plan_t,
                    bf16=c.bf16_matmul)
        elif backend == "flash":
            mask, plan, plan_t = flash_structures(
                seq.edge_src, seq.edge_dst, seq.edge_mask, seq.node_mask,
                seq.max_nodes)

            def attend(layer, xx):
                bias = None if ea is None else edge_bias_matrix(
                    layer.edge_bias(ea)[..., 0], seq.edge_src, seq.edge_dst,
                    seq.edge_mask, seq.max_nodes)
                return layer.attn._apply_flash(xx, mask, plan, plan_t,
                                               generator, bias,
                                               bf16=c.bf16_matmul)
        elif backend == "csr":
            eq, ek, em = add_self_loops(seq.edge_src, seq.edge_dst,
                                        seq.edge_mask, seq.node_mask)

            def attend(layer, xx):
                eb = None
                if ea is not None:
                    # the appended self loops carry zero bias, as the
                    # dense scatter leaves the diagonal without an edge
                    b = layer.edge_bias(ea)[..., 0]
                    b = torch.where(seq.edge_mask, b, torch.zeros_like(b))
                    eb = torch.cat(
                        [b, b.new_zeros(b.shape[:-1] + (seq.max_nodes,))], -1)
                return layer.attn.apply_sparse(xx, eq, ek, em, seq.node_mask,
                                               generator, eb)
        else:
            adj = seq.attention_mask()
            feats = None
            if ea is not None:
                # [B, T, N, N, hidden]: the embedded features of the valid
                # edges added per (src, dst) pair
                feats = _scatter_pairs(ea * seq.edge_mask[..., None],
                                       seq.edge_src, seq.edge_dst,
                                       seq.max_nodes)

            def attend(layer, xx):
                return layer(xx, adj, generator, feats,
                             None if feats is None else seq.adj,
                             return_weights=return_weights)
        first = None
        for i, layer in enumerate(layers):
            x = attend(layer, x)
            if return_weights:
                x, w = x
                first = w if i == 0 else first
            if i == 0:
                x = x + (self.skip_layer_norm(skip) if c.use_layer_norm
                         else skip)
        return (x, first) if return_weights else x

    def forward(self, seq: SnapshotSequence,
                labels: Optional[torch.Tensor] = None,
                memory: Optional[MemoryState] = None, *,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None,
                reduction: str = "mean",
                return_attention_weights: bool = False) -> TAGANOutput:
        """Forward of one sequence (x [T, N, F]) or a batch (x
        [B, T, N, F]); logits [C] or [B, C]. With ``labels`` the loss is
        the mean over the batch, or with ``reduction="none"`` one loss
        per sequence ([B]; a scalar for one sequence), as the JAX
        package's per-sequence forward under ``vmap`` gives it. Dropout
        runs only when ``not deterministic and generator is not None``.
        Under ``bf16_matmul`` every contraction, the flash kernels' too,
        takes bf16 operands (`precision`). ``return_attention_weights``
        fills the output's two weight fields (`encode_spatial`'s rule for
        the geometric layer's)."""
        with self.precision():
            return self._forward(seq, labels, memory, deterministic,
                                 generator, reduction,
                                 return_attention_weights)

    def _forward(self, seq, labels, memory, deterministic, generator,
                 reduction, return_weights=False):
        single = not seq.is_batched
        if single:
            seq = seq.map(lambda t: t[None])
            if memory is not None:
                memory = MemoryState(*(getattr(memory, f.name)[None]
                                       for f in dataclasses.fields(memory)))
        seq = seq.to(self.device)
        c = self.config
        B, T, N = seq.x.shape[:3]
        nmask = seq.node_mask
        zero = torch.zeros((), device=self.device)
        g = None if deterministic else generator

        geo_w = temp_w = None
        x = self.encode_spatial(seq, g, return_weights)
        if return_weights:
            x, geo_w = x
        x = torch.where(nmask[..., None], x, zero)
        prop = self.temporal_propagation(
            x, nmask, seq.times if c.time_aware else None, memory,
            time_mask=seq.time_mask, generator=g)
        new_memory = prop.memory
        temporal_out = torch.where(nmask[..., None], prop.features, zero)

        nt = temporal_out.transpose(1, 2)              # [B, N, T, hidden]
        tmask = seq.time_mask
        attn_mask = (tmask[:, None, :] & tmask[:, :, None])[:, None]
        nt = self.temporal_attention(nt, seq.times[:, None, :], attn_mask,
                                     batch_dims=1, generator=g,
                                     return_weights=return_weights)
        if return_weights:
            nt, temp_w = nt

        head = self.classification_head
        if c.node_pooling == "logit":
            # per-node readout: the head runs per node over the steps the
            # node is active in; the graph logit is the max over nodes
            valid = nmask.any(1)                                  # [B, N]
            tm = (tmask[:, None, :] & nmask.transpose(1, 2)) | ~valid[..., None]
            node_logits = head(nt.reshape(B * N, T, -1), tm.reshape(B * N, T),
                               generator=g).reshape(B, N, -1)
            logits = torch.where(valid[..., None], node_logits,
                                 torch.full_like(node_logits, -1e30)).amax(1)
        else:
            back = nt.transpose(1, 2)                  # [B, T, N, hidden]
            if c.node_pooling == "max":
                mx = torch.where(nmask[..., None], back,
                                 torch.full_like(back, -1e30)).amax(2)
                graph = torch.where(nmask.any(2)[..., None], mx, zero)
            elif c.node_pooling == "attention":
                sc = self.node_pool(back)[..., 0]                  # [B, T, N]
                sc = torch.where(nmask, sc, torch.full_like(sc, -1e30))
                w = torch.where(nmask, torch.softmax(sc, dim=2), zero)
                graph = M.einsum("btn,btnh->bth", w, back)
            else:
                m = nmask[..., None].to(back.dtype)
                graph = (back * m).sum(2) / torch.clamp(m.sum(2), min=1.0)
            logits = head(graph, tmask, generator=g)               # [B, C]

        loss = None
        if labels is not None:
            labels = torch.as_tensor(labels, device=self.device)
            if labels.dtype == torch.bool:
                labels = labels.float()
            loss = self.compute_loss(logits, labels[None] if single
                                     else labels, reduction)
            if single and reduction == "none":
                loss = loss[0]
        predictions = torch.sigmoid(logits) if c.output_dim == 1 \
            else torch.softmax(logits, dim=-1)
        if single:
            logits, predictions = logits[0], predictions[0]
            new_memory = MemoryState(*(getattr(new_memory, f.name)[0]
                                       for f in dataclasses.fields(new_memory)))
            if return_weights:
                temp_w, geo_w = temp_w[0], geo_w[0]
        return TAGANOutput(logits, predictions, loss, new_memory, temp_w,
                           geo_w)

    def compute_loss(self, logits: torch.Tensor, labels: torch.Tensor,
                     reduction: str = "mean") -> torch.Tensor:
        """Loss of logits [C] or [B, C] against each sequence's label (a
        scalar, or [C] for multi_label, one-hot or regression targets):
        the mean, or with ``reduction="none"`` the loss of each sequence
        [B] (the mean over its own entries). Every ``loss_type`` of the
        config routes as the JAX package's per-sequence loss does, with
        the config's ``focal_alpha`` and ``focal_gamma``."""
        c = self.config
        lg = logits if logits.dim() > 1 else logits[None]
        lb = labels if labels.dim() > 0 else labels[None]
        task = {"ce": "multi_class", "bce": "classification"}.get(
            c.loss_type, c.loss_type)
        focal = dict(focal_alpha=c.focal_alpha, focal_gamma=c.focal_gamma)
        if c.output_dim > 1 and lb.dim() == lg.dim() - 1:
            loss = temporal_loss(lg, lb, task_type="multi_class",
                                 reduction="none")
        elif c.output_dim == 1 and task in ("classification", "focal"):
            sq = lg[..., 0] if lg.dim() == lb.dim() + 1 else lg
            loss = temporal_loss(sq, lb.to(sq.dtype), task_type=task,
                                 reduction="none", **focal)
        else:
            if lb.dim() == lg.dim() - 1:
                # one label per sequence against [B, 1] logits: the JAX
                # package's [1] label against its [1, 1] logits
                lb = lb[..., None]
            loss = temporal_loss(lg, lb, task_type=task, reduction="none",
                                 **focal)
        if reduction == "none":
            return loss.reshape(lg.shape[0], -1).mean(1)
        return loss.mean()

    @torch.no_grad()
    def infer(self, seq: SnapshotSequence, threshold: float = 0.5) -> dict:
        out = self(seq)
        if self.config.output_dim == 1:
            hard = (out.predictions > threshold).float()
        else:
            hard = out.predictions.argmax(-1)
        return {"logits": out.logits, "predictions": out.predictions,
                "labels": hard}

    @torch.no_grad()
    def infer_with_attention(self, seq: SnapshotSequence) -> dict:
        """Logits, predictions and both attention weights
        (`forward`'s ``return_attention_weights``)."""
        out = self(seq, return_attention_weights=True)
        return {"logits": out.logits, "predictions": out.predictions,
                "temporal_attention_weights": out.temporal_attention_weights,
                "geometric_attention_weights":
                    out.geometric_attention_weights}


def batched_forward(model: TAGAN, batch: SnapshotSequence,
                    labels: Optional[torch.Tensor] = None) -> TAGANOutput:
    """Forward of a stacked batch; the loss is the mean over sequences."""
    if not batch.is_batched:
        raise ValueError("batched_forward needs a stacked batch "
                         "(x [B, T, N, F])")
    return model(batch, labels)
