"""Sparse attention over an edge list: SDDMM, segment softmax, SpMM.

Counterpart of ``tagan_tpu.ops.sparse`` (``sddmm``, ``segment_softmax``,
``spmm``, ``edge_attention``, ``add_self_loops``): the csr backend, the
same attention as the dense masked softmax in O(E); and the partial over
one edge subset with its merge (``edge_attention_partial``,
``merge_attention_partials``), the hybrid backend's residual. The JAX package
leaves these to XLA (gathers and segment sums), so they are plain
PyTorch here: gathers, ``scatter_reduce("amax")`` and ``index_add``.

Edge convention (as ``core.graph``): edge e = (edge_q[e], edge_k[e])
means query node edge_q[e] attends to key node edge_k[e]; the softmax
normalises over the valid edges that share a query. Every function takes
leading batch dims (sequences, snapshots): q, k, v ``[..., H, N, D]``,
edge arrays ``[..., E]``, scores and weights ``[..., H, E]``; the JAX
functions take one snapshot and are mapped over the rest.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.module import dropout
from .distances import edgewise_scores
from .masked import NEG_INF


def _gather_nodes(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [..., H, N, D], idx [..., E] -> x[..., h, idx, :] [..., H, E, D]."""
    H, D = x.shape[-3], x.shape[-1]
    i = idx.long()[..., None, :, None].expand(*idx.shape[:-1], H,
                                              idx.shape[-1], D)
    return torch.gather(x, -2, i)


def _per_head_index(edge_q: torch.Tensor, H: int) -> torch.Tensor:
    """edge_q [..., E] -> [..., H, E] (the segment of each score)."""
    return edge_q.long()[..., None, :].expand(*edge_q.shape[:-1], H,
                                              edge_q.shape[-1])


def segment_sum(x: torch.Tensor, idx: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """x [..., E, *F] summed into [..., num_segments, *F] by the segment
    index idx [..., E] of each leading slice (``jax.ops.segment_sum``
    with leading dims), as one flat ``index_add_``."""
    lead = idx.shape[:-1]
    B, E = idx[..., 0].numel(), idx.shape[-1]
    feat = x.shape[idx.dim():]
    base = torch.arange(B, device=idx.device)[:, None] * num_segments
    flat = (idx.long().reshape(B, E) + base).reshape(-1)
    out = torch.zeros((B * num_segments,) + feat, dtype=x.dtype,
                      device=x.device)
    out.index_add_(0, flat, x.reshape((B * E,) + feat))
    return out.reshape(lead + (num_segments,) + feat)


def sddmm(metric: str, q: torch.Tensor, k: torch.Tensor,
          edge_q: torch.Tensor, edge_k: torch.Tensor, *,
          sigma: Optional[torch.Tensor] = None,
          gamma: Optional[torch.Tensor] = None,
          cov_inv: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-edge, per-head scores [..., H, E]."""
    return edgewise_scores(metric, _gather_nodes(q, edge_q),
                           _gather_nodes(k, edge_k), sigma=sigma,
                           gamma=gamma, cov_inv=cov_inv)


def segment_softmax(scores: torch.Tensor, edge_q: torch.Tensor,
                    edge_mask: torch.Tensor, num_nodes: int) -> torch.Tensor:
    """Softmax over the valid edges that share a query node; [..., H, E]
    with zeros on masked edges. A segment whose edges are all masked
    takes max 0 and a zero denominator takes 1, as in the JAX function."""
    em = edge_mask[..., None, :]
    s = torch.where(em, scores, torch.full_like(scores, NEG_INF))
    idx = _per_head_index(edge_q, scores.shape[-2])
    seg_max = torch.zeros(scores.shape[:-1] + (num_nodes,),
                          dtype=scores.dtype, device=scores.device)
    seg_max = seg_max.scatter_reduce(-1, idx, s, "amax", include_self=False)
    seg_max = torch.where(seg_max <= NEG_INF * 0.5,
                          torch.zeros_like(seg_max), seg_max)
    e = torch.exp(s - torch.gather(seg_max, -1, idx)) * em.to(scores.dtype)
    denom = segment_sum(e, idx, num_nodes)
    denom = torch.where(denom == 0, torch.ones_like(denom), denom)
    return e / torch.gather(denom, -1, idx)


def spmm(weights: torch.Tensor, v: torch.Tensor, edge_q: torch.Tensor,
         edge_k: torch.Tensor, num_nodes: int) -> torch.Tensor:
    """out[..., h, i] = sum of w[..., h, e] v[..., h, edge_k[e]] over the
    edges with edge_q[e] == i; [..., H, num_nodes, D]."""
    contrib = weights[..., None] * _gather_nodes(v, edge_k)
    return segment_sum(contrib, _per_head_index(edge_q, v.shape[-3]),
                       num_nodes)


def edge_attention(metric: str, q: torch.Tensor, k: torch.Tensor,
                   v: torch.Tensor, edge_q: torch.Tensor,
                   edge_k: torch.Tensor, edge_mask: torch.Tensor,
                   num_nodes: int, *, sigma=None, gamma=None, cov_inv=None,
                   edge_bias: Optional[torch.Tensor] = None,
                   dropout_rate: float = 0.0,
                   generator: Optional[torch.Generator] = None
                   ) -> torch.Tensor:
    """SDDMM -> segment softmax -> SpMM: [..., H, N, D].

    ``edge_bias`` ([..., E], shared by the heads, or [..., H, E]) is the
    dense path's re-softmax: the weights get the bias added and are
    normalised again per query. With ``generator`` and a rate > 0 the
    normalised weights are dropped (inverted dropout) after each
    softmax, in the dense path's order."""
    scores = sddmm(metric, q, k, edge_q, edge_k, sigma=sigma, gamma=gamma,
                   cov_inv=cov_inv)
    w = dropout(segment_softmax(scores, edge_q, edge_mask, num_nodes),
                dropout_rate, generator)
    if edge_bias is not None:
        b = edge_bias if edge_bias.dim() == w.dim() else edge_bias[..., None, :]
        w = dropout(segment_softmax(w + b, edge_q, edge_mask, num_nodes),
                    dropout_rate, generator)
    return spmm(w, v, edge_q, edge_k, num_nodes)


def _segment_max(s: torch.Tensor, idx: torch.Tensor,
                 num_nodes: int) -> torch.Tensor:
    """Max of s [..., H, E] per segment idx [..., H, E]; ``NEG_INF``
    where a segment has no entry."""
    out = torch.full(s.shape[:-1] + (num_nodes,), NEG_INF, dtype=s.dtype,
                     device=s.device)
    return out.scatter_reduce(-1, idx, s, "amax")


def edge_attention_partial(metric: str, q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, edge_q: torch.Tensor,
                           edge_k: torch.Tensor, edge_mask: torch.Tensor,
                           num_nodes: int, *, sigma=None, gamma=None,
                           cov_inv=None, dropout_rate: float = 0.0,
                           generator: Optional[torch.Generator] = None):
    """Attention over ONE edge subset (the JAX package's
    ``edge_attention_partial``): (out [..., H, N, D], the softmax over
    these edges only, and lse [..., H, N], the logsumexp of their scores,
    ``NEG_INF`` where a query has no valid edge). Partials over disjoint
    subsets merge into the one softmax over their union
    (`merge_attention_partials`); dropout (``generator``) drops the
    normalised weights, which is linear, so a dropped partial merges into
    the dropped union. No self loops are added here."""
    scores = sddmm(metric, q, k, edge_q, edge_k, sigma=sigma, gamma=gamma,
                   cov_inv=cov_inv)
    em = edge_mask[..., None, :]
    s = torch.where(em, scores, torch.full_like(scores, NEG_INF))
    idx = _per_head_index(edge_q, scores.shape[-2])
    seg_max = _segment_max(s, idx, num_nodes)
    dead = seg_max <= NEG_INF * 0.5
    m_safe = torch.where(dead, torch.zeros_like(seg_max), seg_max)
    e = torch.exp(s - torch.gather(m_safe, -1, idx)) * em.to(s.dtype)
    denom = segment_sum(e, idx, num_nodes)
    safe = torch.where(denom == 0, torch.ones_like(denom), denom)
    w = dropout(e / torch.gather(safe, -1, idx), dropout_rate, generator)
    out = spmm(w, v, edge_q, edge_k, num_nodes)
    lse = torch.where(dead, torch.full_like(seg_max, NEG_INF),
                      m_safe + torch.log(safe))
    return out, lse


def merge_attention_partials(parts):
    """The union softmax from partials over disjoint edge subsets (the
    JAX package's ``merge_attention_partials``): ``parts`` is a sequence
    of (out [..., H, N, D], lse [..., H, N]). Either dead-row mark counts:
    the csr partial's ``NEG_INF`` and the flash kernels' ``LSE_DEAD``
    (any |lse| >= 1e29). Returns (out, lse), zero and ``NEG_INF`` on rows
    dead in every part."""
    lses = [torch.where(lse.abs() >= 1e29, torch.full_like(lse, NEG_INF),
                        lse) for _, lse in parts]
    m = lses[0]
    for lse in lses[1:]:
        m = torch.maximum(m, lse)
    all_dead = m <= NEG_INF * 0.5
    m_safe = torch.where(all_dead, torch.zeros_like(m), m).detach()
    ws = [torch.exp(lse - m_safe) for lse in lses]
    denom = sum(ws)
    safe = torch.where(denom == 0, torch.ones_like(denom), denom)
    out = sum(o * w[..., None] for (o, _), w in zip(parts, ws)) \
        / safe[..., None]
    out = torch.where(all_dead[..., None], torch.zeros_like(out), out)
    lse = torch.where(all_dead, torch.full_like(m, NEG_INF),
                      m_safe + torch.log(safe))
    return out, lse


def add_self_loops(edge_q: torch.Tensor, edge_k: torch.Tensor,
                   edge_mask: torch.Tensor, node_mask: torch.Tensor):
    """One self-loop edge per active node appended after the E edges:
    (edge_q, edge_k, edge_mask) with E + N entries per leading index."""
    n = node_mask.shape[-1]
    loops = torch.arange(n, dtype=edge_q.dtype, device=edge_q.device)
    loops = loops.expand(*edge_q.shape[:-1], n)
    return (torch.cat([edge_q, loops], -1), torch.cat([edge_k, loops], -1),
            torch.cat([edge_mask, node_mask.to(edge_mask.dtype)], -1))
