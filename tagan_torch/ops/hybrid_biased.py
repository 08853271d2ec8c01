"""Edge-biased hybrid (band + residual) attention, forward.

Counterpart of the forward of ``tagan_tpu/ops/pallas/hybrid_biased.py``
(``_hybrid_biased_fwd``): the dense path's double softmax

    w1 = softmax(mask(s));  [drop1];  w2 = softmax(mask(w1 + B));
    [drop2];  out = w2 @ v

over an edge set split in two, both softmaxes normalising over the union.
The BAND runs the compact-store kernels B4c and B5c
(`ops.flash_geometric`), which take their first-softmax logsumexp as an
input; the RESIDUAL runs O(E) over its COO edges, here in plain torch:

    1. lse1_band   B4c over the band's occupied tiles
    2. lse1_res    logsumexp of the residual edges' scores
    3. lse1_U      their union (`lse_union`)
    4. band pass   B5c with lse1_U: the band partial (out, lse2) of the
                   second softmax
    5. res pass    the same partial over the residual edges
    6. merge       `ops.sparse.merge_attention_partials` of the two

Residual scores take the kernels' norm expansion max(|q|^2 + |k|^2 -
2 q.k, 0) of squared distances, as the JAX package's padded residual
does. Band dropout is the kernels' coordinate hash with the two seeds of
`biased_seeds`; residual dropout draws keep factors from a
``torch.Generator`` (the two edge sets are disjoint, so the union's drop
pattern is exact, as in JAX, with other random bits). Forward only: a
backward through it raises NotImplementedError until the edge-feature
hybrid backward (B6c, B7a c, B7b c and the residual's two sides) is
ported.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from . import flash_geometric as FG
from .masked import NEG_INF
from .sparse import (_gather_nodes, _per_head_index, _segment_max,
                     merge_attention_partials, segment_sum, spmm)


def lse_union(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """logaddexp of two logsumexps with either dead-row mark (|lse| >=
    1e29): ``LSE_DEAD`` where both are dead (the JAX ``_lse_union``)."""
    a_ = torch.where(a.abs() >= 1e29, torch.full_like(a, NEG_INF), a)
    b_ = torch.where(b.abs() >= 1e29, torch.full_like(b, NEG_INF), b)
    m = torch.maximum(a_, b_)
    dead = m <= NEG_INF * 0.5
    m_safe = torch.where(dead, torch.zeros_like(m), m)
    s = torch.exp(a_ - m_safe) + torch.exp(b_ - m_safe)
    s = torch.where(s == 0, torch.ones_like(s), s)
    return torch.where(dead, torch.full_like(m, FG.LSE_DEAD),
                       m_safe + torch.log(s))


def row_safe(lse: torch.Tensor) -> torch.Tensor:
    """lse with dead marks replaced by 0, safe inside an exp that is
    masked anyway (the JAX ``_row_safe``)."""
    return torch.where(lse.abs() >= 1e29, torch.zeros_like(lse), lse)


def residual_scores(metric: str, q, k, edge_q, edge_k, scale):
    """Scores [..., H, E] of the residual edges in the kernels'
    convention (the JAX ``_pp_scores_aux``): the norm expansion of
    squared distances, scale f32[H] (sigma or gamma)."""
    q_e, k_e = _gather_nodes(q, edge_q), _gather_nodes(k, edge_k)
    qk = (q_e * k_e).sum(-1)
    sq = None
    if metric in FG._SQ_METRICS:
        sq = torch.clamp((q_e * q_e).sum(-1) + (k_e * k_e).sum(-1)
                         - 2.0 * qk, min=0.0)
    return FG._scores_from(metric, qk, sq, scale[:, None], q.shape[-1])


def _segment_lse(z, idx, em, num_nodes):
    """(m_safe, safe sum, dead) per segment of the masked z [..., H, E]:
    the pieces of a segment logsumexp."""
    z = torch.where(em, z, torch.full_like(z, NEG_INF))
    m = _segment_max(z, idx, num_nodes)
    dead = m <= NEG_INF * 0.5
    m_safe = torch.where(dead, torch.zeros_like(m), m)
    e = torch.exp(z - torch.gather(m_safe, -1, idx)) * em.to(z.dtype)
    l = segment_sum(e, idx, num_nodes)
    return m_safe, torch.where(l == 0, torch.ones_like(l), l), dead, e


def residual_lse1(metric: str, q, k, edge_q, edge_k, edge_mask,
                  num_nodes: int, scale) -> torch.Tensor:
    """The residual's first-softmax logsumexp [..., H, N], ``LSE_DEAD``
    on rows without a residual edge (the JAX ``_res_lse1``)."""
    s = residual_scores(metric, q, k, edge_q, edge_k, scale)
    idx = _per_head_index(edge_q, s.shape[-2])
    m_safe, l, dead, _ = _segment_lse(s, idx, edge_mask[..., None, :],
                                      num_nodes)
    return torch.where(dead, torch.full_like(m_safe, FG.LSE_DEAD),
                       m_safe + torch.log(l))


def residual_biased_partial(metric: str, q, k, v, edge_q, edge_k, edge_mask,
                            num_nodes: int, edge_bias, lse1_u, scale,
                            keep=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The residual partial of the second softmax given the union lse1
    [..., H, N] (the JAX ``_res_biased_partial``): per residual edge w1 =
    exp(s - lse1_U), z = drop1(w1) + bias, then (out [..., H, N, Dv],
    lse2 [..., H, N]) of the softmax of z over the residual edges, drop2
    on its weights. ``edge_bias`` [..., E] is shared by the heads;
    ``keep`` None or the inverted-dropout factors (kap1, kap2), each
    [..., H, E]. ``LSE_DEAD`` on rows without a residual edge."""
    s = residual_scores(metric, q, k, edge_q, edge_k, scale)
    idx = _per_head_index(edge_q, s.shape[-2])
    em = edge_mask[..., None, :]
    w1 = torch.where(em, torch.exp(s - torch.gather(row_safe(lse1_u), -1,
                                                    idx)),
                     torch.zeros_like(s))
    if keep is not None:
        w1 = w1 * keep[0]
    m_safe, l, dead, e = _segment_lse(w1 + edge_bias[..., None, :], idx, em,
                                      num_nodes)
    p = e / torch.gather(l, -1, idx)
    if keep is not None:
        p = p * keep[1]
    out = spmm(p, v, edge_q, edge_k, num_nodes)
    return out, torch.where(dead, torch.full_like(m_safe, FG.LSE_DEAD),
                            m_safe + torch.log(l))


def _keep_factors(shape, rate: float, generator: torch.Generator, device):
    """Two inverted-dropout factor tensors (0 or 1 / (1 - rate))."""
    keep = 1.0 - rate
    out = []
    for _ in range(2):
        u = torch.rand(shape, generator=generator, device=generator.device)
        out.append(torch.where(u.to(device) < keep,
                               torch.full((), 1.0 / keep, device=device),
                               torch.zeros((), device=device)))
    return tuple(out)


def hybrid_biased_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, store: torch.Tensor,
    plan, res, bias_store: torch.Tensor, res_bias: torch.Tensor,
    metric: str = "scaled_dot_product",
    scale_param: Optional[torch.Tensor] = None, dropout_rate: float = 0.0,
    dropout_seed=None, generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """The edge-biased hybrid attention's output [..., H, N, Dv] (the JAX
    ``hybrid_biased_attention``'s forward), rows with no edge zero. q, k
    [..., H, N, D], v [..., H, N, Dv]; the band's compact store and plan
    (jlist, jcount, jslot) [..., n_i, W] (`SnapshotSequence.hyb_*`, taken
    unchecked), its bias store f32[..., S, BM, BN] in the same slots; the
    residual (edge_q, edge_k, edge_mask) [..., Er] and its bias
    [..., Er]. Cosine metrics run on L2-normalised q/k, as the flash path
    does. ``dropout_seed`` (one int32 per leading index) seeds the band's
    two hash dropouts, ``generator`` the residual's."""
    if metric not in FG.MXU_METRICS:
        raise NotImplementedError(
            f"metric {metric} is not written through q.k; use 'csr'")
    if dropout_rate > 0.0 and (dropout_seed is None or generator is None):
        raise ValueError("dropout_rate > 0 needs dropout_seed (band) and "
                         "generator (residual)")
    lead = q.shape[:-3]
    H, N, D = q.shape[-3:]
    Dv = v.shape[-1]
    G = math.prod(lead)
    inputs = (q, k, v, scale_param, res_bias, bias_store)
    with torch.no_grad():
        if metric in FG._COSINE:
            q, k = FG._l2_normalize(q), FG._l2_normalize(k)
        scale = torch.ones(H, dtype=torch.float32, device=q.device) \
            if scale_param is None \
            else scale_param.to(torch.float32).contiguous()
        qf, kf = (t.reshape(G, H, N, D).contiguous() for t in (q, k))
        vf = v.reshape(G, H, N, Dv).contiguous()
        st, pl = FG.fold_compact(store, plan, G)
        bst = bias_store.to(torch.float32).reshape(G, *bias_store.shape[-3:])
        eq, ek, em = (t.reshape(G, -1) for t in res)
        rb = res_bias.to(torch.float32).reshape(G, -1)
        lse1_u = lse_union(FG._lse1_compact(qf, kf, st, pl, metric, scale),
                           residual_lse1(metric, qf, kf, eq, ek, em, N, scale))
        band = FG._biased_forward_compact(
            qf, kf, vf, st, bst.contiguous(), lse1_u.contiguous(), pl, metric,
            scale, dropout_rate,
            FG.biased_seeds(dropout_seed, G, q.device))
        keep = None
        if dropout_rate > 0.0:
            keep = _keep_factors((G, H, eq.shape[-1]), dropout_rate,
                                 generator, q.device)
        res_part = residual_biased_partial(metric, qf, kf, vf, eq, ek, em, N,
                                           rb, lse1_u, scale, keep)
        out, _ = merge_attention_partials([band, res_part])
    return FG.forward_only((out.reshape(*lead, H, N, Dv),), inputs)[0]
