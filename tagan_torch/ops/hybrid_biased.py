"""Edge-biased hybrid (band + residual) attention.

Counterpart of ``tagan_tpu/ops/pallas/hybrid_biased.py``
(``_hybrid_biased``, its forward and backward): the dense path's double
softmax

    w1 = softmax(mask(s));  [drop1];  w2 = softmax(mask(w1 + B));
    [drop2];  out = w2 @ v

over an edge set split in two, both softmaxes normalising over the union.
The BAND runs the compact-store kernels (`ops.flash_geometric`), which
take their row statistics as inputs; the RESIDUAL runs O(E) over its COO
edges, here in plain torch. Forward:

    1. lse1_band   B4c over the band's occupied tiles
    2. lse1_res    logsumexp of the residual edges' scores
    3. lse1_U      their union (`lse_union`)
    4. band pass   B5c with lse1_U: the band partial (out, lse2) of the
                   second softmax
    5. res pass    the same partial over the residual edges
    6. merge       `ops.sparse.merge_attention_partials` of the two: out
                   and the union lse2_U

Backward, given d(out) only, with union statistics throughout:

    delta2     = rowsum(d(out) * out)
    res query  dz per residual edge and delta1_res (`_residual_backward`)
    band       B6c: delta1_band and dB in the store's slots, set at the
               mask's pairs (the only entries the bias store's backward
               gathers: band edges); delta1_U = delta1_band + delta1_res;
               B7a c (dq, dscale) and B7b c (dk, dv) with delta1_U. On
               CUDA, in both precisions, B6c and B7a c are one row walk,
               which adds delta1_res between its two passes, and B7b c a
               key walk
    res finish ds = w1 (dw1 - delta1_U): dq, dk, dv and dscale of the
               residual edges by segment sums over edge_q and edge_k; the
               residual bias's gradient is dz summed over the heads

Residual scores take the kernels' norm expansion max(|q|^2 + |k|^2 -
2 q.k, 0) of squared distances, as the JAX package's padded residual
does. Band dropout is the kernels' coordinate hash with the two seeds of
`biased_seeds`; residual dropout draws keep factors from a
``torch.Generator`` once, in the forward, and the backward reads the same
factors (the two edge sets are disjoint, so the union's drop pattern is
exact, as in JAX, with other random bits).

With ``bf16`` the band takes the bf16 forms of B4c, B5c, B6c, B7a c and
B7b c (the TPU kernels' ``bf16=True``: every product's operands rounded
to bf16, float32 sums); the residual, `lse_union` and the merge hold no
contraction of the kernels and stay float32, as JAX's ``_res_lse1``,
``_res_biased_partial`` and residual backward do.
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
    """(s, sq, qk, q_e, k_e) of the residual edges (the JAX
    ``_pp_scores_aux`` and its gathers): scores [..., H, E] in the
    kernels' convention (the norm expansion of squared distances; sq is
    None for the other metrics), the cross terms and the gathered rows
    [..., H, E, D]; scale f32[H] (sigma or gamma)."""
    q_e, k_e = _gather_nodes(q, edge_q), _gather_nodes(k, edge_k)
    qk = (q_e * k_e).sum(-1)
    sq = None
    if metric in FG._SQ_METRICS:
        sq = torch.clamp((q_e * q_e).sum(-1) + (k_e * k_e).sum(-1)
                         - 2.0 * qk, min=0.0)
    s = FG._scores_from(metric, qk, sq, scale[:, None], q.shape[-1])
    return s, sq, qk, q_e, k_e


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
    s = residual_scores(metric, q, k, edge_q, edge_k, scale)[0]
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
    s = residual_scores(metric, q, k, edge_q, edge_k, scale)[0]
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


def _residual_backward(metric: str, q, k, v, g, edge_q, edge_k, edge_mask,
                       num_nodes: int, edge_bias, lse1_u, lse2_u, delta2,
                       scale, keep=None):
    """The residual's backward, query side (the JAX ``_res_bwd_query``),
    over the COO residual: (dz [..., H, E], delta1_res [..., H, N], and
    ``finish``, which given the union delta1 [..., H, N] returns (dq_r,
    dk_r, dv_r, dscale_r f32[H] or None) by segment sums over edge_q and
    edge_k: the key side of JAX's ``_res_bwd_key`` needs no transposed
    layout here). Per residual edge, with the union statistics: w1 =
    exp(s - lse1_U), z = drop1(w1) + bias, w2 = exp(z - lse2_U), dz = w2
    (drop2(g_q . v_k) - delta2_q), dw1 = drop1(dz); delta1_res sums
    w1 dw1 per query; ds = w1 (dw1 - delta1_U) takes the UNION delta1,
    which is why this is written out and not left to autograd of
    `residual_biased_partial`. ``keep`` as in `residual_biased_partial`
    (the forward's factors)."""
    N = num_nodes
    s, sq, qk, q_e, k_e = residual_scores(metric, q, k, edge_q, edge_k,
                                          scale)
    H, D = q.shape[-3], q.shape[-1]
    idx_q = _per_head_index(edge_q, H)
    idx_k = _per_head_index(edge_k, H)
    em = edge_mask[..., None, :]
    zero = torch.zeros_like(s)

    def at_q(x):                                  # [..., H, N] at edge_q
        return torch.gather(x, -1, idx_q)
    w1 = torch.where(em, torch.exp(s - at_q(row_safe(lse1_u))), zero)
    z = (w1 if keep is None else w1 * keep[0]) + edge_bias[..., None, :]
    w2 = torch.where(em, torch.exp(z - at_q(row_safe(lse2_u))), zero)
    g_e, v_e = _gather_nodes(g, edge_q), _gather_nodes(v, edge_k)
    dp2 = (g_e * v_e).sum(-1)
    if keep is not None:
        dp2 = dp2 * keep[1]
    dz = torch.where(em, w2 * (dp2 - at_q(delta2)), zero)
    dw1 = dz if keep is None else keep[0] * dz
    delta1_res = segment_sum(w1 * dw1, idx_q, N)

    def finish(delta1_u):
        ds = torch.where(em, w1 * (dw1 - at_q(delta1_u)), zero)
        sc = scale[:, None]
        wt = FG._chain_weight(metric, ds, s, sq, qk, sc, D)
        dq = segment_sum(wt[..., None] * k_e, idx_q, N)
        dk = segment_sum(wt[..., None] * q_e, idx_k, N)
        if metric in FG._SQ_METRICS:
            dq = dq - segment_sum(wt, idx_q, N)[..., None] * q
            dk = dk - segment_sum(wt, idx_k, N)[..., None] * k
        w2d = w2 if keep is None else w2 * keep[1]
        dv = segment_sum(w2d[..., None] * g_e, idx_k, N)
        dscale = None
        if metric in FG.SCALED_METRICS:
            common = (ds * s * sq).reshape(-1, H, s.shape[-1]).sum((0, 2))
            dscale = common / scale ** 3 if metric == "gaussian_kernel" \
                else -common
        return dq, dk, dv, dscale

    return dz, delta1_res, finish


class _HybridBiasedAttention(torch.autograd.Function):
    """The edge-biased hybrid attention of folded inputs (the JAX
    package's ``_hybrid_biased`` custom_vjp): B4c, the residual lse1,
    B5c, the residual partial and the merge forward; B6c, B7a c and
    B7b c with the residual's two sides backward, all with union
    statistics (the compact plain parts on the CPU; on CUDA the compact
    row and key walks, in both precisions); ``bf16`` takes the band
    kernels' bf16 forms. Returns out; the residual's keep factors (kap1,
    kap2) are the forward's. dscale is formed only when the scale
    requires grad, dB and the residual bias's gradient only when theirs
    do. dB is the bias store's cotangent at the mask's pairs; the walks
    leave its other entries unset, and `hybrid_bias_store`'s backward
    reads it at band edges only."""

    @staticmethod
    def forward(ctx, q, k, v, scale, bias_store, res_bias, store, jlist,
                jcount, jslot, ilist, icount, islot, edge_q, edge_k,
                edge_mask, seeds, kap1, kap2, metric, dropout_rate, bf16):
        N = q.shape[2]
        plan = (jlist, jcount, jslot)
        keep = None if kap1 is None else (kap1, kap2)
        lse1_u = lse_union(
            FG._lse1_compact(q, k, store, plan, metric, scale, bf16),
            residual_lse1(metric, q, k, edge_q, edge_k, edge_mask, N,
                          scale)).contiguous()
        band = FG._biased_forward_compact(q, k, v, store, bias_store, lse1_u,
                                          plan, metric, scale, dropout_rate,
                                          seeds, bf16)
        res_part = residual_biased_partial(metric, q, k, v, edge_q, edge_k,
                                           edge_mask, N, res_bias, lse1_u,
                                           scale, keep)
        out, lse2_u = merge_attention_partials([band, res_part])
        ctx.save_for_backward(q, k, v, scale, bias_store, res_bias, store,
                              jlist, jcount, jslot, ilist, icount, islot,
                              edge_q, edge_k, edge_mask, seeds, kap1, kap2,
                              lse1_u, lse2_u.contiguous(), out)
        ctx.args = (metric, dropout_rate, bf16)
        return out

    @staticmethod
    def backward(ctx, dout):
        (q, k, v, scale, bias_store, res_bias, store, jlist, jcount, jslot,
         ilist, icount, islot, edge_q, edge_k, edge_mask, seeds, kap1, kap2,
         lse1_u, lse2_u, out) = ctx.saved_tensors
        metric, dropout_rate, bf16 = ctx.args
        need_dscale = ctx.needs_input_grad[3] and metric in FG.SCALED_METRICS
        g = dout.contiguous()
        delta2 = (g * out).sum(-1).contiguous()
        keep = None if kap1 is None else (kap1, kap2)
        dz_r, delta1_r, finish = _residual_backward(
            metric, q, k, v, g, edge_q, edge_k, edge_mask, q.shape[2],
            res_bias, lse1_u, lse2_u, delta2, scale, keep)
        dq, dk, dv, dbias, dscale, delta1_u = FG._biased_backward_compact(
            q, k, v, store, bias_store, g, lse1_u, lse2_u, delta2,
            (jlist, jcount, jslot),
            None if ilist is None else (ilist, icount, islot), metric, scale,
            dropout_rate, seeds, need_dscale, delta1_r, bf16)
        dq_r, dk_r, dv_r, dscale_r = finish(delta1_u)
        if need_dscale:
            dscale = dscale + dscale_r
        elif ctx.needs_input_grad[3]:
            dscale = torch.zeros_like(scale)
        return (dq + dq_r, dk + dk_r, dv + dv_r, dscale,
                dbias if ctx.needs_input_grad[4] else None,
                dz_r.sum(-2) if ctx.needs_input_grad[5] else None) \
            + (None,) * 16


def hybrid_biased_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, store: torch.Tensor,
    plan, res, bias_store: torch.Tensor, res_bias: torch.Tensor,
    metric: str = "scaled_dot_product",
    scale_param: Optional[torch.Tensor] = None, dropout_rate: float = 0.0,
    dropout_seed=None, generator: Optional[torch.Generator] = None,
    plan_t=None, bf16: bool = False,
) -> torch.Tensor:
    """The edge-biased hybrid attention's output [..., H, N, Dv] (the JAX
    ``hybrid_biased_attention``), rows with no edge zero, differentiable
    in q, k, v, the scale and both biases. q, k [..., H, N, D], v
    [..., H, N, Dv]; the band's compact store and plan (jlist, jcount,
    jslot) [..., n_i, W] (`SnapshotSequence.hyb_*`, taken unchecked), its
    bias store f32[..., S, BM, BN] in the same slots; the residual
    (edge_q, edge_k, edge_mask) [..., Er] and its bias [..., Er].
    ``plan_t`` is the band's transposed walk (ilist, icount, islot),
    which the backward's B7b c walks: a backward without it raises
    ValueError. Cosine metrics run on L2-normalised q/k, as the flash
    path does; the normalisation and the folding of leading dims stay
    outside the autograd Function, where autograd pulls them back.
    ``dropout_seed`` (one int32 per leading index) seeds the band's two
    hash dropouts, ``generator`` the residual's keep factors. ``bf16``
    takes the band kernels' bf16 forms, forward and backward; the
    residual and the merge stay float32."""
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
    if metric in FG._COSINE:
        q, k = FG._l2_normalize(q), FG._l2_normalize(k)
    scale = torch.ones(H, dtype=torch.float32, device=q.device) \
        if scale_param is None \
        else scale_param.to(torch.float32).contiguous()
    st, pl = FG.fold_compact(store, plan, G)
    pl_t = (None,) * 3 if plan_t is None else FG.fold_compact(store, plan_t,
                                                              G)[1]
    eq, ek, em = (t.reshape(G, -1) for t in res)
    keep = (None, None)
    if dropout_rate > 0.0:
        keep = _keep_factors((G, H, eq.shape[-1]), dropout_rate, generator,
                             q.device)
    out = _HybridBiasedAttention.apply(
        q.reshape(G, H, N, D).contiguous(), k.reshape(G, H, N, D).contiguous(),
        v.reshape(G, H, N, Dv).contiguous(), scale,
        bias_store.to(torch.float32).reshape(G, *bias_store.shape[-3:])
        .contiguous(), res_bias.to(torch.float32).reshape(G, -1), st, *pl,
        *pl_t, eq, ek, em, FG.biased_seeds(dropout_seed, G, q.device), *keep,
        metric, dropout_rate, bf16)
    return out.reshape(*lead, H, N, Dv)
