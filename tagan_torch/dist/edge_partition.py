"""Edge-partitioned sparse attention over the graph axis of a mesh.

Counterpart of the first part of ``tagan_tpu/dist/edge_partition.py``
(:39-484): each rank of the ``graph`` axis owns a contiguous shard of
node slots and every edge whose *query* endpoint lies in it.

- `edge_partitioned_attention` all-gathers K and V over the axis, then
  runs the csr attention (``ops.sparse.edge_attention``) for the shard's
  queries; the softmax is exact because all edges of a query live on its
  owner.
- `make_ring_attention` / `ring_edge_attention` are the collective ring:
  the K/V shards circulate to the right neighbour while each rank folds
  the chunk it holds into a streaming per-query segment softmax, so no
  rank holds all of K and V. ``biased=True`` is the dense path's double
  softmax in two passes. This is the formula the ring flash kernel
  (``ops.ring_flash``, B9) is held against.

The JAX functions run under ``shard_map``; here the ranks of the ring
(``Mesh.ring``) run in lockstep in one process, each on its own device
(several ranks may share one), and ``ppermute`` becomes handing each
rank's chunk to its right neighbour's device, a no-op move between
virtual ranks of one card. It is plain PyTorch, as the JAX package
leaves it to XLA. Results come back gathered in rank order, on q's
device. The host-side partitioners are the JAX package's numpy code.

The boundary-only rings (:486-1012) and the model's ring backend are not
ported yet.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..ops import sparse as S
from ..ops.distances import edgewise_scores
from ..ops.masked import NEG_INF
from .mesh import GRAPH_AXIS, Mesh, gather_rows, shard_rows


def partition_edges_by_query(
    edge_q: np.ndarray, edge_k: np.ndarray, edge_mask: np.ndarray,
    num_nodes: int, num_shards: int,
    max_edges_per_shard: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Host-side: group edges by query-owner shard (owner = slot //
    (N/num_shards)), pad each shard's list to a common static length.

    Returns (edge_q [S, Ep], edge_k [S, Ep], edge_mask [S, Ep], Ep).
    Padded entries point at the owner's first slot with mask=False.
    """
    assert num_nodes % num_shards == 0, (num_nodes, num_shards)
    per = num_nodes // num_shards
    eq = np.asarray(edge_q)
    ek = np.asarray(edge_k)
    em = np.asarray(edge_mask).astype(bool)
    owner = (eq[em] // per).astype(np.int64)
    vq, vk = eq[em], ek[em]
    order = np.argsort(owner, kind="stable")
    owner, vq, vk = owner[order], vq[order], vk[order]
    counts = np.bincount(owner, minlength=num_shards)
    Ep = max_edges_per_shard or max(int(counts.max(initial=0)), 1)
    if counts.max(initial=0) > Ep:
        s = int(np.argmax(counts))
        raise ValueError(
            f"shard {s} has {counts[s]} edges > max_edges_per_shard={Ep}")
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    pos = np.arange(len(owner)) - starts[owner]
    base = (np.arange(num_shards) * per)[:, None]
    out_q = np.broadcast_to(base, (num_shards, Ep)).astype(np.int32).copy()
    out_k = out_q.copy()
    out_m = np.zeros((num_shards, Ep), bool)
    out_q[owner, pos] = vq
    out_k[owner, pos] = vk
    out_m[owner, pos] = True
    return out_q, out_k, out_m, Ep


def partition_edges_by_query_and_key(
    edge_q: np.ndarray, edge_k: np.ndarray, edge_mask: np.ndarray,
    num_nodes: int, num_shards: int,
    max_edges_per_bucket: Optional[int] = None,
    edge_ids: Optional[np.ndarray] = None,
):
    """Host-side: bucket edges by (query-owner, key-owner) shard pair.

    Returns (edge_q [G, G, Ep], edge_k [G, G, Ep], mask [G, G, Ep], Ep)
    where bucket [gq, gk] holds edges whose query lives on shard gq and
    key on shard gk, the layout the ring walks. With ``edge_ids`` (one
    per edge, -1 for entries with no provenance such as appended self
    loops) a fifth array i32[G, G, Ep] comes before Ep: each bucketed
    slot's edge id, -1 on padding.
    """
    assert num_nodes % num_shards == 0
    per = num_nodes // num_shards
    G = num_shards
    eq = np.asarray(edge_q)
    ek = np.asarray(edge_k)
    em = np.asarray(edge_mask).astype(bool)
    vq, vk = eq[em], ek[em]
    bucket = (vq // per) * G + (vk // per)
    order = np.argsort(bucket, kind="stable")
    bucket, vq, vk = bucket[order], vq[order], vk[order]
    counts = np.bincount(bucket, minlength=G * G)
    Ep = max_edges_per_bucket or max(int(counts.max(initial=0)), 1)
    if counts.max(initial=0) > Ep:
        b = int(np.argmax(counts))
        raise ValueError(
            f"bucket ({b // G},{b % G}) has {counts[b]} edges > {Ep}")
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    pos = np.arange(len(bucket)) - starts[bucket]
    gq_base = (np.arange(G) * per)[:, None, None]
    gk_base = (np.arange(G) * per)[None, :, None]
    out_q = np.broadcast_to(gq_base, (G, G, Ep)).astype(np.int32).copy()
    out_k = np.broadcast_to(gk_base, (G, G, Ep)).astype(np.int32).copy()
    out_m = np.zeros((G, G, Ep), bool)
    out_q[bucket // G, bucket % G, pos] = vq
    out_k[bucket // G, bucket % G, pos] = vk
    out_m[bucket // G, bucket % G, pos] = True
    if edge_ids is not None:
        vid = np.asarray(edge_ids)[em][order]
        out_src = np.full((G, G, Ep), -1, np.int32)
        out_src[bucket // G, bucket % G, pos] = vid
        return out_q, out_k, out_m, out_src, Ep
    return out_q, out_k, out_m, Ep


def _shards(mesh: Mesh, x, dim: int) -> List[torch.Tensor]:
    return shard_rows(mesh, torch.as_tensor(x), GRAPH_AXIS, dim)


def edge_partitioned_attention(
    mesh: Mesh, metric: str,
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,   # [H, N, D]
    edge_q, edge_k, edge_mask,         # [S, Ep] from partition_edges_by_query
    *, sigma=None, gamma=None,
) -> torch.Tensor:
    """Sharded edge attention: the [H, N, D] context, each rank's rows
    computed by that rank after an all-gather of K and V."""
    H, N, D = q.shape
    devs = mesh.ring(GRAPH_AXIS)
    per = N // len(devs)
    qs, ks, vs = (_shards(mesh, t, 1) for t in (q, k, v))
    eqs, eks, ems = (_shards(mesh, t, 0) for t in (edge_q, edge_k, edge_mask))
    outs = []
    for my, dev in enumerate(devs):
        kg = gather_rows(ks, 1, dev)
        vg = gather_rows(vs, 1, dev)
        eq_local = eqs[my][0].long() - my * per     # owner-local query ids
        outs.append(S.edge_attention(
            metric, qs[my], kg, vg, eq_local, eks[my][0].long(), ems[my][0],
            per, sigma=_on(sigma, dev), gamma=_on(gamma, dev)))
    return gather_rows(outs, 1, q.device)


def _on(x, dev):
    return x.to(dev) if isinstance(x, torch.Tensor) else x


def _edge_scores(metric, q_l, kc, eqs, eks, ems, sigma, gamma, cov_inv,
                 neg):
    """Masked per-edge scores for one chunk: [H, Ep] (neg on padding)."""
    s_e = edgewise_scores(metric, q_l[:, eqs], kc[:, eks], sigma=sigma,
                          gamma=gamma, cov_inv=cov_inv)
    return torch.where(ems[None, :], s_e, torch.full_like(s_e, neg))


def _fold_scores(s_e, eqs, ems, m, l, acc, per, neg, v_e=None,
                 keep=None, keep_inv=1.0):
    """Fold one chunk's masked scores into the streaming per-query
    segment softmax: (m, l[, acc]) -> updated. ``keep`` (bool[H, Ep])
    drops the normalised weights: the V accumulator takes the dropped
    p_e while the denominator keeps the un-dropped sum, exactly
    dropout(softmax(s)) @ v as on the csr and flash paths. With
    ``v_e=None`` only (m, l) update (the logsumexp-only pass)."""
    H = s_e.shape[0]
    idx = eqs[None, :].expand(H, -1)
    m_chunk = torch.full((H, per), float("-inf"), dtype=s_e.dtype,
                         device=s_e.device).scatter_reduce(
        -1, idx, s_e, "amax")
    m_chunk = torch.where(torch.isfinite(m_chunk), m_chunk,
                          torch.full_like(m_chunk, neg))
    m_new = torch.maximum(m, m_chunk)
    # guard fully-empty queries (m stays NEG_INF)
    empty = m_new <= neg * 0.5
    shift = torch.where(empty, torch.zeros_like(m_new), m_new)
    p_e = torch.exp(s_e - torch.gather(shift, 1, idx)) * ems[None, :]
    alpha = torch.where(empty, torch.ones_like(m), torch.exp(m - m_new))
    alpha = torch.where(m <= neg * 0.5, torch.zeros_like(alpha), alpha)
    l_new = l * alpha + S.segment_sum(p_e, idx, per)
    if v_e is None:
        return m_new, l_new
    p_v = p_e if keep is None else torch.where(keep, p_e * keep_inv,
                                               torch.zeros_like(p_e))
    contrib = S.segment_sum(p_v[..., None] * v_e, idx, per)
    return m_new, l_new, acc * alpha[..., None] + contrib


def _fold_chunk(metric, q_l, kc, vc, eqs, eks, ems, m, l, acc, per,
                sigma, gamma, cov_inv, neg, keep=None, keep_inv=1.0):
    """Fold one K/V chunk into the streaming per-query segment softmax:
    (m, l, acc) -> updated. eqs are owner-local query ids, eks index
    into ``kc``/``vc`` (chunk-local), ems masks padded bucket slots."""
    s_e = _edge_scores(metric, q_l, kc, eqs, eks, ems, sigma, gamma,
                       cov_inv, neg)
    return _fold_scores(s_e, eqs, ems, m, l, acc, per, neg, v_e=vc[:, eks],
                        keep=keep, keep_inv=keep_inv)


def _fold_biased_chunk(metric, q_l, kc, vc, eqs, eks, ems, b_e,
                       m1, l1, m2, l2, acc, per, sigma, gamma, cov_inv,
                       neg, keep1=None, keep2=None, keep_inv=1.0):
    """Pass B of the edge-biased (double-softmax) ring: from the final
    first-softmax statistics (m1, l1) per query, recompute this chunk's
    scores, form the first-softmax weights w_e (dropped by ``keep1``,
    the dense path's dropout between the two softmaxes), add the
    head-shared per-edge bias b_e [Ep], and fold t_e = w_e + b_e into the
    streaming second softmax (m2, l2, acc) with ``keep2`` dropping its
    normalised weights: ``ops.sparse.edge_attention(edge_bias=...)``
    op for op."""
    H = q_l.shape[0]
    s_e = _edge_scores(metric, q_l, kc, eqs, eks, ems, sigma, gamma,
                       cov_inv, neg)
    shift1 = torch.where(m1 <= neg * 0.5, torch.zeros_like(m1), m1)
    denom1 = torch.where(l1 > 0, l1, torch.ones_like(l1))
    idx = eqs[None, :].expand(H, -1)
    w_e = torch.exp(s_e - torch.gather(shift1, 1, idx)) \
        / torch.gather(denom1, 1, idx)
    w_e = w_e * ems[None, :]
    if keep1 is not None:
        w_e = torch.where(keep1, w_e * keep_inv, torch.zeros_like(w_e))
    t_e = torch.where(ems[None, :], w_e + b_e[None, :],
                      torch.full_like(w_e, neg))
    return _fold_scores(t_e, eqs, ems, m2, l2, acc, per, neg, v_e=vc[:, eks],
                        keep=keep2, keep_inv=keep_inv)


def make_ring_attention(mesh: Mesh, metric: str, H: int, N: int, D: int,
                        dropout_rate: float = 0.0, biased: bool = False):
    """The ring-attention callable:

        fn(q, k, v, edge_q, edge_k, edge_mask, sigma, gamma, cov_inv)
        -> [H, N, D] context

    where edge_* are the [G, G, Ep] buckets from
    `partition_edges_by_query_and_key` and sigma/gamma/cov_inv the
    replicated metric parameters ([H] / [H] / [H, Dh, Dh];
    `metric_placeholders` when unused).

    With ``dropout_rate`` > 0 the callable takes one extra trailing
    operand ``keep`` (bool[H, G, G, Ep], bucketed like the edges):
    attention dropout on the normalised weights, as on the csr and flash
    backends.

    With ``biased=True`` the callable takes a ``bias`` operand (f32[G,
    G, Ep], head-shared per-edge bias values, bucketed like the edges)
    after edge_mask, and computes the dense path's double softmax in two
    ring passes: pass A circulates K alone and accumulates the first
    softmax's per-query (max, sum); pass B circulates K and V, rebuilds
    the first-softmax weights w_e from those finals and streams the
    second softmax over w_e + bias_e. Dropout then takes two keep masks,
    ``keep`` bool[2, H, G, G, Ep] (keep[0] drops w_e between the
    softmaxes, keep[1] the final normalised weights), in
    ``ops.sparse.edge_attention``'s order."""
    devs = mesh.ring(GRAPH_AXIS)
    g = len(devs)
    assert N % g == 0, (N, g)
    per = N // g
    inv = 1.0 / (1.0 - dropout_rate) if dropout_rate > 0.0 else 1.0
    neg = NEG_INF

    def circulate(chunks):
        # ppermute to the right neighbour: rank r now holds rank r-1's
        return [chunks[(r - 1) % g].to(devs[r]) for r in range(g)]

    def setup(q, k, v, edges, params):
        qs, ks, vs = (_shards(mesh, t, 1) for t in (q, k, v))
        es = [_shards(mesh, t, 0) for t in edges]     # each [1, G, Ep]
        ps = [[_on(p, d) for p in params] for d in devs]
        state = [(torch.full((H, per), neg, device=d),
                  torch.zeros((H, per), device=d),
                  torch.zeros((H, per, D), device=d)) for d in devs]
        return qs, ks, vs, es, ps, state

    def bucket(es, my, src):
        """(owner-local query ids, chunk-local key ids, mask) of bucket
        (my, src) on rank my."""
        eq, ek, em = (e[my][0, src] for e in es[:3])
        return eq.long() - my * per, ek.long() - src * per, em

    def finish(state, device):
        outs = [acc / torch.where(l > 0, l, torch.ones_like(l))[..., None]
                for _, l, acc in state]
        return gather_rows(outs, 1, device)

    def local(q, k, v, edge_q, edge_k, edge_mask, sigma, gamma, cov_inv,
              keep=None):
        qs, kc, vc, es, ps, state = setup(
            q, k, v, (edge_q, edge_k, edge_mask), (sigma, gamma, cov_inv))
        keeps = None if keep is None else _shards(mesh, keep, 1)
        for step in range(g):
            for my in range(g):
                src = (my - step) % g
                kp = None if keeps is None else keeps[my][:, 0, src]
                state[my] = _fold_chunk(
                    metric, qs[my], kc[my], vc[my], *bucket(es, my, src),
                    *state[my], per, *ps[my], neg, keep=kp, keep_inv=inv)
            if step < g - 1:
                kc, vc = circulate(kc), circulate(vc)
        return finish(state, q.device)

    def local_biased(q, k, v, edge_q, edge_k, edge_mask, bias, sigma, gamma,
                     cov_inv, keep=None):
        qs, ks, vs, es, ps, state = setup(
            q, k, v, (edge_q, edge_k, edge_mask, bias),
            (sigma, gamma, cov_inv))
        keeps = None if keep is None else _shards(mesh, keep, 2)
        # pass A: the first softmax's (max, sum); K circulates alone
        first = [st[:2] for st in state]
        kc = ks
        for step in range(g):
            for my in range(g):
                src = (my - step) % g
                eqs, eks, ems = bucket(es, my, src)
                s_e = _edge_scores(metric, qs[my], kc[my], eqs, eks, ems,
                                   *ps[my], neg)
                first[my] = _fold_scores(s_e, eqs, ems, *first[my], None,
                                         per, neg)
            if step < g - 1:
                kc = circulate(kc)
        # pass B: the second softmax over w_e + bias_e
        kc, vc = ks, vs
        for step in range(g):
            for my in range(g):
                src = (my - step) % g
                kp1 = kp2 = None
                if keeps is not None:
                    kp1 = keeps[my][0, :, 0, src]
                    kp2 = keeps[my][1, :, 0, src]
                state[my] = _fold_biased_chunk(
                    metric, qs[my], kc[my], vc[my], *bucket(es, my, src),
                    es[3][my][0, src], *first[my], *state[my], per,
                    *ps[my], neg, keep1=kp1, keep2=kp2, keep_inv=inv)
            if step < g - 1:
                kc, vc = circulate(kc), circulate(vc)
        return finish(state, q.device)

    return local_biased if biased else local


def ring_edge_attention(
    mesh: Mesh, metric: str,
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,   # [H, N, D]
    edge_q, edge_k, edge_mask,     # [G, G, Ep] from *_by_query_and_key
    *, sigma=None, gamma=None, cov_inv=None,
) -> torch.Tensor:
    """Edge attention over the ring: K/V shards circulate while each rank
    folds the chunk it holds into a streaming segment softmax for its
    queries. The standalone wrapper of `make_ring_attention`."""
    H, N, D = q.shape
    fn = make_ring_attention(mesh, metric, H, N, D)
    sigma, gamma, cov_inv = metric_placeholders(
        H, D, q.dtype, sigma, gamma, cov_inv, q.device)
    return fn(q, k, v, edge_q, edge_k, edge_mask, sigma, gamma, cov_inv)


def metric_placeholders(H: int, Dh: int, dtype, sigma=None, gamma=None,
                        cov_inv=None, device=None):
    """Stand-ins matching ``ops.distances``' None defaults (sigma and
    gamma 1, mahalanobis' cov_inv the identity)."""
    if sigma is None:
        sigma = torch.ones((H,), dtype=dtype, device=device)
    if gamma is None:
        gamma = torch.ones((H,), dtype=dtype, device=device)
    if cov_inv is None:
        cov_inv = torch.eye(Dh, dtype=dtype, device=device).expand(
            H, Dh, Dh)
    return sigma, gamma, cov_inv


def scaling_report(mesh: Mesh, edges_per_sec_1chip: float,
                   edges_per_sec_mesh: float) -> dict:
    """Scaling efficiency: (mesh throughput / ranks) / one rank's."""
    n = mesh.size
    per_chip = edges_per_sec_mesh / n
    return {
        "chips": int(n),
        "edges_per_sec_total": edges_per_sec_mesh,
        "edges_per_sec_per_chip": per_chip,
        "scaling_efficiency": per_chip / edges_per_sec_1chip
        if edges_per_sec_1chip > 0 else 0.0,
    }
