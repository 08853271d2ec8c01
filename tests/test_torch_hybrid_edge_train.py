"""Training the port's edge-feature hybrid backend against the JAX
package's on the CPU: the compact plain biased backward (what B6c, B7a c
and B7b c compute) and its three parts against ``_band_bwd_pre`` and
``_band_bwd_dq_dkv`` in interpret mode and against the dense plain
biased backward; ``hybrid_biased_attention``'s, ``apply_hybrid``'s and
the model's gradients against ``jax.grad``; trainer steps over the
loader's ``plan="hybrid"`` with edge features; the bias store's
backward. The JAX side plans at 16 x 32 tiles, the port at its kernels'
64 x 64: every result is held equal, the bias gradient per edge
(gathered from each side's store), never store against store."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tagan_torch as pt
import tagan_tpu as tt
from tagan_torch.convert import params_from_jax
from tagan_torch.nn.geometric import GeometricAttention as TGA
from tagan_torch.nn.model import hybrid_bias_store, hybrid_residual_bias
from tagan_torch.ops import flash_geometric as TFG
from tagan_torch.ops import hybrid_biased as THB
from tagan_tpu.data.dataset import TemporalGraphDataLoader as JLoader
from tagan_tpu.data.dataset import TemporalGraphDataset as JDataset
from tagan_tpu.nn.geometric import GeometricAttention as JGA
from tagan_tpu.ops.pallas import flash_geometric as JFG
from tagan_tpu.ops.pallas import hybrid_biased as JHB
from tagan_tpu.train.trainer import TAGANTrainer as JTrainer

# torch's CPU operations on one thread: the tier-1 command runs six
# pytest workers on 8 cores, and torch's default of a thread per core
# oversubscribes them
torch.set_num_threads(1)

# fp32 on both sides, sums in another order (64 x 64 tiles against
# 16 x 32): outputs within 1e-5, gradients and parameters within 1e-4 of
# the largest entry
TOL_OUT = 1e-5
TOL = 1e-4
BM, BN = 16, 32          # the JAX side's tile
TILE = 64                # the port's
N, T, F, E, FE = 70, 2, 8, 160, 4
# gradients that are zero in exact arithmetic: the temporal attention's
# key and time-query biases add one constant to every score of a row
ZERO_GRAD = ("temporal_attention.k.b",
             "temporal_attention.time_encoding.basis_proj.b",
             "temporal_attention.time_q_proj.b")


@pytest.fixture(scope="module")
def interpret():
    import jax.experimental.pallas as pl
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JFG.pl, "pallas_call",
                   functools.partial(pl.pallas_call, interpret=True))
        yield


def _t(a):
    return torch.from_numpy(np.array(a))


def _err(got, want):
    """max |got - want| over the largest entry of want (at least 1)."""
    want = np.asarray(want, np.float64)
    got = np.asarray(got.detach().numpy() if torch.is_tensor(got) else got,
                     np.float64)
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


def _snaps(seed, n=N, e=E, steps=T, near_frac=0.85, dup=0):
    """Banded snapshots with Fe = 4 N(0, 1) edge features (85% of edges
    within 12 slots of their source, the rest uniform: a non-empty
    residual), some nodes inactive in the second snapshot (dead rows);
    ``dup`` edges of each snapshot repeated (duplicate pairs)."""
    rng = np.random.default_rng(seed)
    out = []
    for t in range(steps):
        src = rng.integers(0, n, e - dup)
        near = np.clip(src + rng.integers(-12, 13, e - dup), 0, n - 1)
        dst = np.where(rng.random(e - dup) < near_frac, near,
                       rng.integers(0, n, e - dup))
        src, dst = np.concatenate([src, src[:dup]]), \
            np.concatenate([dst, dst[:dup]])
        ids = np.arange(n) if t == 0 else np.arange(n - 3)
        keep = (src < len(ids)) & (dst < len(ids))
        out.append({
            "x": rng.standard_normal((len(ids), F)).astype(np.float32),
            "edge_index": np.stack([src[keep], dst[keep]]),
            "edge_attr": rng.standard_normal(
                (int(keep.sum()), FE)).astype(np.float32),
            "node_ids": ids, "timestep": float(t)})
    return out


def _pair(snaps, pack=True, band_width=None):
    """(JAX sequence at 16 x 32 tiles with the padded residual tables, the
    port's at 64 x 64 with the transposed walk)."""
    kw = dict(max_nodes=N, max_edges=E, max_time=T, edge_feature_dim=FE,
              dense_adj=False)
    js = tt.build_sequence(snaps, **kw).with_hybrid_plan(
        band_width=band_width, block_m=BM, block_n=BN, padded_residual=True)
    ts = pt.build_sequence(snaps, **kw).with_hybrid_plan(
        band_width=band_width, pack=pack, transposed=True)
    return js, ts


def _jplan(js, t):
    """Snapshot t's walks as numpy (constants under ``jax.jit``)."""
    return (tuple(np.asarray(p)[t] for p in js.hyb_plan),
            tuple(np.asarray(p)[t] for p in js.hyb_plan_t))


def _jsnap(js, t):
    """(walks, padded residual tables, mask store) of snapshot t, numpy."""
    return (_jplan(js, t), tuple(np.asarray(a)[t] for a in js.hyb_res_pad),
            np.asarray(js.hyb_mask_blocks)[t])


def _jbias(js, t, b):
    """JAX snapshot t's bias store [S, 16, 32] and padded residual bias
    from the per-edge bias b [T, E] (a jax array: differentiable)."""
    slot = np.asarray(js.hyb_band_slot)[t]
    on = np.nonzero(slot >= 0)[0]
    src, dst = np.asarray(js.edge_src)[t], np.asarray(js.edge_dst)[t]
    S = np.asarray(js.hyb_mask_blocks).shape[1]
    store = jnp.zeros((S, BM, BN), jnp.float32).at[
        slot[on], src[on] % BM, dst[on] % BN].add(b[t][on])
    bid = np.asarray(js.hyb_res_bid)[t]
    res = jnp.where(bid >= 0, b[t][np.clip(bid, 0, E - 1)], 0.0)
    return store, res


def _tbias(ts, b):
    """The port's bias store and residual bias from b [T, E]."""
    b = torch.where(ts.edge_mask, b, torch.zeros(()))
    return hybrid_bias_store(b, ts), hybrid_residual_bias(b, ts)


def _edge_db(db, seq, t, tm, tn):
    """A bias store's cotangent [S, tm, tn] of snapshot t read at each
    band edge's pair (0 for the other edges): numpy [E]."""
    db = np.asarray(db.detach() if torch.is_tensor(db) else db)
    slot = np.asarray(seq.hyb_band_slot)[t]
    on = slot >= 0
    src, dst = np.asarray(seq.edge_src)[t], np.asarray(seq.edge_dst)[t]
    out = np.zeros(slot.shape, np.float32)
    out[on] = db[slot[on], src[on] % tm, dst[on] % tn]
    return out


def _qkv(seed, metric, H=2, D=16, Dv=8):
    rng = np.random.default_rng(seed)
    q, k = (rng.standard_normal((H, N, D)).astype(np.float32)
            for _ in range(2))
    if metric in TFG._COSINE:
        q = q / np.linalg.norm(q, axis=-1, keepdims=True)
        k = k / np.linalg.norm(k, axis=-1, keepdims=True)
    v, do = (rng.standard_normal((H, N, Dv)).astype(np.float32)
             for _ in range(2))
    return q, k, v, do


# ---------------------------------------------------------------------------
# The compact plain biased backward against the Pallas kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("metric,rate", [
    ("euclidean", 0.1), ("scaled_dot_product", 0.0),
    ("gaussian_kernel", 0.1), ("cosine_similarity", 0.0)])
def test_compact_plain_biased_backward_matches_pallas(metric, rate,
                                                      interpret):
    """B6c's, B7a c's and B7b c's plain versions against JAX's
    ``_band_bwd_pre`` and ``_band_bwd_dq_dkv`` at 16 x 32 tiles, on union
    statistics (the band's lse1 and lse2 merged with a second
    logsumexp each, delta1 the band's plus a residual's, as the hybrid
    backward passes them; the forward's from the port's plain B4c and
    B5c, held against JAX's in `test_torch_hybrid.py`): delta1, dB per
    band edge, dq, dscale
    (gaussian), dk and dv; both dropouts from the same seed pair, the bit
    and the int8 store; and `_biased_backward_compact` (the CPU dispatch)
    giving the same within 1e-5 with the residual's delta1 added."""
    js, ts = _pair(_snaps(5))
    ts_i8 = _pair(_snaps(5), pack=False)[1]
    q, k, v, do = _qkv(6, metric)
    rng = np.random.default_rng(7)
    b = rng.standard_normal((T, E)).astype(np.float32)
    other1, other2, delta2, d1_rest = (
        rng.standard_normal((2, N)).astype(np.float32) for _ in range(4))
    scale = np.asarray([0.7, 1.6], np.float32)
    seeds = np.asarray([12345, 12345 ^ 0x5BD1E995], np.int32)
    need = metric in TFG.SCALED_METRICS
    t = 1
    (jplan, jplan_t), _, mb = _jsnap(js, t)
    tbs = _tbias(ts, _t(b))[0][t:t + 1]
    # the union statistics from the port's plain forward (held against
    # ``_band_lse1`` / ``_band_biased_main`` in `test_torch_hybrid.py`)
    fwd = (*(_t(a)[None] for a in (q, k, v)), ts.hyb_mask_blocks[t:t + 1])
    plan1 = tuple(p[t:t + 1] for p in ts.hyb_plan)
    l1u = THB.lse_union(TFG.flash_lse1_compact_plain(
        *fwd[:2], fwd[3], *plan1, metric, _t(scale)), _t(other1)[None])
    l2u = THB.lse_union(TFG.flash_biased_forward_compact_plain(
        *fwd, tbs, l1u, *plan1, metric, _t(scale), rate,
        _t(seeds)[None])[1], _t(other2)[None])
    l1u, l2u = l1u[0].numpy(), l2u[0].numpy()
    kw = dict(metric=metric, block_m=BM, block_n=BN, bf16=False,
              dropout_rate=rate)

    @jax.jit
    def jax_side(q, k, v, do, b, l1u, l2u, delta2, d1_rest):
        sc, sd = jnp.asarray(scale), jnp.asarray(seeds)
        jbs = _jbias(js, t, b)[0]
        d1, db = JHB._band_bwd_pre(q, k, v, mb, jbs, do, l1u, l2u, delta2,
                                   jplan, sc, sd, **kw)
        d1u = d1 + d1_rest
        return d1, db, d1u, JHB._band_bwd_dq_dkv(
            q, k, v, mb, jbs, do, l1u, l2u, delta2, d1u, jplan, jplan_t, sc,
            sd, need_dscale=need, **kw)
    j_d1, j_db, d1u, want = jax_side(
        *(jnp.asarray(a) for a in (q, k, v, do, b, l1u, l2u, delta2,
                                   d1_rest)))
    want_db = _edge_db(j_db, js, t, BM, BN)
    assert np.abs(want_db).max() > 0
    for seq in (ts, ts_i8):
        st = seq.hyb_mask_blocks[t:t + 1]
        plan = tuple(p[t:t + 1] for p in seq.hyb_plan)
        plan_t = tuple(p[t:t + 1] for p in seq.hyb_plan_t)
        args = (*(_t(a)[None] for a in (q, k, v)), st, tbs, _t(do)[None],
                *(_t(a)[None] for a in (l1u, l2u, delta2)))
        tail = (metric, _t(scale), rate, _t(seeds)[None])
        d1, db = TFG.flash_biased_bwd_pre_compact_plain(*args, *plan, *tail)
        assert _err(d1[0], j_d1) <= TOL
        assert _err(_edge_db(db[0], seq, t, TILE, TILE), want_db) <= TOL
        tu = _t(d1u)[None]
        dq, dsc = TFG.flash_biased_bwd_dq_compact_plain(
            *args, tu, *plan, *tail, need)
        dk, dv = TFG.flash_biased_bwd_dkv_compact_plain(*args, tu, *plan,
                                                        *tail)
        for g, w in zip((dq, dk, dv), want[:3]):
            assert _err(g[0], w) <= TOL
        if need:
            assert _err(dsc, want[3]) <= TOL
        else:
            assert dsc is None
        got = TFG._biased_backward_compact(
            *args, plan, plan_t, metric, _t(scale), rate, _t(seeds)[None],
            need, _t(d1_rest)[None])
        # the same sums, delta1 from the port's B6c plain part
        for g, w in zip(got, (dq, dk, dv, db, dsc, tu)):
            if w is not None:
                assert _err(g, w.numpy()) <= TOL_OUT


@pytest.mark.parametrize("pack", [True, False])
def test_compact_plain_biased_backward_matches_dense(pack):
    """The compact plain biased backward against the dense plain one
    (held against Pallas in `test_torch_edge_bwd.py`) where the port's
    64 x 64 tiling has edge cases the JAX side's 16 x 32 does not reach:
    a row tile with jcount = 0, a key tile with icount = 0 (dk and dv
    exactly zero there), N not a multiple of 64, dead rows, every metric
    with its dscale, dropout; dB in the store's slots equal to the dense
    dB moved there, and 0 in the slots no walk visits (snapshot 1 has
    fewer occupied tiles than the store's S)."""
    G, H, n, D, Dv = 2, 2, 150, 16, 8
    rng = np.random.default_rng(3)
    mask = torch.from_numpy(rng.random((G, n, n)) < 0.06)
    mask[1, 64:128] = False
    mask[1, :, 128:] = False
    mask[0, :, 64:128] = False
    mask[:, 5] = False
    store, plan = TFG.compact_from_mask(mask, pack=pack)
    S = store.shape[1]
    walked = plan[1].sum((-1,)).tolist()
    assert walked[1] < S and int(plan[1][1, 1]) == 0
    assert int(TFG.compact_transposed_plan(mask)[1][0, 1]) == 0
    bias = torch.from_numpy(rng.standard_normal((G, n, n)).astype(np.float32))
    bst = TFG.compact_values(mask, bias)
    for metric in JFG.MXU_METRICS:
        q, k = (torch.from_numpy(rng.standard_normal((G, H, n, D)).astype(
            np.float32)) for _ in range(2))
        if metric in TFG._COSINE:
            q, k = TFG._l2_normalize(q), TFG._l2_normalize(k)
        v, do = (torch.from_numpy(rng.standard_normal((G, H, n, Dv)).astype(
            np.float32)) for _ in range(2))
        scale = torch.tensor([0.8, 1.5])
        seeds = torch.tensor([[9, 3], [-4, 7]], dtype=torch.int32)
        need = metric in TFG.SCALED_METRICS
        lse1 = TFG.flash_lse1_plain(q, k, mask, metric, scale)
        out, lse2 = TFG.flash_biased_forward_plain(q, k, v, mask, bias, lse1,
                                                   metric, scale, 0.2, seeds)
        want = TFG.flash_biased_backward_plain(q, k, v, mask, bias, out, lse1,
                                               lse2, do, metric, scale, 0.2,
                                               seeds, need)
        got = TFG.flash_biased_backward_compact_plain(
            q, k, v, store, bst, out, lse1, lse2, do, *plan, metric, scale,
            0.2, seeds, need)
        for g, w in zip(got[:3], want[:3]):
            assert _err(g, w.numpy()) <= TOL_OUT
        want_db = TFG.compact_values(mask, torch.where(mask != 0, want[3],
                                                       torch.zeros(())))
        assert _err(got[3], want_db.numpy()) <= TOL_OUT
        assert torch.all(got[3][1, walked[1]:] == 0)
        assert got[3].abs().max() > 0
        if need:
            assert _err(got[4], want[4].numpy()) <= TOL_OUT
        assert torch.all(got[1][0, :, 64:128] == 0)
        assert torch.all(got[2][0, :, 64:128] == 0)


# ---------------------------------------------------------------------------
# Gradients through hybrid_biased_attention, apply_hybrid and the model
# ---------------------------------------------------------------------------

def _live_cotangent(wo, ts):
    """The output cotangent [T, H, N, Dv] set to 0 on rows with no edge
    (the inactive nodes: an active node's self loop is a band edge), as
    the model's is (`apply_hybrid` keeps such rows' input). JAX's
    recompute forms w2 = exp(z - lse2) with z = NEG_INF off the mask,
    which is 1 on a row whose union lse2 is the merge's NEG_INF dead
    mark, so a non-zero cotangent there enters its dv; the port's w2 is
    0 off the mask (ROADMAP C10)."""
    return wo * np.asarray(ts.node_mask)[:, None, :, None]


@pytest.mark.parametrize("metric", ["euclidean", "cosine_similarity"])
def test_hybrid_biased_attention_gradients_match_jax(metric, interpret):
    """``hybrid_biased_attention`` under autograd (both snapshots folded,
    a non-empty residual) against ``jax.grad`` of JAX's
    ``hybrid_biased_attention`` (its ``_hybrid_biased`` custom_vjp) per
    snapshot: the output within 1e-5, the gradients of q, k, v, the
    per-head scale and the per-edge bias b (through each side's bias
    store and residual bias) within 1e-4; cosine normalised outside the
    Function on both sides."""
    js, ts = _pair(_snaps(8), pack=metric != "gaussian_kernel")
    assert ts.hyb_res[2].any()
    rng = np.random.default_rng(9)
    H, D, Dv = 2, 16, 8
    q, k = (rng.standard_normal((T, H, N, D)).astype(np.float32)
            for _ in range(2))
    v, wo = (rng.standard_normal((T, H, N, Dv)).astype(np.float32)
             for _ in range(2))
    b = rng.standard_normal((T, E)).astype(np.float32)
    scale = np.asarray([0.9, 1.3], np.float32)
    wo = _live_cotangent(wo, ts)

    snap = [_jsnap(js, t) for t in range(T)]

    def jouts(q, k, v, sc, b):
        outs = []
        for t, ((plan, plan_t), res_pad, mb) in enumerate(snap):
            qt, kt = q[t], k[t]
            if metric in TFG._COSINE:
                qt, kt = JFG._l2_normalize(qt), JFG._l2_normalize(kt)
            bs, br = _jbias(js, t, b)
            outs.append(JHB.hybrid_biased_attention(
                qt, kt, v[t], mb, plan, plan_t, res_pad, bs, br,
                metric=metric, scale_param=sc, block_m=BM, block_n=BN))
        return jnp.stack(outs)
    j_out, want = jax.jit(lambda *a: (jouts(*a), jax.grad(
        lambda *a: jnp.sum(jouts(*a) * wo), argnums=(0, 1, 2, 3, 4))(*a)))(
        *(jnp.asarray(a) for a in (q, k, v, scale, b)))
    leaves = [_t(a).requires_grad_() for a in (q, k, v, scale, b)]
    bb, rb = _tbias(ts, leaves[4])
    out = THB.hybrid_biased_attention(
        *leaves[:3], ts.hyb_mask_blocks, ts.hyb_plan, ts.hyb_res, bb, rb,
        metric, leaves[3], plan_t=ts.hyb_plan_t)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out),
                               rtol=TOL_OUT, atol=TOL_OUT)
    (out * _t(wo)).sum().backward()
    for leaf, w in zip(leaves, want):
        assert torch.isfinite(leaf.grad).all()
        assert _err(leaf.grad, w) <= TOL
    assert np.abs(np.asarray(want[4])).max() > 0


def test_dropout_with_empty_residual_matches_jax(interpret):
    """With every edge in the band (an empty residual), both sides'
    dropout is the band's coordinate hash from the same seeds, bit for
    bit: ``hybrid_biased_attention`` at rate 0.2 and its gradients of q,
    k, v and the per-edge bias against JAX's."""
    js, ts = _pair(_snaps(10), band_width=N)
    assert not ts.hyb_res[2].any()
    rng = np.random.default_rng(11)
    H, D, Dv = 2, 16, 8
    q, k = (rng.standard_normal((T, H, N, D)).astype(np.float32)
            for _ in range(2))
    v, wo = (rng.standard_normal((T, H, N, Dv)).astype(np.float32)
             for _ in range(2))
    b = rng.standard_normal((T, E)).astype(np.float32)
    seeds = np.asarray([77, -31], np.int32)
    wo = _live_cotangent(wo, ts)

    snap = [_jsnap(js, t) for t in range(T)]

    def jouts(q, k, v, b):
        outs = []
        for t, ((plan, plan_t), res_pad, mb) in enumerate(snap):
            bs, br = _jbias(js, t, b)
            outs.append(JHB.hybrid_biased_attention(
                q[t], k[t], v[t], mb, plan, plan_t, res_pad, bs, br,
                metric="euclidean", block_m=BM, block_n=BN,
                dropout_rate=0.2, dropout_seeds=jnp.asarray(seeds[t:t + 1]),
                dropout_rng=jax.random.key(t)))
        return jnp.stack(outs)
    j_out, want = jax.jit(lambda *a: (jouts(*a), jax.grad(
        lambda *a: jnp.sum(jouts(*a) * wo), argnums=(0, 1, 2, 3))(*a)))(
        *(jnp.asarray(a) for a in (q, k, v, b)))
    leaves = [_t(a).requires_grad_() for a in (q, k, v, b)]
    bb, rb = _tbias(ts, leaves[3])
    out = THB.hybrid_biased_attention(
        *leaves[:3], ts.hyb_mask_blocks, ts.hyb_plan, ts.hyb_res, bb, rb,
        "euclidean", dropout_rate=0.2, dropout_seed=_t(seeds),
        generator=torch.Generator().manual_seed(0), plan_t=ts.hyb_plan_t)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out),
                               rtol=TOL_OUT, atol=TOL_OUT)
    (out * _t(wo)).sum().backward()
    for leaf, w in zip(leaves, want):
        assert torch.isfinite(leaf.grad).all()
        assert _err(leaf.grad, w) <= TOL


@pytest.mark.parametrize("metric", ["gaussian_kernel", "mahalanobis"])
def test_apply_hybrid_edge_gradients_match_jax(metric, interpret):
    """``apply_hybrid`` with the band bias store and the residual bias
    (both snapshots folded into one call) against ``jax.grad`` of JAX's
    per snapshot: every parameter's gradient, the input's and the
    per-edge bias's; a learnable gaussian scale and mahalanobis factors;
    inactive rows keep their input."""
    js, ts = _pair(_snaps(13))
    kw = dict(hidden_dim=16, num_heads=2, distance_metric=metric,
              learnable_distance=metric in ("gaussian_kernel",
                                            "mahalanobis"), dropout=0.0)
    jattn = JGA(**kw)
    jp = jattn.init(jax.random.key(4))
    tattn = TGA(**kw)
    tattn.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jp)))
    rng = np.random.default_rng(14)
    x = rng.standard_normal((T, N, 16)).astype(np.float32)
    w = rng.standard_normal((T, N, 16)).astype(np.float32)
    b = rng.standard_normal((T, E)).astype(np.float32)

    snap = [_jsnap(js, t) for t in range(T)]
    res = [tuple(np.asarray(a)[t] for a in js.hyb_res) for t in range(T)]
    node_mask = np.asarray(js.node_mask)

    def jloss(p, x, b):
        total = 0.0
        for t, ((cplan, cplan_t), res_pad, mb) in enumerate(snap):
            bs, br = _jbias(js, t, b)
            y = jattn.apply_hybrid(
                p, x[t], mb, cplan, cplan_t, *res[t], node_mask[t],
                block_m=BM, block_n=BN, res_pad=res_pad, band_bias=bs,
                res_bias=br)
            total = total + jnp.sum(y * w[t])
        return total
    jgp, jgx, jgb = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(
        jp, jnp.asarray(x), jnp.asarray(b))
    tx, tb = _t(x).requires_grad_(), _t(b).requires_grad_()
    bb, rb = _tbias(ts, tb)
    y = tattn.apply_hybrid(tx, ts.hyb_mask_blocks, ts.hyb_plan, ts.hyb_res,
                           ts.node_mask, None, bb, rb, ts.hyb_plan_t)
    (y * _t(w)).sum().backward()
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jgp))
    for name, param in tattn.named_parameters():
        assert torch.isfinite(param.grad).all(), name
        assert _err(param.grad, want[name]) <= TOL, name
    assert _err(tx.grad, jgx) <= TOL
    assert _err(tb.grad, jgb) <= TOL
    inactive = ~ts.node_mask[1]
    assert torch.all(tx.grad[1][inactive] == _t(w)[1][inactive])


def _models(**over):
    cfg = dict(hidden_dim=16, num_heads=2, num_layers=2, node_feature_dim=F,
               edge_feature_dim=FE, use_edge_features=True, output_dim=1,
               loss_type="bce", dropout=0.0, spatial_backend="hybrid",
               learning_rate=1e-2, weight_decay=0.05, gradient_clip_val=0.1)
    cfg.update(over)
    jm = tt.TAGAN(tt.TAGANConfig(**cfg))
    jp = jm.init(jax.random.key(0))
    tm = pt.TAGAN(pt.TAGANConfig(**cfg), device="cpu")
    tm.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jp)))
    return jm, jp, tm


def test_model_gradients_match_jax(interpret):
    """d(loss)/d(every parameter) of the edge-feature ``TAGAN(
    spatial_backend="hybrid")`` on one sequence with a non-empty residual
    and duplicate edges, against ``jax.grad`` of JAX's model: the edge
    embedding and each layer's edge bias included. Each gradient within
    1e-4 of its largest entry; one that is zero in exact arithmetic stays
    at fp32 noise."""
    jm, jp, tm = _models()
    js, ts = _pair(_snaps(21, dup=6))
    assert ts.hyb_res[2].any()
    y = np.float32(1.0)
    jloss, jg = jax.jit(jax.value_and_grad(
        lambda p: jm(p, js, jnp.asarray(y)).loss))(jp)
    loss = tm(ts, torch.tensor(y)).loss
    loss.backward()
    assert abs(loss.item() - float(jloss)) <= TOL_OUT
    want = {n: np.asarray(w) for n, w in params_from_jax(
        jax.tree_util.tree_map(np.asarray, jg)).items()}
    got = dict(tm.named_parameters())
    assert set(got) == set(want)
    assert any("edge_bias" in n for n in got) and "edge_embedding.w" in got
    noise = 1e-6 * max(np.abs(w).max() for w in want.values())
    for name, param in got.items():
        g, w = param.grad, want[name]
        assert torch.isfinite(g).all(), name
        m = np.abs(w).max()
        if m < noise:
            assert g.abs().max().item() < noise, name
        else:
            assert np.abs(g.numpy() - w).max() <= TOL * m, name


def test_trainer_steps_match_jax(interpret):
    """3 steps of both trainers over ``plan="hybrid"`` loaders with
    Fe = 4 edge features (one sequence per batch; the JAX loader plans at
    16 x 32 with the padded residual) from the same parameters: clipping,
    AdamW with weight decay. The losses and, after every step, the
    parameters agree within 1e-4."""
    data = [_snaps(30 + s) for s in range(3)]
    labels = [1.0, 0.0, 1.0]
    exp = dict(batch_size=1, num_epochs=1, seed=0)
    jm, jp, tm = _models()
    jt = JTrainer(jm, tt.ExperimentConfig(model=jm.config, **exp), params=jp)
    # the same values, strongly typed as the first step returns them: the
    # JAX step then compiles once, not twice
    jt.params, jt.opt_state = jax.tree_util.tree_map(
        lambda x: jnp.asarray(x, jnp.asarray(x).dtype),
        (jt.params, jt.opt_state))
    tr = pt.TAGANTrainer(tm, pt.ExperimentConfig(model=tm.config, **exp))
    jl = JLoader(JDataset(data, labels), batch_size=1, dense_adj=False,
                 plan="hybrid", plan_kwargs=dict(block_m=BM, block_n=BN,
                                                 padded_residual=True))
    tl = pt.TemporalGraphDataLoader(pt.TemporalGraphDataset(data, labels),
                                    batch_size=1, dense_adj=False,
                                    plan="hybrid")
    steps = 0
    for (jb, jy, jmask), (tb, ty, tmask) in zip(jl, tl):
        jt.rng, r = jax.random.split(jt.rng)
        jt.params, jt.opt_state, jloss, _ = jt._train_step(
            jt.params, jt.opt_state, jb, jy, jmask, r, jnp.asarray(1.0))
        tloss, _ = tr._train_step(tb, ty, tmask)
        steps += 1
        assert abs(tloss.item() - float(jloss)) <= TOL
        want = params_from_jax(jax.tree_util.tree_map(np.asarray, jt.params))
        for name, param in tm.named_parameters():
            if name in ZERO_GRAD:
                assert torch.isfinite(param).all(), name
                continue
            np.testing.assert_allclose(param.detach().numpy(), want[name],
                                       rtol=TOL, atol=TOL, err_msg=name)
    assert steps == 3 and tr.optimizer.count == 3


# ---------------------------------------------------------------------------
# The bias store's backward
# ---------------------------------------------------------------------------

def test_bias_store_backward():
    """``hybrid_bias_store``'s and ``hybrid_residual_bias``'s backward
    (autograd of the segment sum and of the gather; the JAX custom vjp's
    ``_sbs_bwd``): a band edge gets the store's cotangent at its pair, a
    duplicate edge its pair's too, an explicit self-loop edge (a band
    edge, as in JAX) the diagonal's; residual and invalid edges get 0
    from the store, and each residual edge the residual bias's cotangent
    at its slot. The self loops the plan adds for active nodes are no
    edges: their pairs' cotangent reaches no bias."""
    snaps = _snaps(40, dup=8)
    snaps[0]["edge_index"][:, -2:] = [[3, 9], [3, 9]]       # self loops
    ts = _pair(snaps)[1]
    rng = np.random.default_rng(41)
    b = torch.from_numpy(rng.standard_normal((T, E)).astype(
        np.float32)).requires_grad_()
    bb, rb = _tbias(ts, b)
    g_store = torch.from_numpy(rng.standard_normal(bb.shape).astype(
        np.float32))
    g_res = torch.from_numpy(rng.standard_normal(rb.shape).astype(
        np.float32))
    ((bb * g_store).sum() + (rb * g_res).sum()).backward()
    eid = ts.hyb_res_eid.numpy()
    for t in range(T):
        want = _edge_db(g_store[t], ts, t, TILE, TILE)
        for r, e in enumerate(eid[t]):
            if e >= 0:
                want[e] += g_res[t, r].item()
        np.testing.assert_array_equal(b.grad[t].numpy(), want)
    slot = ts.hyb_band_slot[0].numpy()
    s0, d0 = ts.edge_src[0].numpy(), ts.edge_dst[0].numpy()
    valid = ts.edge_mask[0].numpy()
    band = slot >= 0
    assert np.all(band[valid & (s0 == d0)])
    assert np.all(b.grad[0].numpy()[~valid] == 0)
    pairs = {}
    for e in np.nonzero(band)[0]:
        pairs.setdefault((s0[e], d0[e]), []).append(b.grad[0, e].item())
    dups = [g for g in pairs.values() if len(g) > 1]
    assert dups and all(len(set(g)) == 1 for g in dups)
    res = set(eid[0][eid[0] >= 0].tolist())
    assert res and not band[list(res)].any()
