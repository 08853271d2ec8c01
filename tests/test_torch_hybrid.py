"""The port's hybrid (band + residual) backend against the JAX package's
on the CPU: the plan (split, store, walks), the plain versions of the
compact-store kernels (B1c, B4c, B5c) against the Pallas kernels in
interpret mode, the residual partials and their merge, ``apply_hybrid``
and the model, with converted parameters and numpy inputs. The JAX side
builds its plans at 16 x 32 tiles, the port at its kernels' 64 x 64: the
split, the dropout hash and every result do not depend on the tile."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tagan_torch as pt
import tagan_tpu as tt
from tagan_torch.core.graph import (attach_hybrid_plans, hybrid_plan_dims,
                                    merge_hybrid_dims)
from tagan_torch.nn.geometric import GeometricAttention as TGA
from tagan_torch.nn.model import hybrid_bias_store, hybrid_residual_bias
from tagan_torch.ops import flash_geometric as TFG
from tagan_torch.ops import hybrid_biased as THB
from tagan_torch.ops import sparse as TS
from tagan_tpu.core.graph import pad_residual_edges
from tagan_tpu.nn.geometric import GeometricAttention as JGA
from tagan_tpu.ops import sparse as JS
from tagan_tpu.ops.pallas import flash_geometric as JFG
from tagan_tpu.ops.pallas import hybrid_biased as JHB

# torch's CPU operations on one thread: the tier-1 command runs six
# pytest workers on 8 cores, and torch's default of a thread per core
# oversubscribes them
torch.set_num_threads(1)

# fp32 on both sides, sums in another order (64-key tiles against 32-key
# tiles, one online softmax against another). Every comparison here holds
# like conventions: the band's scores take the norm expansion on both
# sides, the unbiased residual subtract-then-square on both sides, the
# biased residual the norm expansion on both sides.
TOL = 1e-4
BM, BN = 16, 32          # the JAX side's tile
N, T, F, E = 70, 2, 8, 160
METRICS4 = ("euclidean", "scaled_dot_product", "gaussian_kernel",
            "cosine_similarity")


@pytest.fixture(scope="module")
def interpret():
    import jax.experimental.pallas as pl
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JFG.pl, "pallas_call",
                   functools.partial(pl.pallas_call, interpret=True))
        yield


def _t(a):
    return torch.from_numpy(np.array(a))


def _snaps(seed, fe=0, n=N, e=E, steps=T):
    """Banded snapshots (85% of edges within 12 slots of their source,
    the rest uniform), some nodes inactive in the second snapshot."""
    rng = np.random.default_rng(seed)
    out = []
    for t in range(steps):
        src = rng.integers(0, n, e)
        near = np.clip(src + rng.integers(-12, 13, e), 0, n - 1)
        dst = np.where(rng.random(e) < 0.85, near, rng.integers(0, n, e))
        ids = np.arange(n) if t == 0 else np.arange(n - 3)
        keep = (src < len(ids)) & (dst < len(ids))
        s = {"x": rng.standard_normal((len(ids), F)).astype(np.float32),
             "edge_index": np.stack([src[keep], dst[keep]]),
             "node_ids": ids, "timestep": float(t)}
        if fe:
            s["edge_attr"] = rng.standard_normal(
                (int(keep.sum()), fe)).astype(np.float32)
        out.append(s)
    return out


def _pair(snaps, fe=0, band_width=None, pack=True):
    """(JAX sequence at 16 x 32 tiles with its padded residual tables,
    the port's sequence at 64 x 64)."""
    kw = dict(max_nodes=N, max_edges=E, max_time=T,
              edge_feature_dim=fe or None, dense_adj=False)
    js = tt.build_sequence(snaps, **kw).with_hybrid_plan(
        band_width=band_width, block_m=BM, block_n=BN, padded_residual=True)
    ts = pt.build_sequence(snaps, **kw).with_hybrid_plan(
        band_width=band_width, pack=pack)
    return js, ts


def _dense_from_store(store, plan, bm, bn, packed):
    """bool [N, N] of one snapshot's compact store, through its walk."""
    jl, jc, js = (np.asarray(a) for a in plan)
    store = np.asarray(store)
    n_i = jl.shape[0]
    dense = np.zeros((n_i * bm, (n_i * bm // bn + 1) * bn), bool)
    for i in range(n_i):
        for w in range(jc[i]):
            tile = store[js[i, w]]
            if packed:
                tile = TFG.unpack_bits(_t(tile)).numpy()
            dense[i * bm:(i + 1) * bm, jl[i, w] * bn:(jl[i, w] + 1) * bn] |= \
                tile != 0
    return dense[:N, :N]


# ---------------------------------------------------------------------------
# The plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("band_width", [None, 12])
def test_plan_split_matches_jax(band_width):
    """The band / residual split is JAX's array for array: the residual
    COO (padding included), each band edge's membership, and the
    residual slots' edge ids."""
    js, ts = _pair(_snaps(1), band_width=band_width)
    for got, want in zip(ts.hyb_res, js.hyb_res):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal((ts.hyb_band_slot >= 0).numpy(),
                                  np.asarray(js.hyb_band_slot) >= 0)
    band = np.asarray(js.hyb_band_slot) >= 0
    em = np.asarray(js.edge_mask)
    for t in range(T):
        ids = np.nonzero(em[t] & ~band[t])[0]
        eid = ts.hyb_res_eid[t].numpy()
        np.testing.assert_array_equal(eid[:ids.size], ids)
        assert np.all(eid[ids.size:] == -1)


@pytest.mark.parametrize("pack", [True, False])
def test_store_matches_jax_band_mask(pack):
    """The port's store, read through its walk, is JAX's band mask plus
    the self loops of active nodes (read through JAX's walk), in both
    forms; every walked tile has its own slot, and the plan pins and
    merges."""
    js, ts = _pair(_snaps(2), pack=pack)
    src, dst = ts.edge_src.numpy(), ts.edge_dst.numpy()
    band = ts.hyb_band_slot.numpy() >= 0
    nm = ts.node_mask.numpy()
    for t in range(T):
        want = np.zeros((N, N), bool)
        want[src[t][band[t]], dst[t][band[t]]] = True
        want[np.arange(N)[nm[t]], np.arange(N)[nm[t]]] = True
        jax_dense = _dense_from_store(
            js.hyb_mask_blocks[t], [p[t] for p in js.hyb_plan], BM, BN,
            False)
        got = _dense_from_store(ts.hyb_mask_blocks[t],
                                [p[t] for p in ts.hyb_plan], 64, 64, pack)
        np.testing.assert_array_equal(jax_dense, want)
        np.testing.assert_array_equal(got, want)
        jl, jc, jsl = (p[t].numpy() for p in ts.hyb_plan)
        slots = [jsl[i, w] for i in range(jl.shape[0]) for w in range(jc[i])]
        assert len(set(slots)) == len(slots)
    TFG.check_compact_plan(*ts.hyb_plan, ts.hyb_mask_blocks, N)
    dims = hybrid_plan_dims(ts)
    assert sorted(dims) == ["Er", "S", "Wj", "pack"] and dims["pack"] == pack
    with pytest.raises(ValueError, match="cannot merge"):
        merge_hybrid_dims([dims, dict(dims, pack=not pack)])
    seqs = [pt.build_sequence(s, max_nodes=N, max_edges=E, max_time=T,
                              dense_adj=False)
            for s in (_snaps(3), _snaps(4))]
    planned, pin = attach_hybrid_plans(seqs, pack=pack)
    assert all(hybrid_plan_dims(s) == pin for s in planned)
    batch = pt.batch_sequences(planned)
    assert batch.hyb_plan[0].shape[:2] == (2, T)
    small = dict(pin, S=1)
    with pytest.raises(ValueError, match="exceeds its pin"):
        seqs[0].with_hybrid_plan(pin=small)


# ---------------------------------------------------------------------------
# B1c, B4c, B5c: the plain versions against the Pallas kernels
# ---------------------------------------------------------------------------

def _qkv(seed, H=2, D=16, Dv=8):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((H, N, D)).astype(np.float32),
            rng.standard_normal((H, N, D)).astype(np.float32),
            rng.standard_normal((H, N, Dv)).astype(np.float32))


def _jplan(js, t):
    return (tuple(p[t] for p in js.hyb_plan),
            tuple(p[t] for p in js.hyb_plan_t))


@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("metric", JFG.MXU_METRICS)
def test_compact_forward_matches_pallas(metric, rate, interpret):
    """B1c's plain version (through `flash_geometric_attention_lse` with
    a 3-tuple plan, both store forms) against the Pallas kernel's compact
    form at 16 x 32 tiles: out and lse, D != Dv, per-head scales, the
    dropout hash bit for bit, a row with no band edge (an inactive
    node's)."""
    js, ts = _pair(_snaps(5))
    ts_i8 = pt.build_sequence(_snaps(5), max_nodes=N, max_edges=E,
                              max_time=T, dense_adj=False
                              ).with_hybrid_plan(pack=False)
    q, k, v = _qkv(6)
    scale = np.asarray([0.7, 1.6], np.float32)
    t = 1
    plan, plan_t = _jplan(js, t)
    j_out, j_lse = JFG.flash_geometric_attention_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), js.hyb_mask_blocks[t],
        metric=metric, scale_param=jnp.asarray(scale), block_m=BM,
        block_n=BN, plan=plan, plan_t=plan_t, dropout_rate=rate,
        dropout_seed=jnp.asarray([-77], jnp.int32) if rate else None)
    assert np.all(np.asarray(j_lse)[:, N - 1] == JFG.LSE_DEAD)
    for seq in (ts, ts_i8):
        out, lse = TFG.flash_geometric_attention_lse(
            _t(q)[None], _t(k)[None], _t(v)[None], seq.hyb_mask_blocks[t:t + 1],
            metric, _t(scale), plan=tuple(p[t:t + 1] for p in seq.hyb_plan),
            dropout_rate=rate,
            dropout_seed=torch.tensor([-77]) if rate else None)
        np.testing.assert_allclose(out[0].numpy(), np.asarray(j_out),
                                   rtol=TOL, atol=TOL)
        np.testing.assert_allclose(lse[0].numpy(), np.asarray(j_lse),
                                   rtol=TOL, atol=TOL)


def _band_bias(js, ts, t, b):
    """The per-edge bias b [T, E] in both packages' store slots."""
    jbs = np.zeros(np.asarray(js.hyb_mask_blocks).shape[1:], np.float32)
    slot = np.asarray(js.hyb_band_slot)[t]
    on = slot >= 0
    src, dst = np.asarray(js.edge_src)[t], np.asarray(js.edge_dst)[t]
    np.add.at(jbs, (slot[on], src[on] % BM, dst[on] % BN), b[t][on])
    tbs = hybrid_bias_store(torch.where(ts.edge_mask, _t(b),
                                        torch.zeros(())), ts)
    return jnp.asarray(jbs), tbs[t:t + 1]


@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("metric", METRICS4)
def test_band_biased_plain_matches_pallas(metric, rate, interpret):
    """B4c's and B5c's plain versions against ``_band_lse1`` and
    ``_band_biased_main`` at 16 x 32 tiles, B5c on a union lse1 (the band
    lse1 merged with a residual one), both dropouts from the same seed
    pair, both store forms."""
    js, ts = _pair(_snaps(7))
    q, k, v = _qkv(8)
    if metric in TFG._COSINE:
        q = q / np.linalg.norm(q, axis=-1, keepdims=True)
        k = k / np.linalg.norm(k, axis=-1, keepdims=True)
    scale = np.asarray([0.8, 1.4], np.float32)
    b = np.random.default_rng(9).standard_normal((T, E)).astype(np.float32)
    t = 0
    (cplan, _), jsc = _jplan(js, t), jnp.asarray(scale)
    kw = dict(metric=metric, block_m=BM, block_n=BN, bf16=False)
    j_l1 = JHB._band_lse1(jnp.asarray(q), jnp.asarray(k),
                          js.hyb_mask_blocks[t], cplan, jsc, **kw)
    other = jnp.asarray(np.random.default_rng(10).standard_normal(
        (2, N)).astype(np.float32))
    j_u = JHB._lse_union(j_l1, other)
    jbs, tbs = _band_bias(js, ts, t, b)
    seeds = np.asarray([12345, 12345 ^ 0x5BD1E995], np.int32)
    j_out, j_l2 = JHB._band_biased_main(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), js.hyb_mask_blocks[t],
        jbs, j_u, cplan, jsc, jnp.asarray(seeds), dropout_rate=rate, **kw)
    for pack in (True, False):
        seq = ts if pack else pt.build_sequence(
            _snaps(7), max_nodes=N, max_edges=E, max_time=T,
            dense_adj=False).with_hybrid_plan(pack=False)
        st = seq.hyb_mask_blocks[t:t + 1]
        plan = tuple(p[t:t + 1] for p in seq.hyb_plan)
        tq, tk, tv = (_t(a)[None] for a in (q, k, v))
        l1 = TFG.flash_lse1_compact_plain(tq, tk, st, *plan, metric,
                                          _t(scale))
        np.testing.assert_allclose(l1[0].numpy(), np.asarray(j_l1),
                                   rtol=TOL, atol=TOL)
        u = THB.lse_union(l1, _t(other)[None])
        np.testing.assert_allclose(u[0].numpy(), np.asarray(j_u), rtol=TOL,
                                   atol=TOL)
        out, l2 = TFG.flash_biased_forward_compact_plain(
            tq, tk, tv, st, tbs, u, *plan, metric, _t(scale), rate,
            torch.from_numpy(seeds)[None])
        np.testing.assert_allclose(out[0].numpy(), np.asarray(j_out),
                                   rtol=TOL, atol=TOL)
        np.testing.assert_allclose(l2[0].numpy(), np.asarray(j_l2),
                                   rtol=TOL, atol=TOL)


# ---------------------------------------------------------------------------
# The residual partials and the merge
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("metric", METRICS4 + ("rbf_kernel",))
def test_residual_partials_match_jax(metric):
    """The unbiased residual partial and its merge with a second partial
    against ``edge_attention_partial`` / ``merge_attention_partials``
    (leading snapshot dim on the port's side), and the biased residual's
    lse1 and partial against ``_res_lse1`` / ``_res_biased_partial`` on
    the padded tables, with both dead-row marks and dropout factors."""
    js, ts = _pair(_snaps(11))
    rng = np.random.default_rng(12)
    H = 2
    q, k, v = (rng.standard_normal((T, H, N, d)).astype(np.float32)
               for d in (6, 6, 5))
    scale = np.asarray([0.6, 1.5], np.float32)
    sg = scale if metric == "gaussian_kernel" else None
    gm = scale if metric == "rbf_kernel" else None
    tq, tk, tv = _t(q), _t(k), _t(v)
    eq, ek, em = ts.hyb_res
    part = TS.edge_attention_partial(metric, tq, tk, tv, eq, ek, em, N,
                                     sigma=None if sg is None else _t(sg),
                                     gamma=None if gm is None else _t(gm))
    other = (tv * 0.5, _t(rng.standard_normal((T, H, N)).astype(np.float32)))
    other[1][:, :, 4] = TFG.LSE_DEAD
    merged = TS.merge_attention_partials([part, other])
    b = rng.standard_normal((T, E)).astype(np.float32)
    rb = hybrid_residual_bias(torch.where(ts.edge_mask, _t(b),
                                          torch.zeros(())), ts)
    l1u = _t(rng.standard_normal((T, H, N)).astype(np.float32)) + 2.0
    keep = tuple(_t((rng.random((T, H, eq.shape[-1])) < 0.7)
                    .astype(np.float32) / 0.7) for _ in range(2))
    r_l1 = THB.residual_lse1(metric, tq, tk, eq, ek, em, N, _t(scale))
    r_out, r_l2 = THB.residual_biased_partial(metric, tq, tk, tv, eq, ek, em,
                                              N, rb, l1u, _t(scale), keep)
    for t in range(T):
        jeq, jek, jem = (a[t] for a in js.hyb_res)
        jq, jk, jv = (jnp.asarray(a[t]) for a in (q, k, v))
        jp = JS.edge_attention_partial(
            metric, jq, jk, jv, jeq, jek, jem, N,
            sigma=None if sg is None else jnp.asarray(sg),
            gamma=None if gm is None else jnp.asarray(gm))
        jm = JS.merge_attention_partials(
            [jp, (jnp.asarray(other[0][t]), jnp.asarray(other[1][t]))])
        for got, want in zip(part + merged, jp + jm):
            np.testing.assert_allclose(got[t].numpy(), np.asarray(want),
                                       rtol=TOL, atol=TOL)
        # the padded tables of the same residual edges, bias by edge id
        req, rek, rem = (np.asarray(a[t]) for a in js.hyb_res)
        eid = ts.hyb_res_eid[t].numpy()
        nbr, nval, inc, inc_slot, ival, bid = pad_residual_edges(
            req, rek, rem, N, edge_ids=eid)
        bid = np.asarray(bid)
        bias_pad = np.where(bid >= 0, b[t][np.clip(bid, 0, E - 1)], 0.0)
        # the keep factors moved to the padded query layout by edge id
        kap = [np.zeros((H,) + bid.shape, np.float32) for _ in range(2)]
        pos = {int(x): idx for idx, x in np.ndenumerate(bid) if x >= 0}
        for e, x in enumerate(eid):
            if x >= 0:
                for kp, kt in zip(kap, keep):
                    kp[(slice(None),) + pos[int(x)]] = kt[t, :, e].numpy()
        jl1 = JHB._res_lse1(metric, jq, jk, jnp.asarray(nbr),
                            jnp.asarray(nval), jnp.asarray(scale), 6)
        jo, jl2 = JHB._res_biased_partial(
            metric, jq, jk, jv, jnp.asarray(nbr), jnp.asarray(nval),
            jnp.asarray(bias_pad, jnp.float32), jnp.asarray(l1u[t]),
            jnp.asarray(kap[0]), jnp.asarray(kap[1]), jnp.asarray(scale), 6)
        for got, want in ((r_l1[t], jl1), (r_out[t], jo), (r_l2[t], jl2)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=TOL, atol=TOL)


# ---------------------------------------------------------------------------
# apply_hybrid and the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("biased", [False, True])
@pytest.mark.parametrize("metric", METRICS4)
def test_apply_hybrid_matches_jax(metric, biased, interpret):
    """``GeometricAttention.apply_hybrid`` (both snapshots folded into one
    call) against JAX's per snapshot: unbiased (band and COO residual)
    and biased (band bias store, residual bias by edge id), a learnable
    gaussian scale, cosine normalised outside the kernels, inactive rows
    keeping their input."""
    js, ts = _pair(_snaps(13))
    kw = dict(hidden_dim=16, num_heads=2, distance_metric=metric,
              learnable_distance=metric == "gaussian_kernel", dropout=0.0)
    jattn = JGA(**kw)
    jp = jattn.init(jax.random.key(4))
    tattn = TGA(**kw)
    tattn.load_state_dict(pt.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jp)))
    rng = np.random.default_rng(14)
    x = rng.standard_normal((T, N, 16)).astype(np.float32)
    b = rng.standard_normal((T, E)).astype(np.float32)
    bb = rb = None
    if biased:
        tb = torch.where(ts.edge_mask, _t(b), torch.zeros(()))
        bb, rb = hybrid_bias_store(tb, ts), hybrid_residual_bias(tb, ts)
    with torch.no_grad():
        got = tattn.apply_hybrid(_t(x), ts.hyb_mask_blocks, ts.hyb_plan,
                                 ts.hyb_res, ts.node_mask, None, bb, rb)
    for t in range(T):
        cplan, cplan_t = _jplan(js, t)
        extra = {}
        if biased:
            bid = np.asarray(js.hyb_res_bid[t])
            extra = dict(
                res_pad=tuple(a[t] for a in js.hyb_res_pad),
                band_bias=_band_bias(js, ts, t, b)[0],
                res_bias=jnp.asarray(np.where(
                    bid >= 0, b[t][np.clip(bid, 0, E - 1)], 0.0), jnp.float32))
        want = jattn.apply_hybrid(
            jp, jnp.asarray(x[t]), js.hyb_mask_blocks[t], cplan, cplan_t,
            *(a[t] for a in js.hyb_res), js.node_mask[t], block_m=BM,
            block_n=BN, **extra)
        np.testing.assert_allclose(got[t].numpy(), np.asarray(want),
                                   rtol=TOL, atol=TOL)


def _models(fe):
    cfg = dict(hidden_dim=16, num_heads=2, num_layers=2, node_feature_dim=F,
               edge_feature_dim=fe, use_edge_features=fe > 0, output_dim=1,
               loss_type="bce", dropout=0.0, spatial_backend="hybrid")
    jm = tt.TAGAN(tt.TAGANConfig(**cfg))
    jp = jm.init(jax.random.key(0))
    tm = pt.TAGAN(pt.TAGANConfig(**cfg), device="cpu")
    tm.load_state_dict(pt.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jp)))
    return jm, jp, tm


@pytest.mark.parametrize("fe", [0, 4])
def test_model_matches_jax(fe, interpret):
    """``TAGAN(spatial_backend="hybrid")`` logits and loss per sequence
    against the JAX model, without and with edge features, and the
    port's ``Predictor`` (plans attached at pack time, pinned across the
    request) against the JAX model's probabilities."""
    jm, jp, tm = _models(fe)
    reqs = [_snaps(20 + s, fe) for s in range(2)]
    labels = np.asarray([1.0, 0.0], np.float32)
    fwd = jax.jit(lambda p, s, y: jm(p, s, y))
    want = []
    for snaps, y in zip(reqs, labels):
        js = _pair(snaps, fe)[0]
        o = fwd(jp, js, jnp.asarray(y))
        want.append((np.asarray(o.logits), float(o.loss),
                     np.asarray(o.predictions)))
    pred = pt.Predictor(tm, dims=(T, N, E, fe), batch_size=2)
    batch = pt.batch_sequences(pred._pack(reqs))
    with torch.no_grad():
        out = tm(batch, _t(labels), reduction="none")
    for s, (lg, loss, _) in enumerate(want):
        np.testing.assert_allclose(out.logits[s].numpy(), lg, rtol=TOL,
                                   atol=TOL)
        np.testing.assert_allclose(out.loss[s].item(), loss, rtol=TOL,
                                   atol=TOL)
    probs = pred.predict_proba(reqs)
    np.testing.assert_allclose(probs, np.stack([w[2] for w in want]),
                               rtol=TOL, atol=TOL)
    assert pred.plan_pin is None and batch.hyb_mask_blocks.dtype == torch.int64


def test_predictor_plans_each_request():
    """Without a pin, each request is planned at its own sizes, so a
    later request that needs more residual slots than the first is
    served; a caller's pin fixes the sizes, and
    a request past it raises."""
    cfg = pt.TAGANConfig(hidden_dim=16, num_heads=2, num_layers=1,
                         node_feature_dim=F, output_dim=1, loss_type="bce",
                         dropout=0.0, spatial_backend="hybrid")
    model = pt.TAGAN(cfg, device="cpu",
                     generator=torch.Generator().manual_seed(0))
    small = [_snaps(30, e=40)]
    large = [_snaps(31, e=E)]
    pred = pt.Predictor(model, dims=(T, N, E, 0))
    sizes = [hybrid_plan_dims(pred._pack(r)[0]) for r in (small, large)]
    assert sizes[1]["Er"] > sizes[0]["Er"]
    for req in (small, large):
        probs = pred.predict_proba(req)
        assert probs.shape == (1, 1) and np.isfinite(probs).all()
    assert pred.plan_pin is None
    pinned = pt.Predictor(model, dims=(T, N, E, 0), plan_pin=sizes[0])
    assert pinned.predict_proba(small).shape == (1, 1)
    with pytest.raises(ValueError, match="exceeds its pin"):
        pinned.predict_proba(large)
