"""The port's edge-feature hybrid backend with ``bf16_matmul=True`` against
the JAX package's on the CPU: the plain bf16 forms of B4c, B5c, B6c, B7a c
and B7b c against ``_band_lse1``, ``_band_biased_main``, ``_band_bwd_pre``
and ``_band_bwd_dq_dkv`` with ``bf16=True`` (in interpret mode), and
against the plain dense bf16 biased forms on the same mask;
``hybrid_biased_attention(bf16=True)``, ``apply_hybrid`` with a band bias
and ``bf16``, the model and 3 trainer steps over ``plan="hybrid"``
loaders.

The JAX side plans at the port's 64 x 64 tile (``with_hybrid_plan(
block_m=64, block_n=64, padded_residual=True)``: JAX's biased hybrid
needs the padded residual tables): B5c's bf16 form rounds p2 relative to
the running max after each walked tile, so two walks at other tiles give
other roundings. Bias gradients are compared per edge, gathered from each
side's store, never store against store.

The gates are `test_torch_bf16.py`'s (max error, mean error, a witness),
and so is the handling of JAX on the CPU, which ignores
``default_matmul_precision``: the model is held tightly with the port's
plain contractions pinned to float32 (its kernels alone at bf16), and at
bf16-class tolerances as it runs. Attention-level cotangents are 0 on
rows with no edge, as the model's are (ROADMAP C10)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tagan_torch as pt
import tagan_tpu as tt
from tagan_torch.convert import params_from_jax
from tagan_torch.core import module as M
from tagan_torch.core.graph import attach_hybrid_plans
from tagan_torch.nn.geometric import GeometricAttention as TGA
from tagan_torch.nn.model import hybrid_bias_store, hybrid_residual_bias
from tagan_torch.ops import flash_geometric as TFG
from tagan_torch.ops import hybrid_biased as THB
from tagan_tpu.core.graph import attach_hybrid_plans as j_attach
from tagan_tpu.data.dataset import TemporalGraphDataLoader as JLoader
from tagan_tpu.data.dataset import TemporalGraphDataset as JDataset
from tagan_tpu.nn.geometric import GeometricAttention as JGA
from tagan_tpu.nn.model import batched_forward as j_batched_forward
from tagan_tpu.ops.pallas import flash_geometric as JFG
from tagan_tpu.ops.pallas import hybrid_biased as JHB
from tagan_tpu.train.trainer import TAGANTrainer as JTrainer
from tests.test_torch_bf16 import (GAP, MAX_TOL, TOL, TOL_BF16_LOGITS,
                                   TOL_BF16_LOSS, TOL_KERNELS, TOL_STEP,
                                   ZERO_GRAD, _check, _check_grads, _gates)

# torch's CPU operations on one thread: the tier-1 command runs six
# pytest workers on 8 cores, and torch's default of a thread per core
# oversubscribes them
torch.set_num_threads(1)

BM = BN = 64             # both sides' tile
N, T, F, E, FE = 150, 2, 8, 480, 4


@pytest.fixture(scope="module")
def interpret():
    import jax.experimental.pallas as pl
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JFG.pl, "pallas_call",
                   functools.partial(pl.pallas_call, interpret=True))
        yield


def _t(a):
    return torch.from_numpy(np.array(a))


def _snaps(seed, n=N, e=E, steps=T):
    """Banded snapshots over three 64-row tiles, the last one ragged (85%
    of edges within 12 slots of their source, the rest uniform: a
    non-empty residual), Fe = 4 N(0, 1) edge features, three nodes
    inactive in the second snapshot (dead rows)."""
    rng = np.random.default_rng(seed)
    out = []
    for t in range(steps):
        src = rng.integers(0, n, e)
        near = np.clip(src + rng.integers(-12, 13, e), 0, n - 1)
        dst = np.where(rng.random(e) < 0.85, near, rng.integers(0, n, e))
        ids = np.arange(n) if t == 0 else np.arange(n - 3)
        keep = (src < len(ids)) & (dst < len(ids))
        out.append({"x": rng.standard_normal((len(ids), F)).astype(
                        np.float32),
                    "edge_index": np.stack([src[keep], dst[keep]]),
                    "edge_attr": rng.standard_normal(
                        (int(keep.sum()), FE)).astype(np.float32),
                    "node_ids": ids, "timestep": float(t)})
    return out


_KW = dict(max_nodes=N, max_edges=E, max_time=T, edge_feature_dim=FE,
           dense_adj=False)


@pytest.fixture(scope="module")
def seqs():
    """(JAX sequence at 64 x 64 tiles, the port's with the transposed
    walk, the port's int8 store)."""
    snaps = _snaps(5)
    js = tt.build_sequence(snaps, **_KW).with_hybrid_plan(
        block_m=BM, block_n=BN, padded_residual=True)
    ts = pt.build_sequence(snaps, **_KW).with_hybrid_plan(transposed=True)
    ts_i8 = pt.build_sequence(snaps, **_KW).with_hybrid_plan(
        pack=False, transposed=True)
    return js, ts, ts_i8


def _jsnap(js, t):
    """(walks, transposed walks, padded residual tables, mask store) of
    JAX snapshot t, numpy (constants under ``jax.jit``)."""
    return (tuple(np.asarray(p)[t] for p in js.hyb_plan),
            tuple(np.asarray(p)[t] for p in js.hyb_plan_t),
            tuple(np.asarray(a)[t] for a in js.hyb_res_pad),
            np.asarray(js.hyb_mask_blocks)[t])


def _jbias(js, t, b):
    """JAX snapshot t's bias store [S, 64, 64] and padded residual bias
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


def _edge_db(db, seq, t):
    """A bias store's cotangent [S, 64, 64] of snapshot t read at each
    band edge's pair (0 for the other edges): numpy [E]."""
    db = np.asarray(db.detach() if torch.is_tensor(db) else db)
    slot = np.asarray(seq.hyb_band_slot)[t]
    on = slot >= 0
    src, dst = np.asarray(seq.edge_src)[t], np.asarray(seq.edge_dst)[t]
    out = np.zeros(slot.shape, np.float32)
    out[on] = db[slot[on], src[on] % BM, dst[on] % BN]
    return out


def _live_cotangent(wo, ts):
    """The output cotangent set to 0 on rows with no edge (the inactive
    nodes), as the model's is: JAX's recompute gives w2 = 1 off the mask
    on a row whose union lse2 is the merge's dead mark (ROADMAP C10)."""
    return wo * np.asarray(ts.node_mask)[:, None, :, None]


# ---------------------------------------------------------------------------
# The plain compact bf16 forms against the Pallas kernels and the dense
# plain bf16 forms
# ---------------------------------------------------------------------------

# every metric, each family of chain operand (`_chain_operand`: the dot
# products, the squared distances, the scaled kernels, cosine) both
# without dropout at head dim 16 and with it at 8; one JAX compile per case
# is most of the file's time, so not every metric takes both
BAND_CASES = [("scaled_dot_product", 0.0, 16), ("dot_product", 0.1, 8),
              ("squared_euclidean", 0.1, 8), ("euclidean", 0.0, 16),
              ("gaussian_kernel", 0.1, 8), ("rbf_kernel", 0.0, 16),
              ("cosine_similarity", 0.0, 16), ("cosine_distance", 0.1, 8)]


@pytest.mark.parametrize("metric,rate,D", BAND_CASES)
def test_band_plain_bf16_matches_pallas(metric, rate, D, seqs, interpret):
    """The plain bf16 forms of B4c, B5c, B6c, B7a c and B7b c against
    JAX's ``_band_lse1``, ``_band_biased_main``, ``_band_bwd_pre`` and
    ``_band_bwd_dq_dkv`` with bf16=True at 64 x 64: every metric, head
    dim 16 without dropout and 8 (sqrt(d) not a power of two) with it
    (both hashes bit for bit), both of the port's stores, dead rows. B5c
    takes JAX's union lse1 and the backward JAX's union statistics
    (lse1 and lse2 merged with a second logsumexp each, delta1 B6c's
    plus a residual's, as the hybrid backward passes them), so that each
    kernel alone is compared: delta1, dB per band edge, dq, dscale
    (gaussian/rbf: the max gate alone), dk and dv. The witness is the
    port's float32 plain version."""
    js, ts, ts_i8 = seqs
    t = 1
    rng = np.random.default_rng(6)
    H, Dv = 2, 8
    q, k = (rng.standard_normal((H, N, 16)).astype(np.float32)[..., :D]
            for _ in range(2))
    if metric in TFG._COSINE:
        q = q / np.linalg.norm(q, axis=-1, keepdims=True)
        k = k / np.linalg.norm(k, axis=-1, keepdims=True)
    v, do = (rng.standard_normal((H, N, Dv)).astype(np.float32)
             for _ in range(2))
    b = rng.standard_normal((T, E)).astype(np.float32)
    other1, other2, delta2, d1_rest = (
        rng.standard_normal((H, N)).astype(np.float32) for _ in range(4))
    sc = np.asarray([0.7, 1.6], np.float32)
    seeds = np.asarray([12345, 12345 ^ 0x5BD1E995], np.int32)
    need = metric in TFG.SCALED_METRICS
    jplan, jplan_t, _, mb = _jsnap(js, t)

    @jax.jit
    def ref(q, k, v, do, b, other1, other2, delta2, d1_rest):
        kw = dict(metric=metric, block_m=BM, block_n=BN, bf16=True)
        scale, sd = jnp.asarray(sc), jnp.asarray(seeds)
        jbs = _jbias(js, t, b)[0]
        l1 = JHB._band_lse1(q, k, mb, jplan, scale, **kw)
        l1u = JHB._lse_union(l1, other1)
        out, l2 = JHB._band_biased_main(q, k, v, mb, jbs, l1u, jplan, scale,
                                        sd, dropout_rate=rate, **kw)
        l2u = JHB._lse_union(l2, other2)
        d1, db = JHB._band_bwd_pre(q, k, v, mb, jbs, do, l1u, l2u, delta2,
                                   jplan, scale, sd, dropout_rate=rate, **kw)
        d1u = d1 + d1_rest
        return (l1, l1u, out, l2, l2u, d1, db, d1u, JHB._band_bwd_dq_dkv(
            q, k, v, mb, jbs, do, l1u, l2u, delta2, d1u, jplan, jplan_t,
            scale, sd, need_dscale=need, dropout_rate=rate, **kw))
    (j_l1, l1u, j_out, j_l2, l2u, j_d1, j_db, d1u,
     jgrads) = jax.tree_util.tree_map(np.asarray, ref(
        *(jnp.asarray(a) for a in (q, k, v, do, b, other1, other2, delta2,
                                   d1_rest))))
    want_db = _edge_db(j_db, js, t)
    assert np.abs(want_db).max() > 0
    dead = j_l1 == JFG.LSE_DEAD
    assert dead.any()

    tq, tk, tv = (_t(a)[None] for a in (q, k, v))
    tail = (metric, _t(sc), rate, _t(seeds)[None])
    stats = tuple(_t(a)[None] for a in (l1u, l2u, delta2))
    tbs = _tbias(ts, _t(b))[0][t:t + 1]
    def port(seq, bf16):
        st = seq.hyb_mask_blocks[t:t + 1]
        plan = tuple(p[t:t + 1] for p in seq.hyb_plan)
        l1 = TFG.flash_lse1_compact_plain(tq, tk, st, *plan, metric, _t(sc),
                                          bf16)
        out, l2 = TFG.flash_biased_forward_compact_plain(
            tq, tk, tv, st, tbs, stats[0], *plan, *tail, bf16=bf16)
        args = (tq, tk, tv, st, tbs, _t(do)[None], *stats)
        d1, db = TFG.flash_biased_bwd_pre_compact_plain(*args, *plan, *tail,
                                                        bf16=bf16)
        tu = _t(d1u)[None]
        dq, dsc = TFG.flash_biased_bwd_dq_compact_plain(
            *args, tu, *plan, *tail, need, bf16=bf16)
        dk, dv = TFG.flash_biased_bwd_dkv_compact_plain(
            *args, tu, *plan, *tail, bf16=bf16)
        return dict(lse1=l1[0], out=out[0], lse2=l2[0], delta1=d1[0],
                    dB=_edge_db(db[0], seq, t), dq=dq[0], dk=dk[0], dv=dv[0],
                    dscale=dsc)
    f32 = port(ts, False)       # the witness: independent of the store
    want = dict(lse1=j_l1, out=j_out, lse2=j_l2, delta1=j_d1, dB=want_db,
                dq=jgrads[0], dk=jgrads[1], dv=jgrads[2])
    for seq in (ts, ts_i8):
        got = port(seq, True)
        for name, mark in (("lse1", TFG.LSE_DEAD), ("lse2", TFG.LSE_DEAD),
                           ("out", 0.0), ("dq", 0.0)):
            assert torch.all(got[name][dead] == mark), name
        for name in ("lse1", "lse2"):
            _check(name, got[name][~dead], want[name][~dead],
                   f32[name][~dead], witness=False)
        for name in ("out", "delta1", "dB", "dq", "dk", "dv"):
            _check(name, got[name], want[name], f32[name])
        if need:
            # a sum of many terms that cancel: the max gate alone, as in
            # test_torch_bf16.py
            assert _gates(got["dscale"], jgrads[3], f32["dscale"])[0] \
                <= MAX_TOL
        else:
            assert got["dscale"] is None


# the compact and the dense plain bf16 forms walk the same 64 x 64 tiles in
# the same order: B5's forward agrees bit for bit; lse1 (the dense one sums
# row chunks) and the backward up to float32 sums taken in another order
TOL_WALK = 1e-6


def test_band_plain_bf16_matches_dense():
    """The plain compact bf16 forms of B4c-B7b c, bit and int8 stores,
    against the plain dense bf16 B4-B7b on the same mask, where the
    port's 64 x 64 tiling has edge cases the JAX side above does not
    reach: a row tile with jcount = 0, a key tile with icount = 0 (dk and
    dv exactly zero there), N not a multiple of 64, dead rows, dropout;
    dB in the store's slots equal to the dense dB moved there and 0 in
    the slots no walk visits; the squared distance's chain operand and a
    scale with its dscale (every metric is held against the Pallas
    kernels above; the plain versions' many small torch operations are
    slow under the tier-1 command's six workers, so two metrics); and the
    public entries (`flash_lse1_compact`, `flash_biased_fwd_compact`)
    take the same path on CPU tensors."""
    G, H, n, D, Dv = 2, 2, 150, 16, 8
    rng = np.random.default_rng(3)
    mask = torch.from_numpy(rng.random((G, n, n)) < 0.06)
    mask[1, 64:128] = False
    mask[1, :, 128:] = False
    mask[0, :, 64:128] = False
    mask[:, 5] = False
    stores = [TFG.compact_from_mask(mask, pack=pack) for pack in (True,
                                                                  False)]
    plan = stores[0][1]
    walked = plan[1].sum(-1).tolist()
    assert walked[1] < stores[0][0].shape[1] and int(plan[1][1, 1]) == 0
    assert int(TFG.compact_transposed_plan(mask)[1][0, 1]) == 0
    bias = torch.from_numpy(rng.standard_normal((G, n, n)).astype(np.float32))
    bst = TFG.compact_values(mask, bias)
    dplan = TFG.make_block_plan(mask)
    for metric in ("squared_euclidean", "gaussian_kernel"):
        q, k = (torch.from_numpy(rng.standard_normal((G, H, n, D)).astype(
            np.float32)) for _ in range(2))
        if metric in TFG._COSINE:
            q, k = TFG._l2_normalize(q), TFG._l2_normalize(k)
        v, do = (torch.from_numpy(rng.standard_normal((G, H, n, Dv)).astype(
            np.float32)) for _ in range(2))
        scale = torch.tensor([0.8, 1.5])
        seeds = torch.tensor([[9, 3], [-4, 7]], dtype=torch.int32)
        need = metric in TFG.SCALED_METRICS
        lse1 = TFG.flash_lse1_plain(q, k, mask, metric, scale, True)
        live = lse1 < 1e29
        out, lse2 = TFG.flash_biased_forward_plain(
            q, k, v, mask, bias, lse1, metric, scale, 0.2, seeds, True, dplan)
        want = TFG.flash_biased_backward_plain(
            q, k, v, mask, bias, out, lse1, lse2, do, metric, scale, 0.2,
            seeds, need, bf16=True)
        want = (*want[:3], TFG.compact_values(
            mask, torch.where(mask != 0, want[3], torch.zeros(()))), want[4])
        for store, _ in stores:
            got = TFG.flash_lse1_compact(q, k, store, *plan, metric=metric,
                                         scale=scale, bf16=True)
            assert torch.equal(got[~live], lse1[~live])
            assert (got - lse1)[live].abs().max() \
                <= TOL_WALK * lse1[live].abs().max()
            got = TFG.flash_biased_fwd_compact(
                q, k, v, store, bst, lse1, *plan, metric=metric, scale=scale,
                dropout_rate=0.2, seeds=seeds, bf16=True)
            torch.testing.assert_close(got, (out, lse2), rtol=0, atol=0)
            got = TFG.flash_biased_backward_compact_plain(
                q, k, v, store, bst, out, lse1, lse2, do, *plan, metric,
                scale, 0.2, seeds, need, bf16=True)
            for g, w in zip(got, want):
                if w is not None:
                    assert (g - w).abs().max() <= TOL_WALK * w.abs().max()
            assert torch.all(got[3][1, walked[1]:] == 0)
            assert torch.all(got[1][0, :, 64:128] == 0)
            assert torch.all(got[2][0, :, 64:128] == 0)


# ---------------------------------------------------------------------------
# hybrid_biased_attention, apply_hybrid, the model, the trainer
# ---------------------------------------------------------------------------

def test_hybrid_biased_attention_bf16_matches_jax(seqs, interpret):
    """``hybrid_biased_attention(bf16=True)`` under autograd (both
    snapshots folded, a non-empty residual) against ``jax.grad`` of JAX's
    ``hybrid_biased_attention(bf16=True)`` per snapshot, at the
    euclidean metric (the squared distance's chain; `apply_hybrid` below
    takes a learnable gaussian scale): the output and the gradients of
    q, k, v, the per-head scale and the per-edge bias b, through each
    side's bias store and residual bias. The band runs the bf16 plain
    B4c-B7b c, the residual, the union statistics and the merge float32
    on both sides."""
    metric = "euclidean"
    js, ts, _ = seqs
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
        for t, (plan, plan_t, res_pad, mb) in enumerate(snap):
            bs, br = _jbias(js, t, b)
            outs.append(JHB.hybrid_biased_attention(
                q[t], k[t], v[t], mb, plan, plan_t, res_pad, bs, br,
                metric=metric, scale_param=sc, block_m=BM, block_n=BN,
                bf16=True))
        return jnp.stack(outs)
    j_out, want = jax.jit(lambda *a: (jouts(*a), jax.grad(
        lambda *a: jnp.sum(jouts(*a) * wo), argnums=(0, 1, 2, 3, 4))(*a)))(
        *(jnp.asarray(a) for a in (q, k, v, scale, b)))
    res = {}
    for bf16 in (True, False):
        leaves = [_t(a).requires_grad_() for a in (q, k, v, scale, b)]
        bb, rb = _tbias(ts, leaves[4])
        out = THB.hybrid_biased_attention(
            *leaves[:3], ts.hyb_mask_blocks, ts.hyb_plan, ts.hyb_res, bb, rb,
            metric, leaves[3], plan_t=ts.hyb_plan_t, bf16=bf16)
        (out * _t(wo)).sum().backward()
        res[bf16] = (out, *(leaf.grad for leaf in leaves))
    for name, g, w, f in zip(("out", "dq", "dk", "dv", "dscale", "db"),
                             res[True], (j_out, *want), res[False]):
        if name == "dscale":
            # a sum of many terms that cancel: the max gate alone
            assert _gates(g, w, f)[0] <= MAX_TOL
        else:
            _check(name, g, np.asarray(w), f)
    assert np.abs(np.asarray(want[4])).max() > 0


def test_apply_hybrid_edge_bf16_matches_jax(seqs, interpret):
    """``apply_hybrid`` with the band bias store, the residual bias and
    ``bf16`` (both snapshots folded into one call) against JAX's
    ``apply_hybrid(bf16=True)`` per snapshot: the output, every
    parameter's gradient (a learnable gaussian scale: dscale through the
    bf16 backward), the input's and the per-edge bias's; inactive rows
    keep their input. Outside the model's precision context the
    projections are float32 on both sides."""
    js, ts, _ = seqs
    kw = dict(hidden_dim=16, num_heads=2, distance_metric="gaussian_kernel",
              learnable_distance=True, dropout=0.0)
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

    def jfwd(p, x, b):
        ys = []
        for t, (plan, plan_t, res_pad, mb) in enumerate(snap):
            bs, br = _jbias(js, t, b)
            ys.append(jattn.apply_hybrid(
                p, x[t], mb, plan, plan_t, *res[t], node_mask[t],
                block_m=BM, block_n=BN, res_pad=res_pad, band_bias=bs,
                res_bias=br, bf16=True))
        return jnp.stack(ys)
    jy, (jgp, jgx, jgb) = jax.jit(lambda *a: (jfwd(*a), jax.grad(
        lambda *a: jnp.sum(jfwd(*a) * w), argnums=(0, 1, 2))(*a)))(
        jp, jnp.asarray(x), jnp.asarray(b))
    tx, tb = _t(x).requires_grad_(), _t(b).requires_grad_()
    bb, rb = _tbias(ts, tb)
    y = tattn.apply_hybrid(tx, ts.hyb_mask_blocks, ts.hyb_plan, ts.hyb_res,
                           ts.node_mask, None, bb, rb, ts.hyb_plan_t,
                           bf16=True)
    with torch.no_grad():
        y32 = tattn.apply_hybrid(_t(x), ts.hyb_mask_blocks, ts.hyb_plan,
                                 ts.hyb_res, ts.node_mask, None,
                                 *_tbias(ts, _t(b)))
    _check("layer out", y, np.asarray(jy), y32)
    (y * _t(w)).sum().backward()
    _check_grads({name: p.grad for name, p in tattn.named_parameters()},
                 params_from_jax(jax.tree_util.tree_map(np.asarray, jgp)),
                 TOL_KERNELS)
    _check("layer dx", tx.grad, np.asarray(jgx), tx.grad, witness=False)
    _check("layer db", tb.grad, np.asarray(jgb), tb.grad, witness=False)
    inactive = ~ts.node_mask[1]
    assert torch.all(tx.grad[1][inactive] == _t(w)[1][inactive])


def _cfg(**over):
    cfg = dict(hidden_dim=16, num_heads=2, num_layers=1, node_feature_dim=F,
               edge_feature_dim=FE, use_edge_features=True, output_dim=1,
               loss_type="bce", dropout=0.0, spatial_backend="hybrid",
               bf16_matmul=True, learning_rate=1e-2, weight_decay=0.05,
               gradient_clip_val=0.1)
    cfg.update(over)
    return cfg


def _port_model(jp, cfg, contractions=None):
    """The port's model from JAX's weights; ``contractions`` pins the
    precision of its plain contractions."""
    tm = pt.TAGAN(pt.TAGANConfig(**cfg), device="cpu")
    tm.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                              jp)))
    if contractions is not None:
        tm.precision = lambda: M.default_matmul_precision(contractions)
    return tm


def test_model_bf16_matches_jax(interpret):
    """The edge-feature hybrid model's forward with bf16_matmul=True on a
    batch of two sequences: the loss and logits against JAX's (planned at
    64 x 64), tightly with the port's plain contractions at float32 and
    at bf16-class tolerances with every contraction at bf16 (the model
    as it runs); the port's bf16 model stands apart from its float32
    model. ``Predictor`` answers the same request from the model. (The
    gradients are held against ``jax.grad`` at the attention and layer
    above, and through the parameters of 3 trainer steps below.)"""
    cfg = _cfg()
    jm = tt.TAGAN(tt.TAGANConfig(**cfg))
    jp = jm.init(jax.random.key(0))
    reqs = [_snaps(20 + s) for s in range(2)]
    labels = np.asarray([1.0, 0.0], np.float32)
    jb = tt.batch_sequences(j_attach([tt.build_sequence(s, **_KW)
                                      for s in reqs], block_m=BM,
                                     block_n=BN, padded_residual=True)[0])
    tb = pt.batch_sequences(attach_hybrid_plans(
        [pt.build_sequence(s, **_KW) for s in reqs], transposed=True)[0])

    def jfwd(p):
        out = j_batched_forward(jm, p, jb, jnp.asarray(labels))
        return out.loss, out.logits, out.predictions
    jloss, jlogits, jprobs = jax.jit(jfwd)(jp)
    jlogits = _t(jlogits)
    for contractions in ("highest", None):
        tm = _port_model(jp, cfg, contractions)
        assert any("edge_bias" in n for n, _ in tm.named_parameters())
        with torch.no_grad():
            out = tm(tb, _t(labels))
        if contractions == "highest":
            assert abs(out.loss.item() - float(jloss)) <= TOL
            assert (out.logits - jlogits).abs().max().item() <= TOL
        else:
            assert abs(out.loss.item() - float(jloss)) <= TOL_BF16_LOSS
            assert (out.logits - jlogits).abs().max().item() \
                <= TOL_BF16_LOGITS
            logits = out.logits
    with torch.no_grad():
        logits32 = _port_model(jp, dict(cfg, bf16_matmul=False))(tb).logits
    assert (logits - logits32).abs().max().item() > GAP
    pred = pt.Predictor(tm, dims=(T, N, E, FE), batch_size=2)
    np.testing.assert_allclose(pred.predict_proba(reqs),
                               torch.sigmoid(logits).numpy(), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(pred.predict_proba(reqs), np.asarray(jprobs),
                               rtol=0, atol=TOL_BF16_LOGITS)


def test_trainer_steps_bf16_match_jax(interpret):
    """3 steps of both trainers over ``plan="hybrid"`` loaders (one
    sequence per batch; the JAX loader plans at 64 x 64 with the padded
    residual) on the edge-feature hybrid model with bf16_matmul=True from
    the same parameters, the port's plain contractions at float32 (JAX's
    on the CPU): the losses and, after every step, the parameters agree.
    Then the port's own bf16 steps (every contraction at bf16) run,
    finite, within bf16-class tolerance of JAX's losses and apart from
    the pinned run."""
    data = [_snaps(30 + s) for s in range(3)]
    labels = [1.0, 0.0, 1.0]
    exp = dict(batch_size=1, num_epochs=1, seed=0)
    cfg = _cfg()
    jm = tt.TAGAN(tt.TAGANConfig(**cfg))
    jp = jm.init(jax.random.key(0))
    jt = JTrainer(jm, tt.ExperimentConfig(model=jm.config, **exp), params=jp)
    # the same values, strongly typed as the first step returns them: the
    # JAX step then compiles once, not twice
    jt.params, jt.opt_state = jax.tree_util.tree_map(
        lambda x: jnp.asarray(x, jnp.asarray(x).dtype),
        (jt.params, jt.opt_state))
    jl = JLoader(JDataset(data, labels), batch_size=1, dense_adj=False,
                 plan="hybrid", plan_kwargs=dict(block_m=BM, block_n=BN,
                                                 padded_residual=True))
    after, jlosses = {}, []
    for contractions in ("highest", None):
        tm = _port_model(jp, cfg, contractions)
        tr = pt.TAGANTrainer(tm, pt.ExperimentConfig(model=tm.config, **exp))
        tl = pt.TemporalGraphDataLoader(pt.TemporalGraphDataset(data, labels),
                                        batch_size=1, dense_adj=False,
                                        plan="hybrid")
        for step, (tb, ty, tmask) in enumerate(tl):
            tloss, _ = tr._train_step(tb, ty, tmask)
            assert torch.isfinite(tloss)
            if contractions is None:
                assert abs(tloss.item() - jlosses[step]) <= TOL_BF16_LOSS
                continue
            jb, jy, jmask = next(jl_it) if step else next(
                jl_it := iter(jl))
            jt.rng, r = jax.random.split(jt.rng)
            jt.params, jt.opt_state, jloss, _ = jt._train_step(
                jt.params, jt.opt_state, jb, jy, jmask, r, jnp.asarray(1.0))
            jlosses.append(float(jloss))
            assert abs(tloss.item() - jlosses[step]) <= TOL
            want = params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                          jt.params))
            for name, param in tm.named_parameters():
                if name not in ZERO_GRAD:
                    np.testing.assert_allclose(
                        param.detach().numpy(), want[name], rtol=0,
                        atol=TOL_STEP, err_msg=name)
        assert tr.optimizer.count == 3
        after[contractions] = dict(tm.named_parameters())
    assert all(torch.isfinite(p).all() for p in after[None].values())
    assert max((after[None][n] - after["highest"][n]).abs().max().item()
               for n in after[None] if n not in ZERO_GRAD) > 0
