"""The port's hybrid backend with ``bf16_matmul=True`` against the JAX
package's on the CPU: the plain bf16 forms of B1c, B3a c and B3b c against
the Pallas kernels with ``bf16=True`` and 3-tuple plans (in interpret
mode), and against the plain dense bf16 forms on the same mask;
``apply_hybrid(bf16=True)``, the model and 3 trainer steps over
``plan="hybrid"`` loaders.

The JAX side plans at the port's 64 x 64 tile (``with_hybrid_plan(
block_m=64, block_n=64)``): the bf16 forward rounds p relative to the
running max after each walked tile, so two walks at other tiles give
other roundings. At 64 x 64 JAX keeps an int8 store and the port packs
bits; results are compared, never stores.

The gates are `test_torch_bf16.py`'s (max error, mean error, a witness),
and so is the handling of JAX on the CPU, which ignores
``default_matmul_precision``: the model is held tightly with the port's
plain contractions pinned to float32 (its kernels alone at bf16), and at
bf16-class tolerances as it runs."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tagan_torch as pt
import tagan_tpu as tt
from tagan_torch.convert import params_from_jax
from tagan_torch.core.graph import attach_hybrid_plans
from tagan_torch.core import module as M
from tagan_torch.nn.geometric import GeometricAttention as TGA
from tagan_torch.ops import flash_geometric as TFG
from tagan_tpu.core.graph import attach_hybrid_plans as j_attach
from tagan_tpu.data.dataset import TemporalGraphDataLoader as JLoader
from tagan_tpu.data.dataset import TemporalGraphDataset as JDataset
from tagan_tpu.nn.geometric import GeometricAttention as JGA
from tagan_tpu.nn.model import batched_forward as j_batched_forward
from tagan_tpu.ops.pallas import flash_geometric as JFG
from tagan_tpu.train.trainer import TAGANTrainer as JTrainer
from tests.test_torch_bf16 import (GAP, MAX_TOL, TOL, TOL_BF16_GRAD,
                                   TOL_BF16_LOGITS, TOL_BF16_LOSS,
                                   TOL_KERNELS, TOL_STEP, ZERO_GRAD, _check,
                                   _check_grads, _gates)

# torch's CPU operations on one thread: the tier-1 command runs six
# pytest workers on 8 cores, and torch's default of a thread per core
# oversubscribes them
torch.set_num_threads(1)

BM = BN = 64             # both sides' tile
N, T, F, E = 150, 2, 8, 480


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
    """Banded snapshots over three 64-row tiles, the last one ragged
    (85% of edges within 12 slots of their source, the rest uniform: a
    non-empty residual), three nodes inactive in the second snapshot
    (dead rows)."""
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
                    "node_ids": ids, "timestep": float(t)})
    return out


def _pair(snaps):
    """(JAX sequence at 64 x 64 tiles, the port's with the transposed
    walk)."""
    kw = dict(max_nodes=N, max_edges=E, max_time=T, dense_adj=False)
    js = tt.build_sequence(snaps, **kw).with_hybrid_plan(
        block_m=BM, block_n=BN, padded_residual=True)
    ts = pt.build_sequence(snaps, **kw).with_hybrid_plan(transposed=True)
    return js, ts


@pytest.fixture(scope="module")
def seqs():
    snaps = _snaps(5)
    js, ts = _pair(snaps)
    ts_i8 = pt.build_sequence(snaps, max_nodes=N, max_edges=E, max_time=T,
                              dense_adj=False).with_hybrid_plan(pack=False)
    return js, ts, ts_i8


# ---------------------------------------------------------------------------
# The plain compact bf16 forms against the Pallas kernels and the dense
# plain bf16 forms
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rate,D", [(0.0, 16), (0.1, 8)])
@pytest.mark.parametrize("metric", TFG.MXU_METRICS)
def test_compact_plain_bf16_matches_pallas(metric, rate, D, seqs, interpret):
    """The plain bf16 forms of B1c, B3a c and B3b c against JAX's
    ``flash_geometric_attention_lse`` / ``flash_geometric_attention_bwd``
    with bf16=True and 3-tuple plans at 64 x 64: every metric, head dim
    16 without dropout and 8 (sqrt(d) not a power of two) with it (the
    hash bit for bit), dscale for gaussian/rbf, an lse cotangent, dead
    rows, both of the port's stores. The witness is the port's float32
    plain version."""
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
    dlse = 0.25 * rng.standard_normal((H, N)).astype(np.float32)
    scaled = metric in TFG.SCALED_METRICS
    sc = np.asarray([0.7, 1.6], np.float32)
    seed = -77
    jplan = tuple(p[t] for p in js.hyb_plan)
    jplan_t = tuple(p[t] for p in js.hyb_plan_t)

    @jax.jit
    def ref(q, k, v, store, do, dlse, plan, plan_t):
        kw = dict(metric=metric, block_m=BM, block_n=BN, bf16=True,
                  dropout_rate=rate)
        scale = jnp.asarray(sc)
        out, lse = JFG.flash_geometric_attention_lse(
            q, k, v, store, scale_param=scale, plan=plan, plan_t=plan_t,
            dropout_seed=jnp.asarray([seed], jnp.int32), **kw)
        return out, lse, JFG.flash_geometric_attention_bwd(
            q, k, v, store, out, lse, do, scale=scale, plan=plan,
            plan_t=plan_t, need_dscale=scaled, dlse=dlse,
            seed=jnp.asarray([seed], jnp.int32), **kw)
    jout, jlse, jgrads = jax.tree_util.tree_map(np.asarray, ref(
        *(jnp.asarray(a) for a in (q, k, v)), js.hyb_mask_blocks[t],
        *(jnp.asarray(a) for a in (do, dlse)), jplan, jplan_t))

    args = tuple(_t(a)[None] for a in (q, k, v))
    scale = _t(sc)
    seed_t = torch.tensor([seed], dtype=torch.int32)
    dead = jlse[0] == JFG.LSE_DEAD
    assert dead.any()
    bwd = tuple(_t(a)[None] for a in (jout, jlse, do))
    for seq in (ts, ts_i8):
        store = seq.hyb_mask_blocks[t:t + 1]
        plan = tuple(p[t:t + 1] for p in seq.hyb_plan)
        out, lse = TFG.flash_geometric_forward_compact_plain(
            *args, store, *plan, metric, scale, rate, seed_t, bf16=True)
        out32, _ = TFG.flash_geometric_forward_compact_plain(
            *args, store, *plan, metric, scale, rate, seed_t)
        _check("out", out[0], jout, out32[0])
        assert torch.all(out[0][:, dead] == 0)
        assert torch.all(lse[0][:, dead] == TFG.LSE_DEAD)
        _check("lse", lse[0][:, ~dead], jlse[:, ~dead], lse[0][:, ~dead],
               witness=False)
        # the backward from JAX's forward, so that it alone is compared
        got = TFG.flash_geometric_backward_compact_plain(
            *args, store, *bwd, *plan, metric, scale, rate, seed_t, scaled,
            _t(dlse)[None], bf16=True)
        f32 = TFG.flash_geometric_backward_compact_plain(
            *args, store, *bwd, *plan, metric, scale, rate, seed_t, scaled,
            _t(dlse)[None])
        for name, g, w, f in zip(("dq", "dk", "dv"), got, jgrads, f32):
            _check(name, g[0], w, f[0])
        assert torch.all(got[0][0][:, dead] == 0)
        if scaled:
            # sums of many terms that cancel: the max gate alone, as in
            # test_torch_bf16.py
            assert _gates(got[3], jgrads[3], f32[3])[0] <= MAX_TOL
        else:
            assert got[3] is None


# the compact and the dense plain bf16 forms walk the same 64 x 64 tiles in
# the same order: the forward agrees bit for bit, the backward up to f32
# sums taken per tile instead of per row chunk (measured 1.4e-7 of the
# largest entry)
TOL_WALK = 1e-6


def test_compact_plain_bf16_matches_dense():
    """The plain compact bf16 forward and backward against the plain
    dense bf16 forms on the same mask, both stores: a row tile with
    jcount = 0, a key tile with icount = 0 (dk and dv exactly zero
    there), N not a multiple of 64, dead rows, dropout and an lse
    cotangent, one metric of each chain operand (`_chain_operand`: the
    scaled dot's 1/sqrt(d), the squared distance's -1/2, gaussian's
    scale with its dscale, cosine's clip; every metric is held against
    the Pallas kernels above); and the public entries
    (`flash_geometric_fwd_compact`, `flash_geometric_attention_bwd` with
    3-tuple plans) take the same path on CPU tensors."""
    G, H, n, D, Dv = 2, 2, 150, 16, 8
    rng = np.random.default_rng(3)
    mask = torch.from_numpy(rng.random((G, n, n)) < 0.06)
    mask[1, 64:128] = False
    mask[0, :, 64:128] = False
    mask[:, 5] = False
    plan_t = TFG.compact_transposed_plan(mask)
    for metric in ("scaled_dot_product", "squared_euclidean",
                   "gaussian_kernel", "cosine_similarity"):
        q, k = (torch.from_numpy(rng.standard_normal((G, H, n, D)).astype(
            np.float32)) for _ in range(2))
        if metric in TFG._COSINE:
            q, k = TFG._l2_normalize(q), TFG._l2_normalize(k)
        v, do = (torch.from_numpy(rng.standard_normal((G, H, n, Dv)).astype(
            np.float32)) for _ in range(2))
        dlse = torch.from_numpy(rng.standard_normal((G, H, n)).astype(
            np.float32))
        scale, seed = torch.tensor([0.8, 1.5]), torch.tensor([9, -4],
                                                             dtype=torch.int32)
        need = metric in TFG.SCALED_METRICS
        out, lse = TFG.flash_geometric_forward_plain(
            q, k, v, mask, metric, scale, 0.2, seed, bf16=True)
        want = TFG.flash_geometric_backward_plain(
            q, k, v, mask, out, lse, do, metric, scale, 0.2, seed, need, dlse,
            bf16=True)
        for pack in (True, False):
            store, plan = TFG.compact_from_mask(mask, pack=pack)
            assert int(plan[1][1, 1]) == 0 and int(plan_t[1][0, 1]) == 0
            got = TFG.flash_geometric_fwd_compact(
                q, k, v, store, *plan, metric=metric, scale=scale,
                dropout_rate=0.2, seed=seed, bf16=True)
            torch.testing.assert_close(got, (out, lse), rtol=0, atol=0)
            got = TFG.flash_geometric_attention_bwd(
                q, k, v, store, out, lse, do, metric=metric, scale=scale,
                plan=plan, plan_t=plan_t, seed=seed, dropout_rate=0.2,
                need_dscale=need, dlse=dlse, bf16=True)
            for g, w in zip(got, want):
                if w is not None:
                    m = w.abs().max().item()
                    assert (g - w).abs().max().item() <= TOL_WALK * m
            assert torch.all(got[1][0, :, 64:128] == 0)
            assert torch.all(got[2][0, :, 64:128] == 0)


# ---------------------------------------------------------------------------
# apply_hybrid, the model, the trainer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("metric", ["scaled_dot_product", "gaussian_kernel"])
def test_apply_hybrid_bf16_matches_jax(metric, seqs, interpret):
    """``apply_hybrid(bf16=True)``'s output and every parameter's and the
    input's gradient, both snapshots folded into one call, against JAX's
    ``apply_hybrid(bf16=True)`` per snapshot at 64 x 64: the band through
    the bf16 plain B1c / B3a c / B3b c, the residual and the merge in
    float32 (its lse cotangent reaches the band's backward). Outside the
    model's precision context the projections are float32 on both
    sides; a learnable gaussian scale takes dscale through the bf16
    backward."""
    js, ts, _ = seqs
    kw = dict(hidden_dim=16, num_heads=2, distance_metric=metric,
              learnable_distance=metric == "gaussian_kernel", dropout=0.0)
    jattn = JGA(**kw)
    jp = jattn.init(jax.random.key(4))
    tattn = TGA(**kw)
    tattn.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jp)))
    rng = np.random.default_rng(14)
    x = rng.standard_normal((T, N, 16)).astype(np.float32)
    w = rng.standard_normal((T, N, 16)).astype(np.float32)

    def jfwd(p, x):
        return jnp.stack([jattn.apply_hybrid(
            p, x[t], js.hyb_mask_blocks[t], tuple(a[t] for a in js.hyb_plan),
            tuple(a[t] for a in js.hyb_plan_t),
            *(a[t] for a in js.hyb_res), js.node_mask[t], block_m=BM,
            block_n=BN, bf16=True) for t in range(T)])
    jy, (jgp, jgx) = jax.jit(lambda p, x: (jfwd(p, x), jax.grad(
        lambda p, x: jnp.sum(jfwd(p, x) * w), argnums=(0, 1))(p, x)))(
        jp, jnp.asarray(x))
    tx = _t(x).requires_grad_()
    y = tattn.apply_hybrid(tx, ts.hyb_mask_blocks, ts.hyb_plan, ts.hyb_res,
                           ts.node_mask, plan_t=ts.hyb_plan_t, bf16=True)
    with torch.no_grad():
        y32 = tattn.apply_hybrid(_t(x), ts.hyb_mask_blocks, ts.hyb_plan,
                                 ts.hyb_res, ts.node_mask)
    _check("layer out", y, np.asarray(jy), y32)
    (y * _t(w)).sum().backward()
    _check_grads({name: p.grad for name, p in tattn.named_parameters()},
                 params_from_jax(jax.tree_util.tree_map(np.asarray, jgp)),
                 TOL_KERNELS)
    _check("layer dx", tx.grad, np.asarray(jgx), tx.grad, witness=False)
    inactive = ~ts.node_mask[1]
    assert torch.all(tx.grad[1][inactive] == _t(w)[1][inactive])


def _cfg(**over):
    cfg = dict(hidden_dim=16, num_heads=2, num_layers=2, node_feature_dim=F,
               output_dim=1, loss_type="bce", dropout=0.0,
               spatial_backend="hybrid", bf16_matmul=True,
               learning_rate=1e-2, weight_decay=0.05, gradient_clip_val=0.1)
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
    """The hybrid model with bf16_matmul=True on a batch of two
    sequences: the loss, logits and every gradient against JAX's (planned
    at 64 x 64), tightly with the port's plain contractions at float32
    and at bf16-class tolerances with every contraction at bf16 (the
    model as it runs); the port's bf16 model stands apart from its
    float32 model. ``Predictor`` answers the same request from the
    model."""
    cfg = _cfg()
    jm = tt.TAGAN(tt.TAGANConfig(**cfg))
    jp = jm.init(jax.random.key(0))
    reqs = [_snaps(20 + s) for s in range(2)]
    labels = np.asarray([1.0, 0.0], np.float32)
    kw = dict(max_nodes=N, max_edges=E, max_time=T, dense_adj=False)
    jb = tt.batch_sequences(j_attach([tt.build_sequence(s, **kw)
                                      for s in reqs], block_m=BM,
                                     block_n=BN, padded_residual=True)[0])
    tb = pt.batch_sequences(attach_hybrid_plans(
        [pt.build_sequence(s, **kw) for s in reqs], transposed=True)[0])

    def jloss_fn(p):
        out = j_batched_forward(jm, p, jb, jnp.asarray(labels))
        return out.loss, (out.logits, out.predictions)
    (jloss, (jlogits, jprobs)), jg = jax.jit(jax.value_and_grad(
        jloss_fn, has_aux=True))(jp)
    jg = params_from_jax(jax.tree_util.tree_map(np.asarray, jg))
    jlogits = _t(jlogits)
    for contractions, tol in (("highest", None), (None, TOL_BF16_GRAD)):
        tm = _port_model(jp, cfg, contractions)
        out = tm(tb, _t(labels))
        out.loss.backward()
        grads = {n: p.grad for n, p in tm.named_parameters()}
        if contractions == "highest":
            assert abs(out.loss.item() - float(jloss)) <= TOL
            assert (out.logits - jlogits).abs().max().item() <= TOL
            _check_grads(grads, jg, TOL_KERNELS)
        else:
            assert abs(out.loss.item() - float(jloss)) <= TOL_BF16_LOSS
            assert (out.logits.detach() - jlogits).abs().max().item() \
                <= TOL_BF16_LOGITS
            _check_grads(grads, jg, tol)
            logits = out.logits.detach()
    with torch.no_grad():
        logits32 = _port_model(jp, dict(cfg, bf16_matmul=False))(tb).logits
    assert (logits - logits32).abs().max().item() > GAP
    pred = pt.Predictor(tm, dims=(T, N, E, 0), batch_size=2)
    np.testing.assert_allclose(pred.predict_proba(reqs),
                               torch.sigmoid(logits).numpy(), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(pred.predict_proba(reqs), np.asarray(jprobs),
                               rtol=0, atol=TOL_BF16_LOGITS)


def test_trainer_steps_bf16_match_jax(interpret):
    """3 steps of both trainers over ``plan="hybrid"`` loaders (one
    sequence per batch; the JAX loader plans at 64 x 64) on the hybrid
    model with bf16_matmul=True from the same parameters, the port's
    plain contractions at float32 (JAX's on the CPU): the losses and,
    after every step, the parameters agree. Then the port's own bf16
    steps (every contraction at bf16) run, finite, within bf16-class
    tolerance of JAX's losses and apart from the pinned run."""
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
