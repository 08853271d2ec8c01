"""The port's edge-feature flash path under ``bf16_matmul=True`` against the
JAX package's on the CPU: the plain bf16 forms of B4 and B5 (forward) and
of B6, B7a and B7b (the biased backward) against ``_flash_biased_forward``
and ``flash_biased_attention_bwd`` with ``bf16=True`` and their Pallas
kernels in interpret mode, at the port's 64 x 64 tile so that B5's walks
coincide (its p2 is rounded relative to the running max after each key
tile); the differentiable entry with ``bias=`` and ``bf16=True``; the
flash layer with a bias; the edge-feature model and one trainer step.

The gates are `tests/test_torch_bf16.py`'s (three over the reference's
largest entry: max error bf16-class, mean error fp32-class, and the
float32 result at least 100 times farther than the mean error). JAX on
the CPU ignores ``default_matmul_precision``, so the model is held
tightly with the port's plain contractions pinned to float32 and at
bf16-class tolerances as the port runs."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tagan_torch as pt
import tagan_tpu as tt
from tagan_tpu.data.dataset import TemporalGraphDataLoader as JLoader
from tagan_tpu.data.dataset import TemporalGraphDataset as JDataset
from tagan_tpu.data.synthetic import create_synthetic_data
from tagan_tpu.nn.geometric import GeometricAttention as JGeo
from tagan_tpu.nn.model import TAGAN as JTAGAN
from tagan_tpu.nn.model import batched_forward as j_batched_forward
from tagan_tpu.ops.pallas import flash_geometric as JFG
from tagan_tpu.train.trainer import TAGANTrainer as JTrainer
from tagan_torch.convert import params_from_jax
from tagan_torch.core import module as M
from tagan_torch.nn.geometric import GeometricAttention as TGeo
from tagan_torch.ops import flash_geometric as TFG
from tests.test_torch_bf16 import (GAP, MAX_TOL, TOL, TOL_BF16_GRAD,
                                   TOL_BF16_LOGITS, TOL_BF16_LOSS,
                                   TOL_KERNELS, TOL_STEP, ZERO_GRAD, _check,
                                   _check_grads, _gates)

# torch's CPU operations on one thread: the tier-1 command runs six
# pytest workers on 8 cores, and torch's default of a thread per core
# oversubscribes them
torch.set_num_threads(1)

SEED = -987


@pytest.fixture(scope="module")
def interpret():
    import jax.experimental.pallas as pl
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JFG.pl, "pallas_call",
                   functools.partial(pl.pallas_call, interpret=True))
        yield


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def biased_inputs():
    """One snapshot, 2 heads, N=130 (three 64-row tiles, the last
    ragged), a dead row, an empty key strip (keys 64..127), a bias on the
    mask's pairs and the cotangent of out."""
    rng = np.random.default_rng(5)
    H, N, Dmax, Dv = 2, 130, 16, 8
    q, k = (rng.standard_normal((H, N, Dmax)).astype(np.float32)
            for _ in range(2))
    v, do = (rng.standard_normal((H, N, Dv)).astype(np.float32)
             for _ in range(2))
    adj = rng.random((N, N)) < 0.3
    np.fill_diagonal(adj, True)
    adj[3] = False
    adj[:, 64:128] = False
    bias = np.where(adj, rng.standard_normal((N, N)), 0.0).astype(np.float32)
    return q, k, v, do, adj, bias


@pytest.mark.parametrize("rate,D", [(0.0, 16), (0.1, 8)])
@pytest.mark.parametrize("metric", TFG.MXU_METRICS)
def test_plain_bf16_biased_matches_jax(metric, rate, D, biased_inputs,
                                       interpret):
    """lse1 (B4), out and lse2 (B5) of the plain bf16 forward, walking
    the plan, and dq, dk, dv, dB at the mask's pairs and dscale of the
    plain bf16 biased backward (B6, B7a, B7b) against the Pallas kernels
    with bf16=True at 64 x 64 blocks: every metric, head dim 16 without
    dropout and 8 (sqrt(d) not a power of two) with both dropouts, a
    dead row and an empty key strip. The witness is the port's float32
    plain version, which `test_torch_edge*.py` holds to JAX's within
    1e-4. The three parts give the whole backward, and the public
    entries on CPU tensors are the plain versions."""
    q, k, v, do, adj, bias = biased_inputs
    q, k = q[..., :D], k[..., :D]
    if metric in TFG._COSINE:
        q = q / np.linalg.norm(q, axis=-1, keepdims=True)
        k = k / np.linalg.norm(k, axis=-1, keepdims=True)
    scaled = metric in TFG.SCALED_METRICS
    sc = np.asarray([0.7, 1.6], np.float32) if scaled else None

    @jax.jit
    def ref(q, k, v, adj, bias, do):
        kw = dict(metric=metric, block_m=64, block_n=64, bf16=True,
                  seeds=jnp.asarray([SEED, SEED ^ 0x5BD1E995], jnp.int32),
                  dropout_rate=rate)
        scale = None if sc is None else jnp.asarray(sc)
        out, lse1, lse2 = JFG._flash_biased_forward(
            q, k, v, adj, bias, scale_param=scale, return_lse=True, **kw)
        return out, lse1, lse2, JFG.flash_biased_attention_bwd(
            q, k, v, bias, adj, out, lse1, lse2, do, scale=scale,
            need_dscale=scaled, **kw)
    jout, jlse1, jlse2, jgrads = jax.tree_util.tree_map(np.asarray, ref(
        *(jnp.asarray(a) for a in (q, k, v, adj, bias, do))))

    q1, k1, v1, m1, b1, do1 = (_t(a)[None] for a in (q, k, v, adj, bias, do))
    scale = None if sc is None else _t(sc)
    seeds = TFG.biased_seeds(SEED, 1, "cpu")
    live = adj.any(-1)
    lse1 = TFG.flash_lse1_plain(q1, k1, m1, metric, scale, bf16=True)
    lse1_32 = TFG.flash_lse1_plain(q1, k1, m1, metric, scale)
    _check("lse1", lse1[0][:, live], jlse1[:, live], lse1_32[0][:, live],
           witness=False)
    assert torch.all(lse1[0][:, ~live] == TFG.LSE_DEAD)
    # B5 on JAX's lse1, so that it alone is compared
    jl1 = _t(jlse1)[None]
    out, lse2 = TFG.flash_biased_forward_plain(q1, k1, v1, m1, b1, jl1,
                                               metric, scale, rate, seeds,
                                               bf16=True)
    out32, _ = TFG.flash_biased_forward_plain(q1, k1, v1, m1, b1, jl1,
                                              metric, scale, rate, seeds)
    _check("out", out[0], jout, out32[0])
    _check("lse2", lse2[0][:, live], jlse2[:, live], lse2[0][:, live],
           witness=False)
    assert torch.all(out[0][:, ~live] == 0)
    assert torch.all(lse2[0][:, ~live] == TFG.LSE_DEAD)

    # the backward from JAX's forward
    stats = tuple(_t(a)[None] for a in (jout, jlse1, jlse2))
    args = (q1, k1, v1, m1, b1, *stats, do1, metric, scale, rate, seeds,
            scaled)
    got = TFG.flash_biased_backward_plain(*args, bf16=True)
    f32 = TFG.flash_biased_backward_plain(*args)
    for name, g, w, f in zip(("dq", "dk", "dv"), got, jgrads, f32):
        _check(name, g[0], w, f[0])
    on = m1[0] != 0
    _check("dB", got[3][0][on], jgrads[3][adj], f32[3][0][on])
    assert torch.all(got[3][0][~on] == 0)
    if scaled:
        # sums of many terms that cancel: the max gate alone
        assert _gates(got[4], jgrads[4], f32[4])[0] <= MAX_TOL
    assert torch.all(got[0][0][:, ~live] == 0)

    # the three parts, as B6, B7a and B7b split the work
    rows = (stats[1], stats[2], (do1 * stats[0]).sum(-1))
    common = (q1, k1, v1, m1, b1, do1, *rows)
    d1, db = TFG.flash_biased_bwd_pre_plain(*common, metric, scale, rate,
                                            seeds, bf16=True)
    dq, dsc = TFG.flash_biased_bwd_dq_plain(*common, d1, metric, scale, rate,
                                            seeds, scaled, bf16=True)
    dk, dv = TFG.flash_biased_bwd_dkv_plain(*common, d1, metric, scale, rate,
                                            seeds, bf16=True)
    for g, w in zip((dq, dk, dv, db), got):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    if scaled:
        torch.testing.assert_close(dsc, got[4], rtol=0, atol=0)

    # the public entries on CPU tensors
    plan = TFG.make_block_plan(m1)
    api = TFG.flash_biased_fwd(q1, k1, v1, m1, b1, *plan, metric=metric,
                               scale=scale, dropout_rate=rate, seeds=seeds,
                               bf16=True)
    torch.testing.assert_close(api[1], lse1, rtol=0, atol=0)
    want = TFG.flash_biased_forward_plain(q1, k1, v1, m1, b1, lse1, metric,
                                          scale, rate, seeds, bf16=True)
    for a, w in zip(api[::2], want):
        torch.testing.assert_close(a, w, rtol=0, atol=0)
    api = TFG.flash_biased_attention_bwd(
        q1, k1, v1, b1, m1, *stats, do1, metric=metric, scale=scale,
        seeds=seeds, dropout_rate=rate, need_dscale=scaled, bf16=True)
    for a, g in zip(api, got):
        torch.testing.assert_close(a, g, rtol=0, atol=0)


def test_biased_attention_bf16_autograd(biased_inputs):
    """flash_geometric_attention(bias=..., bf16=True) under autograd on
    CPU tensors: its out is the plain bf16 forward's and its gradients
    (the bias's at the mask's pairs, a learnable sigma's) the plain bf16
    backward's on that forward, the cosine normalisation pulled back
    outside the Function; and they stand apart from the float32 entry's.
    The edge-biased bf16 path once raised NotImplementedError here."""
    q, k, v, do, adj, bias = biased_inputs
    sig = np.asarray([0.8, 1.4], np.float32)
    metric, rate = "gaussian_kernel", 0.1
    res = {}
    for bf16 in (True, False):
        leaves = [_t(a)[None].requires_grad_() for a in (q, k, v, bias)]
        sigma = _t(sig).requires_grad_()
        out = TFG.flash_geometric_attention(
            *leaves[:3], _t(adj)[None], metric=metric, scale_param=sigma,
            dropout_rate=rate, dropout_seed=SEED, bias=leaves[3], bf16=bf16)
        (out * _t(do)[None]).sum().backward()
        res[bf16] = (out.detach(), [t.grad for t in leaves] + [sigma.grad])
    q1, k1, v1, m1, b1, do1 = (_t(a)[None] for a in (q, k, v, adj, bias, do))
    seeds = TFG.biased_seeds(SEED, 1, "cpu")
    lse1 = TFG.flash_lse1_plain(q1, k1, m1, metric, _t(sig), bf16=True)
    out, lse2 = TFG.flash_biased_forward_plain(
        q1, k1, v1, m1, b1, lse1, metric, _t(sig), rate, seeds, bf16=True)
    torch.testing.assert_close(res[True][0], out, rtol=0, atol=0)
    want = TFG.flash_biased_backward_plain(
        q1, k1, v1, m1, b1, out, lse1, lse2, do1, metric, _t(sig), rate,
        seeds, True, bf16=True)
    on = m1 != 0
    got = res[True][1]
    for g, w in zip(got[:3], want[:3]):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    torch.testing.assert_close(got[3][on], want[3][on], rtol=0, atol=0)
    torch.testing.assert_close(got[4], want[4], rtol=0, atol=0)
    for g, f in zip(got, res[False][1]):
        assert (g - f).abs().max() > 1e-6


def test_flash_layer_edge_bf16_matches_jax(interpret):
    """The flash layer with a head-shared bias through
    apply_flash(bias=..., bf16=True): its output and every parameter's
    gradient, and the input's and the bias's (at the mask's pairs),
    against JAX's (learnable gaussian sigma: dscale through the bf16
    backward), with converted weights."""
    hid, heads, n = 16, 2, 100
    jl = JGeo(hidden_dim=hid, num_heads=heads, dropout=0.0,
              distance_metric="gaussian_kernel", learnable_distance=True)
    p = jl.init(jax.random.key(4))
    tl = TGeo(hid, heads, "gaussian_kernel", True, True, dropout=0.0)
    tl.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                              p)))
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, n, hid)).astype(np.float32)
    w = rng.standard_normal((2, n, hid)).astype(np.float32)
    adj = rng.random((2, n, n)) < 0.25
    adj[:, np.arange(n), np.arange(n)] = True
    adj[0, 4] = False
    bias = np.where(adj, rng.standard_normal((2, n, n)),
                    0.0).astype(np.float32)

    def jfwd(p, x, b):
        return jl.apply_flash(p, x, jnp.asarray(adj), block_m=64,
                              block_n=64, bf16=True, bias=b)
    args = (p, jnp.asarray(x), jnp.asarray(bias))
    jout = np.asarray(jax.jit(jfwd)(*args))
    jgp, jgx, jgb = jax.jit(jax.grad(
        lambda p, x, b: jnp.sum(jfwd(p, x, b) * w), argnums=(0, 1, 2)))(
        *args)
    tx, tb = _t(x).requires_grad_(), _t(bias).requires_grad_()
    out = tl.apply_flash(tx, _t(adj), bias=tb, bf16=True)
    with torch.no_grad():
        out32 = tl.apply_flash(_t(x), _t(adj), bias=_t(bias))
    _check("layer out", out, jout, out32)
    (out * _t(w)).sum().backward()
    _check_grads({name: q.grad for name, q in tl.named_parameters()},
                 params_from_jax(jax.tree_util.tree_map(np.asarray, jgp)),
                 TOL_KERNELS)
    _check("layer dx", tx.grad, np.asarray(jgx), tx.grad, witness=False)
    _check("layer dB", tb.grad[_t(adj)], np.asarray(jgb)[adj],
           tb.grad[_t(adj)], witness=False)


@pytest.fixture(scope="module")
def edge_batch():
    """Three sequences of 100-130 nodes (two or three 64-row tiles) with
    4 edge features."""
    data = create_synthetic_data(num_samples=3, num_nodes_range=(100, 130),
                                 node_feature_dim=8, edge_feature_dim=4,
                                 sequence_length=3, seed=5)
    seqs = [s for s, _ in data]
    return seqs, tt.pad_dims_for(seqs)


def _cfg(**kw):
    return dict(dict(hidden_dim=16, num_heads=2, num_layers=1,
                     node_feature_dim=8, edge_feature_dim=4,
                     use_edge_features=True, output_dim=1, loss_type="bce",
                     dropout=0.0, flash_block_m=64, flash_block_n=64,
                     spatial_backend="flash", bf16_matmul=True), **kw)


def _port_run(jp, cfg, batch, labels, contractions=None):
    """(loss, logits, gradients) of the port's model from JAX's weights;
    ``contractions`` pins the precision of its plain contractions."""
    tm = pt.TAGAN(pt.TAGANConfig(**cfg), device="cpu")
    tm.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                              jp)))
    if contractions is not None:
        tm.precision = lambda: M.default_matmul_precision(contractions)
    out = tm(batch, _t(labels))
    out.loss.backward()
    return out.loss.item(), out.logits.detach(), {
        n: q.grad for n, q in tm.named_parameters()}


def test_edge_model_bf16_matches_jax(edge_batch, interpret):
    """The batch loss, logits and every gradient (``edge_embedding`` and
    the layer's ``edge_bias`` among them) of the edge-feature flash model
    with bf16_matmul=True against JAX's: tightly with the port's plain
    contractions at float32 (JAX's CPU computation), at bf16-class
    tolerances with them at bf16 (the model as it runs); and the port's
    bf16 model stands apart from its float32 model."""
    seqs, (T, N, E, Fe) = edge_batch
    cfg = _cfg()
    jm = JTAGAN(tt.TAGANConfig(**cfg))
    jp = jm.init(jax.random.key(1))
    kw = dict(max_nodes=N, max_edges=E, max_time=T, edge_feature_dim=Fe)
    jb = tt.batch_sequences([tt.build_sequence(s, **kw) for s in seqs])
    tb = pt.batch_sequences([pt.build_sequence(s, **kw) for s in seqs])
    labels = np.asarray([1.0, 0.0, 1.0], np.float32)

    def jloss_fn(p):
        out = j_batched_forward(jm, p, jb, jnp.asarray(labels))
        return out.loss, out.logits
    (jloss, jlogits), jg = jax.jit(jax.value_and_grad(jloss_fn,
                                                      has_aux=True))(jp)
    jlogits = _t(jlogits)
    jg = params_from_jax(jax.tree_util.tree_map(np.asarray, jg))
    loss, logits, grads = _port_run(jp, cfg, tb, labels, "highest")
    assert abs(loss - float(jloss)) <= TOL
    assert (logits - jlogits).abs().max().item() <= TOL
    _check_grads(grads, jg, TOL_KERNELS)
    assert grads["edge_embedding.w"].abs().max() > 0
    loss, logits, grads = _port_run(jp, cfg, tb, labels)
    assert abs(loss - float(jloss)) <= TOL_BF16_LOSS
    assert (logits - jlogits).abs().max().item() <= TOL_BF16_LOGITS
    _check_grads(grads, jg, TOL_BF16_GRAD)
    _, logits32, _ = _port_run(jp, dict(cfg, bf16_matmul=False), tb, labels)
    assert (logits - logits32).abs().max().item() > GAP


def test_edge_trainer_step_bf16_matches_jax(edge_batch, interpret):
    """One step of each trainer (global-norm clipping, AdamW) on the
    edge-feature flash model with bf16_matmul=True from the same weights
    and batch, the port's plain contractions at float32: the loss,
    predictions and every parameter after the step agree; then the
    port's own bf16 step runs, finite and apart from it."""
    seqs, _ = edge_batch
    data = [(s, float(i % 2)) for i, s in enumerate(seqs[:2])]
    cfg = dict(_cfg(), learning_rate=1e-2, weight_decay=0.05,
               gradient_clip_val=0.1)
    exp = dict(batch_size=2, num_epochs=1, seed=0)
    jm = JTAGAN(tt.TAGANConfig(**cfg))
    jp = jm.init(jax.random.key(2))
    jt = JTrainer(jm, tt.ExperimentConfig(model=jm.config, **exp), params=jp)
    jb, jy, jmask = next(iter(JLoader(JDataset(data), batch_size=2)))
    jt.rng, r = jax.random.split(jt.rng)
    params, _, jloss, jpred = jt._train_step(
        jt.params, jt.opt_state, jb, jy, jmask, r, jnp.asarray(1.0))
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    after = {}
    for contractions in ("highest", None):
        tm = pt.TAGAN(pt.TAGANConfig(**cfg), device="cpu")
        tm.load_state_dict(params_from_jax(jax.tree_util.tree_map(
            np.asarray, jp)))
        if contractions is not None:
            tm.precision = lambda: M.default_matmul_precision(contractions)
        tr = pt.TAGANTrainer(tm, pt.ExperimentConfig(model=tm.config, **exp))
        tb, ty, tmask = next(iter(pt.TemporalGraphDataLoader(
            pt.TemporalGraphDataset(data), batch_size=2)))
        loss, pred = tr._train_step(tb, ty, tmask)
        after[contractions] = dict(tm.named_parameters())
        if contractions is None:
            assert abs(loss.item() - float(jloss)) <= TOL_BF16_LOSS
            break
        assert abs(loss.item() - float(jloss)) <= TOL
        np.testing.assert_allclose(pred.numpy(), np.asarray(jpred), rtol=TOL,
                                   atol=TOL)
        for name, param in tm.named_parameters():
            if name not in ZERO_GRAD:
                np.testing.assert_allclose(param.detach().numpy(),
                                           want[name], rtol=0,
                                           atol=TOL_STEP, err_msg=name)
    moved = max((after[None][n] - after["highest"][n]).abs().max().item()
                for n in want if n not in ZERO_GRAD)
    assert all(torch.isfinite(q).all() for q in after[None].values())
    assert moved > 0
