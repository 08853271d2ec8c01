"""The port's bf16 path (``bf16_matmul=True``) against the JAX package's on
the CPU: the matmul-precision context, the plain bf16 forward and backward
of the flash kernels against the Pallas kernels with ``bf16=True`` (in
interpret mode, at the port's 64 x 64 tile so that the forward's walks
coincide), the flash layer, and the model and a trainer step.

bf16 comparisons take three gates, each over the reference's largest
entry: the max error is bf16-class (an f32 sum taken in another order can
put a value on the other side of a bf16 rounding midpoint, and such a
flip moves one term by up to 2^-8 of itself), the mean error is
f32-class (a systematic slip, a rounded norm or a rounded softmax
denominator, moves every entry), and a witness: the mean distance of the
bf16 result from the float32 one is at least 100 times the mean error,
so that the rounding really happens.

JAX on the CPU ignores ``jax.default_matmul_precision("bfloat16")``: its
model with ``bf16_matmul=True`` rounds only inside the kernels, where the
casts are explicit. The port rounds every contraction. So the model is
held tightly against JAX with the port's plain contractions at float32
(its kernels alone at bf16), and at a bf16-class tolerance with all of
them at bf16."""

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

# torch's CPU operations on one thread: the tier-1 command runs six
# pytest workers on 8 cores, and torch's default of a thread per core
# oversubscribes them
torch.set_num_threads(1)

# gate 1, the max error over the largest entry: a bf16 flip moves one term
# by up to 2^-8 of itself (measured at most 5e-6 on the kernels' plain
# versions, 2.6e-4 in one dv at D=8)
MAX_TOL = 2e-3
# gate 2, the mean error over the largest entry (measured at most 1e-7 on
# out, dq, dk and dv)
MEAN_TOL = 1e-5
# gate 3: the mean bf16-vs-float32 distance over the mean error (measured
# 1.2e-4 to 9e-4 against at most 1e-7)
WITNESS = 100
# float32 on both sides, sums in another order
TOL = 1e-4
# the model with only its kernels at bf16 against JAX's (which rounds only
# there on the CPU): each gradient's max error over its largest entry.
# The q/k projections' gradients pass through the rounded p of every
# pair, whose flips reach them (measured 5.6e-5 at most on this model,
# 4.8e-4 with two layers); the float32 model stands 3.9e-3 away
TOL_KERNELS = 1e-3
# the model with every contraction at bf16 against JAX's: logits and
# loss (measured 1.3e-2 and 4.7e-3 at most over the backends and the
# trainer step, the loss near 0.9: a bf16-class error of the whole model)
# and each gradient over its largest entry (3.9e-2 at most: the head's
# bias gradients are sums of terms that cancel)
TOL_BF16_LOGITS = 5e-2
TOL_BF16_LOSS = 2e-2
TOL_BF16_GRAD = 1e-1
# parameters after one AdamW step at learning rate 1e-2, kernels at bf16:
# Adam's first step is +-lr wherever a gradient stands above its epsilon,
# so a bf16 flip moves a parameter only where its gradient nearly
# vanishes (measured 1.5e-4 in one entry); a flipped sign moves it 2e-2
TOL_STEP = 1e-3
# the port's own bf16-vs-float32 gap must stand this far above TOL: the
# precision context reaches the contractions (measured 6e-3 to 1.3e-2 in
# the logits)
GAP = 10 * TOL

# gradients that are zero in exact arithmetic: a bias that adds one
# constant to every score of a softmax row
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


def _gates(got, want, f32):
    """(max error, mean error, bf16-vs-float32 mean distance) over the
    largest entry of ``want``, float64."""
    g, w, f = (np.asarray(x.detach() if torch.is_tensor(x) else x,
                          np.float64) for x in (got, want, f32))
    m = max(float(np.abs(w).max()), 1e-30)
    return (float(np.abs(g - w).max()) / m, float(np.abs(g - w).mean()) / m,
            float(np.abs(f - w).mean()) / m)


def _check(label, got, want, f32, witness=True):
    mx, mean, wit = _gates(got, want, f32)
    assert mx <= MAX_TOL, (label, mx)
    assert mean <= MEAN_TOL, (label, mean)
    if witness:
        assert wit >= max(WITNESS * mean, MEAN_TOL), (label, wit, mean)


def test_precision_context():
    """Under "bfloat16" a contraction is the float64 product of the
    bf16-rounded operands, rounded to float32; its cotangents reach the
    backward's products rounded too. Outside it, the float32 product."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 24)).astype(np.float32)
    w = rng.standard_normal((24, 7)).astype(np.float32)
    b = rng.standard_normal(7).astype(np.float32)
    g = rng.standard_normal((3, 5, 7)).astype(np.float32)

    def r(a):
        return torch.from_numpy(a).bfloat16().double()
    tx, tw = _t(x).requires_grad_(), _t(w).requires_grad_()
    with M.default_matmul_precision("bfloat16"):
        assert M.bf16_contractions()
        y = M.linear(tx, tw, _t(b))
        e = M.einsum("bnd,de->bne", tx, tw)
    assert not M.bf16_contractions()
    want = ((r(x) @ r(w)).float() + _t(b))
    torch.testing.assert_close(y, want, rtol=0, atol=2e-6)
    torch.testing.assert_close(e, (r(x) @ r(w)).float(), rtol=0, atol=1e-6)
    assert (y - (_t(x) @ _t(w) + _t(b))).abs().max() > 1e-3
    (y * _t(g)).sum().backward()
    torch.testing.assert_close(tx.grad, (r(g) @ r(w).T).float(), rtol=0,
                               atol=1e-6)
    torch.testing.assert_close(
        tw.grad, torch.einsum("bnd,bne->de", r(x), r(g)).float(), rtol=0,
        atol=1e-5)
    torch.testing.assert_close(M.linear(_t(x), _t(w), _t(b)),
                               _t(x) @ _t(w) + _t(b), rtol=0, atol=0)
    with pytest.raises(ValueError):
        with M.default_matmul_precision("tf32"):
            pass


@pytest.fixture(scope="module")
def attn_inputs():
    """One snapshot, 2 heads, N=130 (padded to three 64-row tiles), a
    dead row, an empty key strip, cotangents of out and lse."""
    rng = np.random.default_rng(0)
    H, N, Dmax, Dv = 2, 130, 16, 8
    q, k = (rng.standard_normal((H, N, Dmax)).astype(np.float32)
            for _ in range(2))
    v, do = (rng.standard_normal((H, N, Dv)).astype(np.float32)
             for _ in range(2))
    dlse = 0.25 * rng.standard_normal((H, N)).astype(np.float32)
    adj = rng.random((N, N)) < 0.3
    np.fill_diagonal(adj, True)
    adj[3] = False
    adj[:, 64:128] = False
    return q, k, v, do, dlse, adj


@pytest.mark.parametrize("rate,D", [(0.0, 16), (0.1, 8)])
@pytest.mark.parametrize("metric", TFG.MXU_METRICS)
def test_plain_bf16_matches_jax(metric, rate, D, attn_inputs, interpret):
    """The plain bf16 forward (walking the plan) and backward against the
    Pallas kernels with bf16=True at 64 x 64 blocks: every metric, head
    dim 16 without dropout and 8 (sqrt(d) not a power of two) with it,
    dscale for gaussian/rbf, an lse cotangent, a dead row and an empty
    key strip. The witness is the port's float32 plain version, which
    the float32 tests hold to JAX's within 1e-4."""
    q, k, v, do, dlse, adj = attn_inputs
    q, k = q[..., :D], k[..., :D]
    if metric in TFG._COSINE:
        q = q / np.linalg.norm(q, axis=-1, keepdims=True)
        k = k / np.linalg.norm(k, axis=-1, keepdims=True)
    scaled = metric in TFG.SCALED_METRICS
    sc = np.asarray([0.7, 1.6], np.float32) if scaled else None
    seed = -987

    @jax.jit
    def ref(q, k, v, adj, do, dlse):
        kw = dict(metric=metric, block_m=64, block_n=64, bf16=True,
                  seed=jnp.asarray([seed], jnp.int32), dropout_rate=rate)
        scale = None if sc is None else jnp.asarray(sc)
        out, lse = JFG._flash_forward(q, k, v, adj, scale_param=scale,
                                      return_lse=True, **kw)
        return out, lse, JFG.flash_geometric_attention_bwd(
            q, k, v, adj, out, lse, do, scale=scale, need_dscale=scaled,
            dlse=dlse, **kw)
    jout, jlse, jgrads = jax.tree_util.tree_map(np.asarray, ref(
        *(jnp.asarray(a) for a in (q, k, v, adj, do, dlse))))

    args = tuple(_t(a)[None] for a in (q, k, v, adj))
    scale = None if sc is None else _t(sc)
    seed_t = torch.tensor([seed], dtype=torch.int32)
    out, lse = TFG.flash_geometric_forward_plain(*args, metric, scale, rate,
                                                 seed_t, bf16=True)
    out32, _ = TFG.flash_geometric_forward_plain(*args, metric, scale, rate,
                                                 seed_t)
    live = adj.any(-1)
    _check("out", out[0], jout, out32[0])
    assert torch.all(out[0][:, ~live] == 0)
    assert torch.all(lse[0][:, ~live] == TFG.LSE_DEAD)
    _check("lse", lse[0][:, live], jlse[:, live], lse[0][:, live],
           witness=False)
    # the backward from JAX's forward, so that it alone is compared
    bwd = tuple(_t(a)[None] for a in (jout, jlse, do))
    got = TFG.flash_geometric_backward_plain(
        *args, *bwd, metric, scale, rate, seed_t, scaled, _t(dlse)[None],
        bf16=True)
    f32 = TFG.flash_geometric_backward_plain(
        *args, *bwd, metric, scale, rate, seed_t, scaled, _t(dlse)[None])
    for name, g, w, f in zip(("dq", "dk", "dv"), got, jgrads, f32):
        _check(name, g[0], w, f[0])
    if scaled:
        # two sums of many terms that cancel (the largest is 3.4e-4 for
        # rbf): the max gate alone (measured 4.6e-5)
        assert _gates(got[3], jgrads[3], f32[3])[0] <= MAX_TOL
    # the public entries take the same path on CPU tensors
    api = TFG.flash_geometric_fwd(*args, *TFG.make_block_plan(args[3]),
                                  metric=metric, scale=scale,
                                  dropout_rate=rate, seed=seed_t, bf16=True)
    torch.testing.assert_close(api, (out, lse), rtol=0, atol=0)
    api = TFG.flash_geometric_attention_bwd(
        *args, *bwd, metric=metric, scale=scale, seed=seed_t,
        dropout_rate=rate, need_dscale=scaled, dlse=_t(dlse)[None],
        bf16=True)
    for a, g in zip(api, got):
        torch.testing.assert_close(a, g, rtol=0, atol=0)


def test_bf16_refusals():
    """Nothing is refused at bf16 any more: the model builds an
    edge-feature hybrid configuration with bf16_matmul, and
    ``apply_hybrid`` with a band bias and ``bf16`` gives the plain
    result, that of the flash layer's biased bf16 path (the dense plain
    bf16 B4 and B5, walking the same 64 x 64 tile) on the same mask,
    bias and weights when every edge lies in the band; the float32 layer
    stands apart from it. The compact backward takes ``bf16``: it gives
    the plain compact bf16 backward's result. (The edge-biased entries'
    bf16 forms are held against JAX in tests/test_torch_edge_bf16.py and
    tests/test_torch_hybrid_edge_bf16.py.)"""
    rng = np.random.default_rng(2)
    q, k = (_t(rng.standard_normal((1, 1, 8, 4)).astype(np.float32))
            for _ in range(2))
    mask = torch.ones(1, 8, 8, dtype=torch.int8)
    pt.TAGAN(pt.TAGANConfig(**dict(_cfg("hybrid"), use_edge_features=True,
                                   edge_feature_dim=3)), device="cpu")
    store, plan = TFG.compact_from_mask(mask)
    plan_t = TFG.compact_transposed_plan(mask)
    # a residual of one masked slot, as a plan with every edge in the
    # band has it
    res = (torch.zeros(1, 1, dtype=torch.int32),) * 2 \
        + (torch.zeros(1, 1, dtype=torch.bool),)
    layer = TGeo(4, 1, dropout=0.0)
    x = _t(rng.standard_normal((1, 8, 4)).astype(np.float32))
    bias = _t(rng.standard_normal((1, 8, 8)).astype(np.float32))
    with torch.no_grad():
        got, got32 = (layer.apply_hybrid(
            x, store, plan, res, torch.ones(1, 8, dtype=torch.bool),
            band_bias=TFG.compact_values(mask, bias),
            res_bias=torch.zeros(1, 1), plan_t=plan_t, bf16=bf16)
            for bf16 in (True, False))
        want = layer.apply_flash(x, mask, bias=bias, bf16=True)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    assert (got - got32).abs().max() > 1e-6
    out, lse = TFG.flash_geometric_fwd_compact(q, k, k, store, *plan,
                                               metric="dot_product",
                                               bf16=True)
    got = TFG.flash_geometric_attention_bwd(q, k, k, store, out, lse, q,
                                            metric="dot_product", plan=plan,
                                            plan_t=plan_t, bf16=True)
    want = TFG.flash_geometric_backward_compact_plain(
        q, k, k, store, out, lse, q, *plan, "dot_product", bf16=True)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def _check_grads(got, want, tol):
    """Each gradient's max error over its own largest entry, but for the
    ones that are zero in exact arithmetic (fp32 noise on both sides)."""
    assert set(got) == set(want)
    for name, g in got.items():
        if name in ZERO_GRAD:
            continue
        w = want[name]
        assert torch.isfinite(g).all(), name
        assert (g - w).abs().max().item() <= tol * w.abs().max().item(), name


def test_flash_layer_bf16_matches_jax(interpret):
    """The flash layer's output and every parameter's gradient through
    apply_flash(bf16=True), against JAX's (learnable gaussian sigma:
    dscale through the bf16 backward), with converted weights. Outside
    the model's precision context the projections stay float32 on both
    sides."""
    hid, heads, n = 16, 2, 100
    jl = JGeo(hidden_dim=hid, num_heads=heads, dropout=0.0,
              distance_metric="gaussian_kernel", learnable_distance=True)
    p = jl.init(jax.random.key(3))
    tl = TGeo(hid, heads, "gaussian_kernel", True, True, dropout=0.0)
    tl.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                              p)))
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, n, hid)).astype(np.float32)
    w = rng.standard_normal((2, n, hid)).astype(np.float32)
    adj = rng.random((2, n, n)) < 0.25
    adj[:, np.arange(n), np.arange(n)] = True
    adj[0, 4] = False

    def jfwd(p, x, bf16):
        return jl.apply_flash(p, x, jnp.asarray(adj), block_m=64,
                              block_n=64, bf16=bf16)
    jout = np.asarray(jax.jit(functools.partial(jfwd, bf16=True))(
        p, jnp.asarray(x)))
    jgp, jgx = jax.jit(jax.grad(
        lambda p, x: jnp.sum(jfwd(p, x, True) * w), argnums=(0, 1)))(
        p, jnp.asarray(x))
    tx = _t(x).requires_grad_()
    out = tl.apply_flash(tx, _t(adj), bf16=True)
    with torch.no_grad():
        out32 = tl.apply_flash(_t(x), _t(adj))
    _check("layer out", out, jout, out32)
    (out * _t(w)).sum().backward()
    _check_grads({name: q.grad for name, q in tl.named_parameters()},
                 params_from_jax(jax.tree_util.tree_map(np.asarray, jgp)),
                 TOL_KERNELS)
    _check("layer dx", tx.grad, np.asarray(jgx), tx.grad, witness=False)


@pytest.fixture(scope="module")
def bf16_batch():
    """Three sequences of 100-130 nodes (two or three 64-row tiles)."""
    data = create_synthetic_data(num_samples=3, num_nodes_range=(100, 130),
                                 node_feature_dim=8, edge_feature_dim=0,
                                 sequence_length=3, seed=3)
    seqs = [s for s, _ in data]
    return seqs, tt.pad_dims_for(seqs)


def _cfg(backend):
    return dict(hidden_dim=16, num_heads=2, num_layers=1, node_feature_dim=8,
                output_dim=1, loss_type="bce", dropout=0.0,
                flash_block_m=64, flash_block_n=64, spatial_backend=backend,
                bf16_matmul=True)


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


@pytest.mark.parametrize("backend", ["flash", "dense", "csr"])
def test_model_bf16_matches_jax(backend, bf16_batch, interpret):
    """The batch loss, logits and every gradient of the model with
    bf16_matmul=True against JAX's. flash: with the plain contractions
    at float32 the port is JAX's CPU computation and agrees tightly; with
    them at bf16 (the model as it runs) it agrees at bf16-class
    tolerances. Every backend: the port's bf16 model stands apart from
    its float32 model, so the precision context reaches the
    contractions."""
    seqs, (T, N, E, _) = bf16_batch
    cfg = _cfg(backend)
    dense = backend == "dense"
    jm = JTAGAN(tt.TAGANConfig(**cfg))
    jp = jm.init(jax.random.key(0))
    jb = tt.batch_sequences([tt.build_sequence(
        s, max_nodes=N, max_edges=E, max_time=T, dense_adj=dense)
        for s in seqs])
    tb = pt.batch_sequences([pt.build_sequence(
        s, max_nodes=N, max_edges=E, max_time=T, dense_adj=dense)
        for s in seqs])
    labels = np.asarray([1.0, 0.0, 1.0], np.float32)
    def jloss_fn(p):
        out = j_batched_forward(jm, p, jb, jnp.asarray(labels))
        return out.loss, out.logits
    (jloss, jlogits), jg = jax.jit(jax.value_and_grad(jloss_fn,
                                                      has_aux=True))(jp)
    jlogits = _t(jlogits)
    jg = params_from_jax(jax.tree_util.tree_map(np.asarray, jg))
    if backend == "flash":
        loss, logits, grads = _port_run(jp, cfg, tb, labels, "highest")
        assert abs(loss - float(jloss)) <= TOL
        assert (logits - jlogits).abs().max().item() <= TOL
        _check_grads(grads, jg, TOL_KERNELS)
    loss, logits, grads = _port_run(jp, cfg, tb, labels)
    assert abs(loss - float(jloss)) <= TOL_BF16_LOSS
    assert (logits - jlogits).abs().max().item() <= TOL_BF16_LOGITS
    _check_grads(grads, jg, TOL_BF16_GRAD)
    _, logits32, _ = _port_run(jp, dict(cfg, bf16_matmul=False), tb, labels)
    assert (logits - logits32).abs().max().item() > GAP


def test_trainer_step_bf16_matches_jax(bf16_batch, interpret):
    """One step of each trainer (global-norm clipping, AdamW) on the
    flash model with bf16_matmul=True from the same weights and batch,
    the port's plain contractions at float32 (JAX's on the CPU): the
    loss, predictions and every parameter after the step agree; then the
    port's own bf16 step runs, finite and apart from it."""
    seqs, _ = bf16_batch
    data = [(s, float(i % 2)) for i, s in enumerate(seqs[:2])]
    cfg = dict(_cfg("flash"), learning_rate=1e-2, weight_decay=0.05,
               gradient_clip_val=0.1)
    exp = dict(batch_size=2, num_epochs=1, seed=0)
    jm = JTAGAN(tt.TAGANConfig(**cfg))
    jp = jm.init(jax.random.key(0))
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
