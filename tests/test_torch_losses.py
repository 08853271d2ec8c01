"""The port's loss families and heads (tagan_torch.nn.heads) against the
JAX package's on the CPU: every ``temporal_loss`` family with and without
mask and time weights (values and gradients), ``asymmetric_focal_loss``,
``TemporalLossModule``, the prediction, multi-task, classification and
regression heads with the JAX weights carried across, and each
``loss_type``'s model loss and gradients against ``jax.grad``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tagan_torch as pt
import tagan_tpu as tt
from tagan_tpu.core.config import VALID_LOSS_TYPES
from tagan_tpu.data.synthetic import create_dynamic_synthetic_data
from tagan_tpu.nn import heads as JH
from tagan_tpu.nn.model import TAGAN as JTAGAN
from tagan_tpu.nn.model import batched_forward as j_batched_forward
from tagan_torch.convert import params_from_jax
from tagan_torch.nn import heads as TH

# torch's CPU operations on one thread: the tier-1 command runs six
# pytest workers on 8 cores, and torch's default of a thread per core
# oversubscribes them
torch.set_num_threads(1)

# fp32 on both sides, sums in another order
TOL = 1e-4


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=tol, atol=tol)


def _load(module, jax_params):
    module.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jax_params)))
    return module


# (task, predictions shape, targets: "binary", "index", "onehot", "real")
LOSS_CASES = [
    ("classification", (6, 3), "binary"),
    ("bce", (6,), "binary"),
    ("multi_class", (6, 4), "index"),
    ("ce", (6, 4), "onehot"),
    ("multi_label", (6, 3), "binary"),
    ("regression", (6, 2), "real"),
    ("mse", (6,), "real"),
    ("sequence", (6, 5, 2), "real"),
    ("focal", (6,), "binary"),
    ("focal", (6, 1), "binary"),
    ("focal", (6, 4), "index"),
    ("focal", (6, 4), "onehot"),
    ("huber", (6, 3), "real"),
    ("quantile", (6, 3), "real"),
    ("unnamed", (6, 2), "real"),
]


def _loss_inputs(task, shape, targets, seed=0):
    """Predictions, targets, and a mask and time weights in the shape of
    the family's elementwise loss."""
    rng = np.random.default_rng(seed)
    p = (2.0 * rng.standard_normal(shape)).astype(np.float32)
    if targets == "binary":
        t = (rng.random(shape) < 0.5).astype(np.float32)
    elif targets == "index":
        t = rng.integers(0, shape[-1], shape[:-1])
    elif targets == "onehot":
        t = np.eye(shape[-1], dtype=np.float32)[
            rng.integers(0, shape[-1], shape[:-1])]
    else:
        t = (2.0 * rng.standard_normal(shape)).astype(np.float32)
    lshape = JH.temporal_loss(jnp.asarray(p), jnp.asarray(t), task,
                              reduction="none").shape
    mask = (rng.random(lshape) < 0.7).astype(np.float32)
    tw = rng.random(lshape[:2]).astype(np.float32)
    return p, t, mask, tw


@pytest.mark.parametrize("task,shape,targets", LOSS_CASES)
def test_temporal_loss_families(task, shape, targets):
    """Every family's value under each reduction, with a mask, time
    weights and its own parameters, and the gradient of the mean with
    respect to the predictions, against JAX's."""
    p, t, mask, tw = _loss_inputs(task, shape, targets)
    params = dict(focal_gamma=1.5, focal_alpha=0.3, huber_delta=0.7,
                  quantile_tau=0.8)
    for kw in ({}, {"reduction": "none"},
               dict(params, mask=mask, reduction="sum"),
               dict(params, mask=mask, time_weights=tw)):
        jkw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
               for k, v in kw.items()}
        tkw = {k: _t(v) if isinstance(v, np.ndarray) else v
               for k, v in kw.items()}

        def jloss(pp):
            return JH.temporal_loss(pp, jnp.asarray(t), task, **jkw)
        tp = _t(p).requires_grad_(True)
        got = TH.temporal_loss(tp, _t(t), task, **tkw)
        if kw.get("reduction", "mean") != "mean":
            _close(got, jloss(jnp.asarray(p)))
            continue
        want, grad = jax.value_and_grad(jloss)(jnp.asarray(p))
        _close(got, want)
        got.backward()
        _close(tp.grad, grad)


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_asymmetric_focal_loss(reduction):
    rng = np.random.default_rng(1)
    p = (2.0 * rng.standard_normal((7, 4))).astype(np.float32)
    t = (rng.random((7, 4)) < 0.3).astype(np.float32)
    w = rng.random(7).astype(np.float32)
    for kw in ({}, dict(gamma_pos=1.0, gamma_neg=2.0, clip=0.0),
               dict(clip=0.1)):
        for weights in (None, w):
            want = JH.asymmetric_focal_loss(
                jnp.asarray(p), jnp.asarray(t), reduction=reduction,
                weights=None if weights is None else jnp.asarray(weights),
                **kw)
            got = TH.asymmetric_focal_loss(
                _t(p), _t(t), reduction=reduction,
                weights=None if weights is None else _t(weights), **kw)
            _close(got, want)


def test_temporal_loss_module():
    """Weighted per-task losses with per-task and default parameters,
    the task losses returned, the single-tensor path."""
    rng = np.random.default_rng(2)
    configs = {"a": {"task_type": "focal", "loss_weight": 0.5,
                     "focal_gamma": 1.0},
               "b": {"task_type": "huber", "huber_delta": 0.5},
               "c": {"task_type": "quantile"},
               "d": {"task_type": "multi_class", "loss_weight": 2.0}}
    loss_config = {"focal_alpha": 0.4, "quantile_tau": 0.3}
    preds = {"a": rng.standard_normal((5, 1)).astype(np.float32),
             "b": rng.standard_normal((5, 2)).astype(np.float32),
             "c": rng.standard_normal((5, 3)).astype(np.float32),
             "d": rng.standard_normal((5, 4)).astype(np.float32),
             "e": rng.standard_normal((5, 2)).astype(np.float32)}
    targets = {"a": (rng.random((5, 1)) < 0.5).astype(np.float32),
               "b": rng.standard_normal((5, 2)).astype(np.float32),
               "c": rng.standard_normal((5, 3)).astype(np.float32),
               "d": rng.integers(0, 4, 5)}
    jmod = JH.TemporalLossModule.create(configs, loss_config)
    tmod = TH.TemporalLossModule.create(configs, loss_config)
    want, want_tasks = jmod({k: jnp.asarray(v) for k, v in preds.items()},
                            {k: jnp.asarray(v) for k, v in targets.items()},
                            return_task_losses=True)
    got, got_tasks = tmod({k: _t(v) for k, v in preds.items()},
                          {k: _t(v) for k, v in targets.items()},
                          return_task_losses=True)
    _close(got, want)
    assert set(got_tasks) == set(want_tasks) == {"a", "b", "c", "d"}
    for k in want_tasks:
        _close(got_tasks[k], want_tasks[k])
    single = TH.TemporalLossModule.create({}, default_task_type="mse")
    _close(single(_t(preds["b"]), _t(targets["b"])),
           JH.TemporalLossModule.create({}, default_task_type="mse")(
               jnp.asarray(preds["b"]), jnp.asarray(targets["b"])))


TASKS = {"cls": {"task_type": "classification"},
         "lab": {"task_type": "multi_label", "output_dim": 3},
         "mc": {"task_type": "multi_class", "output_dim": 4,
                "num_layers": 2},
         "reg": {"task_type": "regression", "output_dim": 2}}


def _task_labels(rng, n):
    return {"cls": (rng.random((n, 1)) < 0.5).astype(np.float32),
            "lab": (rng.random((n, 3)) < 0.5).astype(np.float32),
            "mc": rng.integers(0, 4, n),
            "reg": rng.standard_normal((n, 2)).astype(np.float32)}


@pytest.mark.parametrize("task_type,out", [("classification", 1),
                                           ("classification", 3),
                                           ("multi_label", 3),
                                           ("regression", 2)])
def test_temporal_prediction_head(task_type, out):
    """The MLP head (and its sigmoid for classification and multi_label)
    with JAX's weights; the binary head's final bias starts at 0.5 on
    both sides."""
    jh = JH.TemporalPredictionHead(hidden_dim=8, output_dim=out,
                                   task_type=task_type, dropout=0.0)
    jp = jh.init(jax.random.key(1))
    th = TH.TemporalPredictionHead(8, out, task_type, dropout=0.0)
    np.testing.assert_array_equal(th.linear_1.b.detach().numpy(),
                                  np.asarray(jp["linear_1"]["b"]))
    _load(th, jp)
    x = np.random.default_rng(3).standard_normal((5, 8)).astype(np.float32)
    _close(th(_t(x)), jh(jp, jnp.asarray(x)))


@pytest.mark.parametrize("shared_layers,use_layer_norm", [(1, True),
                                                          (2, False)])
def test_multi_task_prediction_head(shared_layers, use_layer_norm):
    jh = JH.MultiTaskPredictionHead.create(
        8, TASKS, shared_layers=shared_layers, dropout=0.0,
        use_layer_norm=use_layer_norm)
    jp = jh.init(jax.random.key(2))
    th = _load(TH.MultiTaskPredictionHead(
        8, TASKS, shared_layers=shared_layers,
        use_layer_norm=use_layer_norm, dropout=0.0), jp)
    x = np.random.default_rng(4).standard_normal((6, 8)).astype(np.float32)
    want = jh(jp, jnp.asarray(x))
    got = th(_t(x))
    assert set(got) == set(want) == set(TASKS)
    for k in want:
        _close(got[k], want[k])


def test_classification_module_multi_task():
    """``ClassificationModule(multi_task=True)``: JAX's parameter tree
    loads strictly, the predictions, and the summed loss with its
    probability-space BCE, with gradients, against JAX's."""
    jm = JH.ClassificationModule(
        hidden_dim=8, multi_task=True, dropout=0.0,
        task_configs=JH.MultiTaskPredictionHead.create(8, TASKS).task_configs)
    jp = jm.init(jax.random.key(5))
    tm = _load(pt.ClassificationModule(8, multi_task=True, task_configs=TASKS,
                                       dropout=0.0), jp)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((6, 8)).astype(np.float32)
    labels = _task_labels(rng, 6)
    want = jm(jp, jnp.asarray(x))
    got = tm(_t(x))
    for k in want:
        _close(got[k], want[k])

    def jloss(p):
        return jm(p, jnp.asarray(x), labels={k: jnp.asarray(v)
                                             for k, v in labels.items()})[0]
    loss, preds = tm(_t(x), labels={k: _t(v) for k, v in labels.items()})
    want_loss, want_grad = jax.jit(jax.value_and_grad(jloss))(jp)
    _close(loss, want_loss)
    loss.backward()
    jg = params_from_jax(jax.tree_util.tree_map(np.asarray, want_grad))
    for name, param in tm.named_parameters():
        _close(param.grad, jg[name])
    with pytest.raises(ValueError, match="task_configs"):
        pt.ClassificationModule(8, multi_task=True)


@pytest.mark.parametrize("loss_type,pooling", [("mse", "attention"),
                                               ("mae", "mean"),
                                               ("huber", "attention")])
def test_regression_module(loss_type, pooling):
    jm = JH.RegressionModule(hidden_dim=8, output_dim=2, dropout=0.0,
                             pooling_type=pooling, loss_type=loss_type,
                             huber_delta=0.5)
    jp = jm.init(jax.random.key(7))
    tm = _load(pt.RegressionModule(8, 2, pooling_type=pooling,
                                   loss_type=loss_type, huber_delta=0.5,
                                   dropout=0.0), jp)
    rng = np.random.default_rng(8)
    x = rng.standard_normal((4, 5, 8)).astype(np.float32)
    mask = rng.random((4, 5)) < 0.8
    mask[:, 0] = True
    y = rng.standard_normal((4, 2)).astype(np.float32)
    _close(tm(_t(x), _t(mask)), jm(jp, jnp.asarray(x), jnp.asarray(mask)))
    loss, preds = tm(_t(x), _t(mask), _t(y))
    want_loss, want_preds = jm(jp, jnp.asarray(x), jnp.asarray(mask),
                               jnp.asarray(y))
    _close(loss, want_loss)
    _close(preds, want_preds)


# ---------------------------------------------------------------------------
# Each loss_type through the model
# ---------------------------------------------------------------------------

def _loss_type_labels(loss_type, out, rng, B):
    """Labels per sequence in the port's batched form: [B] scalars, or
    [B, C] in the logits' shape (JAX's per-sequence [1, C])."""
    if loss_type == "multi_label":
        return (rng.random((B, out)) < 0.5).astype(np.float32)
    if loss_type == "focal" and out > 1:
        return np.eye(out, dtype=np.float32)[rng.integers(0, out, B)]
    if loss_type in ("ce", "multi_class"):
        return rng.integers(0, out, B)
    if loss_type in ("bce", "classification", "focal"):
        return (rng.random(B) < 0.5).astype(np.float32)
    if out > 1:
        return rng.standard_normal((B, out)).astype(np.float32)
    return rng.standard_normal(B).astype(np.float32)


# every VALID_LOSS_TYPES entry; focal and the regression families also
# with several outputs, where the labels take the logits' shape
MODEL_CASES = [(lt, 3 if lt in ("ce", "multi_class", "multi_label") else 1)
               for lt in VALID_LOSS_TYPES] + [
    ("focal", 3), ("regression", 3), ("huber", 3), ("quantile", 3)]


@pytest.fixture(scope="module")
def model_data():
    data = create_dynamic_synthetic_data(
        num_samples=3, sequence_length=3, num_nodes_range=(6, 9),
        node_feature_dim=4, seed=1)
    seqs = [s for s, _ in data]
    T, N, E, _ = tt.pad_dims_for(seqs)
    kw = dict(max_nodes=N, max_edges=E, max_time=T)
    return (tt.batch_sequences([tt.build_sequence(s, **kw) for s in seqs]),
            pt.batch_sequences([pt.build_sequence(s, **kw) for s in seqs]))


@pytest.fixture(scope="module")
def logits_vjp(model_data):
    """Per output_dim: the JAX model's parameters, and its logits over
    the batch with their VJP. The weights do not depend on the loss type,
    so each loss type's ``jax.grad`` is this VJP of its loss's cotangent,
    without compiling the model once per type."""
    jb = model_data[0]
    out = {}
    for od in (1, 3):
        jm = JTAGAN(tt.TAGANConfig(**_model_cfg("bce", od)))
        jp = jm.init(jax.random.key(0))

        @jax.jit
        def logits_and_pullback(p, ct, jm=jm):
            logits, vjp = jax.vjp(
                lambda q: j_batched_forward(jm, q, jb).logits, p)
            return logits, vjp(ct)[0]
        logits, _ = logits_and_pullback(jp, jnp.zeros((3, od)))
        out[od] = (jp, logits,
                   lambda ct, f=logits_and_pullback, p=jp: f(p, ct)[1])
    return out


def _model_cfg(loss_type, od):
    """A light model (the loss reads only its logits): one layer, no
    time awareness, gating or relative-position bias, mean pooling."""
    return dict(hidden_dim=8, num_heads=2, num_layers=1, node_feature_dim=4,
                output_dim=od, loss_type=loss_type, dropout=0.0,
                head_num_layers=1, spatial_backend="dense",
                time_aware=False, use_gating=False,
                asymmetric_temporal_bias=False, pooling_type="mean",
                focal_alpha=0.3, focal_gamma=1.5)


@pytest.mark.parametrize("loss_type,od", MODEL_CASES)
def test_model_loss_matches_jax(loss_type, od, model_data, logits_vjp):
    """``TAGAN`` with each ``loss_type``: the batch's loss and every
    parameter's gradient against ``jax.grad`` of JAX's ``batched_forward``
    loss (its per-sequence ``compute_loss`` under ``vmap``, with the
    config's focal_alpha and focal_gamma)."""
    jp, logits, vjp = logits_vjp[od]
    jm = JTAGAN(tt.TAGANConfig(**_model_cfg(loss_type, od)))
    tb = model_data[1]
    y = _loss_type_labels(loss_type, od, np.random.default_rng(9), 3)
    jy = jnp.asarray(y[:, None] if y.ndim == 2 else y)

    def jloss(lg):
        return jnp.mean(jax.vmap(jm.compute_loss)(lg, jy))
    want, dlogits = jax.value_and_grad(jloss)(logits)
    want_grads = params_from_jax(jax.tree_util.tree_map(
        np.asarray, vjp(dlogits)))
    tm = pt.TAGAN(pt.TAGANConfig(**_model_cfg(loss_type, od)), device="cpu")
    _load(tm, jp)
    out = pt.batched_forward(tm, tb, _t(y))
    _close(out.logits, logits)
    _close(out.loss, want)
    out.loss.backward()
    noise = 1e-6 * max(w.abs().max().item() for w in want_grads.values())
    for name, param in tm.named_parameters():
        w = want_grads[name]
        m = w.abs().max().item()
        if m < noise:
            assert param.grad.abs().max().item() < noise, name
        else:
            assert (param.grad - w).abs().max().item() <= TOL * m, name
