"""The port's layers (tagan_torch.nn, core.memory) against the JAX
package's, with the JAX parameters converted (tagan_torch.convert)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tagan_tpu.core import memory as JMEM
from tagan_tpu.nn import heads as JH
from tagan_tpu.nn.geometric import GeometricAttention as JGeo
from tagan_tpu.nn.propagation import TemporalPropagation as JProp
from tagan_tpu.nn.temporal_attention import \
    AsymmetricTemporalAttention as JAsym
from tagan_tpu.nn.time_encoding import TimeEncoding as JTE
from tagan_tpu.ops.pallas import flash_geometric as JFG
from tagan_torch.convert import params_from_jax
from tagan_torch.core import memory as TMEM
from tagan_torch.nn import heads as TH
from tagan_torch.nn.geometric import GeometricAttention as TGeo
from tagan_torch.nn.propagation import TemporalPropagation as TProp
from tagan_torch.nn.temporal_attention import \
    AsymmetricTemporalAttention as TAsym
from tagan_torch.nn.time_encoding import TimeEncoding as TTE

TOL = 2e-4     # fp32 on both sides; flash forward vs dense: 2e-4


@pytest.fixture(scope="module")
def interpret():
    import jax.experimental.pallas as pl
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JFG.pl, "pallas_call",
                   functools.partial(pl.pallas_call, interpret=True))
        yield


def _t(a):
    return torch.from_numpy(np.array(a))


def _load(module, jax_params):
    module.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jax_params)))
    return module


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("metric,learnable", [
    ("euclidean", False), ("scaled_dot_product", True),
    ("cosine_distance", False), ("gaussian_kernel", True),
    ("rbf_kernel", True), ("mahalanobis", True), ("manhattan", False)])
def test_geometric_attention_dense_and_flash(metric, learnable, interpret):
    hid, heads, n = 16, 2, 30
    jl = JGeo(hidden_dim=hid, num_heads=heads, dropout=0.0,
              distance_metric=metric, learnable_distance=learnable)
    p = jl.init(jax.random.key(3))
    tl = _load(TGeo(hid, heads, metric, True, learnable), p)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, n, hid)).astype(np.float32)
    adj = rng.random((2, n, n)) < 0.25
    adj[:, np.arange(n), np.arange(n)] = True
    adj[0, 4] = False                                 # a dead row
    with torch.no_grad():
        _close(tl(_t(x), _t(adj)), jl(p, jnp.asarray(x), jnp.asarray(adj)))
        got = tl.apply_flash(_t(x), _t(adj))
    want = jl.apply_flash(p, jnp.asarray(x), jnp.asarray(adj),
                          block_m=16, block_n=16)
    _close(got, want)


@pytest.mark.parametrize("enc,learnable", [
    ("basis", True), ("sinusoidal", False), ("sinusoidal", True),
    ("linear", True), ("log", False), ("learned", True)])
def test_time_encoding(enc, learnable):
    je = JTE(d_model=12, learnable=learnable, encoding_type=enc,
             num_bases=5, max_len=50)
    p = je.init(jax.random.key(1))
    te = _load(TTE(12, max_len=50, learnable=learnable, encoding_type=enc,
                   num_bases=5), p)
    rng = np.random.default_rng(1)
    tv = rng.uniform(-3, 9, (3, 4, 4)).astype(np.float32)
    x = rng.standard_normal((3, 7, 12)).astype(np.float32)
    with torch.no_grad():
        _close(te(_t(tv)), je(p, jnp.asarray(tv)), 1e-5)
        _close(te(x=_t(x)), je(p, x=jnp.asarray(x)), 1e-5)
        # batch_dims: each leading slice normalised on its own
        per = torch.stack([te(_t(tv[i])) for i in range(3)])
        _close(te(_t(tv), batch_dims=1), per.numpy(), 1e-6)


@pytest.mark.parametrize("causal,orient,enc", [
    (False, True, "basis"), (True, False, "basis"),
    (False, False, "sinusoidal")])
def test_asymmetric_temporal_attention(causal, orient, enc):
    hid, heads, T = 16, 2, 6
    ja = JAsym(hidden_dim=hid, num_heads=heads, dropout=0.0, causal=causal,
               asymmetric_window_size=2, max_relative_position=3,
               time_encoding_type=enc, max_time_diff=2.5,
               orient_past_high=orient)
    p = ja.init(jax.random.key(2))
    ta = _load(TAsym(hid, heads, causal=causal, asymmetric_window_size=2,
                     max_relative_position=3, time_encoding_type=enc,
                     max_time_diff=2.5, orient_past_high=orient), p)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((5, T, hid)).astype(np.float32)
    ts = np.sort(rng.uniform(0, 6, (5, T)), axis=1).astype(np.float32)
    valid = np.arange(T) < T - 1                       # a padded last step
    mask = valid[None, :] & valid[:, None]
    with torch.no_grad():
        got = ta(_t(x), _t(ts), _t(mask))
    _close(got, ja(p, jnp.asarray(x), jnp.asarray(ts), jnp.asarray(mask)))


def test_memory_update_matches_jax():
    rng = np.random.default_rng(4)
    n, h = 12, 5
    jm, tm = JMEM.init_memory(n, h), TMEM.init_memory(n, h)
    for t in range(9):
        active = rng.random(n) < 0.4
        states = rng.standard_normal((n, h)).astype(np.float32)
        states[0, 1] = np.nan if t == 3 else states[0, 1]
        jm = JMEM.memory_update(jm, jnp.asarray(active), jnp.asarray(states),
                                t, decay_factor=0.7, max_inactivity=2)
        tm = TMEM.memory_update(tm, _t(active), _t(states), t,
                                decay_factor=0.7, max_inactivity=2)
    for f in ("states", "valid", "last_seen", "inactivity", "frequency"):
        np.testing.assert_allclose(getattr(tm, f).numpy(),
                                   np.asarray(getattr(jm, f)), rtol=1e-6,
                                   atol=1e-6)
    js, jh = JMEM.memory_read(jm)
    ts, th = TMEM.memory_read(tm)
    _close(ts, js, 1e-6)
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))


@pytest.mark.parametrize("variant", [
    {}, {"bidirectional": True, "aggregation": "max"},
    {"use_gating": False, "aggregation": "sum"}])
def test_temporal_propagation_with_memory(variant):
    hid, T, n = 8, 6, 10
    jp_ = JProp(input_dim=hid, hidden_dim=hid, dropout=0.0,
                max_inactivity=2, **variant)
    p = jp_.init(jax.random.key(5))
    tp = _load(TProp(hid, hid, max_inactivity=2, **variant), p)
    rng = np.random.default_rng(5)
    mem_j, mem_t = None, None
    for call in range(2):                   # the second call carries memory
        x = rng.standard_normal((T, n, hid)).astype(np.float32)
        nm = rng.random((T, n)) < 0.6
        ts = np.cumsum(rng.uniform(0.5, 2, T)).astype(np.float32)
        tmask = np.arange(T) < T - call     # padded tail on the second call
        out_j = jp_(p, jnp.asarray(x), jnp.asarray(nm), jnp.asarray(ts),
                    mem_j, jnp.asarray(tmask))
        with torch.no_grad():
            out_t = tp(_t(x)[None], _t(nm)[None], _t(ts)[None], mem_t,
                       _t(tmask)[None])
        _close(out_t.features[0], out_j.features)
        for f in ("states", "valid", "last_seen", "inactivity", "frequency"):
            np.testing.assert_allclose(
                getattr(out_t.memory, f)[0].numpy(),
                np.asarray(getattr(out_j.memory, f)), rtol=TOL, atol=TOL)
        mem_j, mem_t = out_j.memory, out_t.memory


@pytest.mark.parametrize("pooling", ["attention", "mean", "max", "last",
                                     "first"])
def test_classification_head(pooling):
    hid, C = 8, 3
    jh = JH.ClassificationModule(hidden_dim=hid, output_dim=C,
                                 task_type="ce", pooling_type=pooling,
                                 dropout=0.0)
    p = jh.init(jax.random.key(6))
    th = _load(TH.ClassificationModule(hid, C, task_type="ce",
                                       pooling_type=pooling), p)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((4, 5, hid)).astype(np.float32)
    mask = rng.random((4, 5)) < 0.7
    mask[:, 0] = True
    labels = np.asarray([0, 2, 1, 2])
    j_loss, j_logits = jh(p, jnp.asarray(x), jnp.asarray(mask),
                          jnp.asarray(labels))
    with torch.no_grad():
        t_loss, t_logits = th(_t(x), _t(mask), _t(labels))
        _close(th(_t(x), _t(mask)), j_logits, 1e-5)
    _close(t_logits, j_logits, 1e-5)
    _close(t_loss, j_loss, 1e-5)


@pytest.mark.parametrize("task", ["classification", "multi_class"])
def test_temporal_loss(task):
    rng = np.random.default_rng(7)
    if task == "classification":
        p = rng.standard_normal((6, 3)).astype(np.float32)
        t = (rng.random((6, 3)) < 0.5).astype(np.float32)
        m = (rng.random((6, 3)) < 0.7).astype(np.float32)
    else:
        p = rng.standard_normal((6, 4)).astype(np.float32)
        t = rng.integers(0, 4, 6)
        m = (rng.random(6) < 0.7).astype(np.float32)
    for kw in ({}, {"mask": m}, {"reduction": "none"}):
        want = JH.temporal_loss(jnp.asarray(p), jnp.asarray(t), task,
                                **{k: jnp.asarray(v) if k == "mask" else v
                                   for k, v in kw.items()})
        got = TH.temporal_loss(_t(p), _t(t), task,
                               **{k: _t(v) if k == "mask" else v
                                  for k, v in kw.items()})
        _close(got, want, 1e-5)
    with pytest.raises(NotImplementedError):
        TH.temporal_loss(_t(p), _t(p), "huber")
