"""The port's ops (tagan_torch.ops) against the JAX package's.

Same numpy inputs through both; the Pallas forward runs in interpret
mode on the CPU. The CUDA kernel itself is compared with its plain
version only on a GPU (tests/test_torch_gpu.py, marked ``gpu``;
chip_smoke.py does the same at the model's shapes)."""

import functools
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tagan_tpu.ops import distances as JD
from tagan_tpu.ops import masked as JM
from tagan_tpu.ops.pallas import flash_geometric as JFG
from tagan_torch.ops import distances as TD
from tagan_torch.ops import flash_geometric as TFG
from tagan_torch.ops import masked as TM

# fp32 on both sides; the flash forward's norm expansion vs the dense
# oracle's subtract-then-square is why tests/test_flash_kernel.py uses
# 2e-4, and the same bound holds plain vs Pallas here
TOL = 2e-4


@pytest.fixture(scope="module")
def interpret():
    import jax.experimental.pallas as pl
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JFG.pl, "pallas_call",
                   functools.partial(pl.pallas_call, interpret=True))
        yield


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_masked_ops_match_jax():
    rng = np.random.default_rng(0)
    s = rng.standard_normal((3, 5, 7)).astype(np.float32)
    m = rng.random((3, 5, 7)) < 0.5
    m[1, 2] = False                                  # a dead row
    got = TM.masked_softmax(_t(s), _t(m)).numpy()
    want = np.asarray(JM.masked_softmax(jnp.asarray(s), jnp.asarray(m)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert np.all(got[1, 2] == 0)
    x = rng.standard_normal((3, 5, 4)).astype(np.float32)
    nm = rng.random((3, 5)) < 0.6
    for jf, tf in ((JM.masked_mean, TM.masked_mean),
                   (JM.masked_max, TM.masked_max)):
        np.testing.assert_allclose(
            tf(_t(x), _t(nm), dim=1).numpy(),
            np.asarray(jf(jnp.asarray(x), jnp.asarray(nm), axis=1)),
            rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("metric", JD.ALL_METRICS)
def test_distances_match_jax(metric):
    rng = np.random.default_rng(1)
    q = rng.standard_normal((2, 3, 9, 6)).astype(np.float32)
    k = rng.standard_normal((2, 3, 9, 6)).astype(np.float32)
    q[0, 0, 2] = 0.0                                 # zero-norm guard
    scale = np.asarray([0.5, 1.0, 1.7], np.float32)
    f = rng.standard_normal((3, 4, 6)).astype(np.float32)
    cov = np.einsum("hrd,hre->hde", f, f)
    kw = dict(sigma=scale if metric == "gaussian_kernel" else None,
              gamma=scale if metric == "rbf_kernel" else None,
              cov_inv=cov if metric == "mahalanobis" else None)
    want = np.asarray(JD.pairwise_scores(
        metric, jnp.asarray(q), jnp.asarray(k),
        **{a: None if b is None else jnp.asarray(b) for a, b in kw.items()}))
    got = TD.pairwise_scores(metric, _t(q), _t(k), **{
        a: None if b is None else _t(b) for a, b in kw.items()}).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("bm,bn", [(16, 16), (16, 32), (32, 16)])
def test_block_plans_match_jax(bm, bn):
    rng = np.random.default_rng(2)
    n, e = 70, 90
    src = rng.integers(0, n, e).astype(np.int32)
    dst = (src + rng.integers(-10, 10, e)).clip(0, n - 1).astype(np.int32)
    em = rng.random(e) < 0.8
    nm = rng.random(n) < 0.9
    want = JFG.make_block_plans_from_edges(
        jnp.asarray(src), jnp.asarray(dst), jnp.asarray(em), jnp.asarray(nm),
        n, bm, bn)
    got = TFG.make_block_plans_from_edges(_t(src), _t(dst), _t(em), _t(nm),
                                          n, bm, bn)
    mask = np.zeros((n, n), np.int8)
    mask[src[em], dst[em]] = 1
    mask[np.arange(n), np.arange(n)] = nm
    want_m = JFG.make_block_plans_from_mask(jnp.asarray(mask), bm, bn)
    got_m = TFG.make_block_plans_from_mask(_t(mask), bm, bn)
    got_f = (TFG.make_block_plan(_t(mask), bm, bn),)
    for w, g in ((want, got), (want_m, got_m), (want, got_m),
                 (want[:1], got_f)):
        for wp, gp in zip(w, g):
            for wa, ga in zip(wp, gp):
                assert ga.dtype == torch.int32
                np.testing.assert_array_equal(ga.numpy(), np.asarray(wa))


def test_keep_mask_bit_exact():
    for seed in (0, 1, -1, -123456789, 2 ** 31 - 1, -2 ** 31):
        for h in (0, 1, 7):
            for r0, c0 in ((0, 0), (64, 1024), (9984, 320), (512, 9936)):
                for rate in (0.1, 0.5, 0.9):
                    th = JFG._keep_thresh(rate)
                    assert th == TFG._keep_thresh(rate)
                    want = np.asarray(JFG._keep_mask(
                        jnp.int32(seed), jnp.int32(h), r0, c0, 8, 32, th))
                    got = TFG._keep_mask(seed, h, r0, c0, 8, 32, th).numpy()
                    np.testing.assert_array_equal(got, want)


def _flash_data(seed=3, H=2, N=44, D=16, Dv=8):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((H, N, D)).astype(np.float32)
    k = rng.standard_normal((H, N, D)).astype(np.float32)
    v = rng.standard_normal((H, N, Dv)).astype(np.float32)
    adj = rng.random((N, N)) < 0.3
    np.fill_diagonal(adj, True)
    adj[3] = False                                   # dead row
    adj[N - 1] = False
    return q, k, v, adj


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("metric", JFG.MXU_METRICS)
def test_flash_plain_matches_pallas(metric, rate, interpret):
    """The plain forward (what the CUDA kernel computes) against the
    Pallas forward: out and lse, D != Dv, per-head scale, in-kernel
    dropout from the same seed, dead rows exactly."""
    q, k, v, adj = _flash_data()
    scale = np.asarray([0.7, 1.6], np.float32) \
        if metric in JFG.SCALED_METRICS else None
    seed = -987654
    w_out, w_lse = JFG._flash_forward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(adj),
        metric=metric, block_m=16, block_n=16,
        scale_param=None if scale is None else jnp.asarray(scale),
        seed=jnp.asarray([seed], jnp.int32), dropout_rate=rate,
        return_lse=True)
    out, lse = TFG.flash_geometric_attention(
        _t(q), _t(k), _t(v), _t(adj), metric=metric,
        scale_param=None if scale is None else _t(scale),
        dropout_rate=rate, dropout_seed=seed, return_lse=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(w_out),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(w_lse),
                               rtol=TOL, atol=TOL)
    for row in (3, q.shape[1] - 1):
        assert np.all(out.numpy()[:, row] == 0)
        assert np.all(lse.numpy()[:, row] == TFG.LSE_DEAD)


def test_flash_folds_leading_dims():
    """Leading dims fold into one batched call: each slice equals its own
    call, with its own dropout seed."""
    slices = [_flash_data(seed=s) for s in range(6)]
    q, k, v, adj = (np.stack([s[i] for s in slices]).reshape(
        (2, 3) + slices[0][i].shape) for i in range(4))
    seeds = np.arange(6, dtype=np.int32).reshape(2, 3) - 3
    out = TFG.flash_geometric_attention(
        _t(q), _t(k), _t(v), _t(adj), metric="euclidean", dropout_rate=0.2,
        dropout_seed=_t(seeds))
    for a in range(2):
        for b in range(3):
            one = TFG.flash_geometric_attention(
                _t(q[a, b]), _t(k[a, b]), _t(v[a, b]), _t(adj[a, b]),
                metric="euclidean", dropout_rate=0.2,
                dropout_seed=int(seeds[a, b]))
            np.testing.assert_array_equal(out[a, b].numpy(), one.numpy())


def test_cpu_wrapper_takes_the_plain_path():
    q, k, v, adj = (_t(a)[None] for a in _flash_data())
    plan = TFG.make_block_plan(adj)
    kern = TFG.flash_geometric_fwd_kernel
    before = kern.launches
    out, lse = TFG.flash_geometric_fwd(q, k, v, adj, *plan, metric="dot_product")
    p_out, p_lse = TFG.flash_geometric_forward_plain(q, k, v, adj,
                                                     "dot_product")
    assert kern.launches == before
    np.testing.assert_array_equal(out.numpy(), p_out.numpy())
    np.testing.assert_array_equal(lse.numpy(), p_lse.numpy())
    with pytest.raises(ValueError, match="CUDA"):
        kern(q, k, v, adj, *plan, "dot_product", torch.ones(2),
             torch.zeros(1, dtype=torch.int32), 0.0)


def _bad_plan(case, plan):
    jlist, jcount = (p.clone() for p in plan)
    if case == "negative_block":
        jlist[0, 1, 0] = -1
    elif case == "block_past_end":
        jlist[0, 0, -1] = jlist.shape[-1]
    elif case == "count_past_width":
        jcount[0, 2] = jlist.shape[-1] + 1
    elif case == "negative_count":
        jcount[0, 0] = -1
    else:
        jcount = jcount[..., 1:]
    return jlist, jcount


@pytest.mark.parametrize("case", ["negative_block", "block_past_end",
                                  "count_past_width", "negative_count",
                                  "shape"])
def test_caller_plan_is_checked(case):
    """A plan from the caller is checked before it could reach the
    kernel, which reads tiles at its indices unchecked."""
    q, k, v, adj = (_t(a)[None] for a in _flash_data(N=150))
    plan = TFG.make_block_plan(adj)
    TFG.check_plan(*plan, 150)
    bad = _bad_plan(case, plan)
    with pytest.raises(ValueError, match="plan"):
        TFG.flash_geometric_fwd(q, k, v, adj, *bad, metric="dot_product")
    with pytest.raises(ValueError, match="plan"):
        TFG.flash_geometric_attention(q, k, v, adj, metric="dot_product",
                                      plan=bad)


def test_cuda_requested_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    import tagan_torch as tt
    cfg = tt.TAGANConfig(hidden_dim=8, num_heads=2, node_feature_dim=4)
    with pytest.raises(RuntimeError, match="cuda"):
        tt.TAGAN(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        tt.TAGAN(cfg, device="cuda")


def test_port_imports_neither_jax_nor_tagan_tpu():
    code = (
        "import sys, pkgutil, importlib, tagan_torch\n"
        "for m in pkgutil.walk_packages(tagan_torch.__path__, 'tagan_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or n.startswith("
        "('jax.', 'jaxlib', 'tagan_tpu')))\n"
        "assert not bad, bad\n"
        "print(len([n for n in sys.modules if n.startswith('tagan_torch')]))\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 15
