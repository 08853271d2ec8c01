"""The backward of the port's edge-biased flash attention (tagan_torch) against
the JAX package's on the CPU: the plain biased backward and its three parts
(what kernels B6, B7a and B7b compute) against
``flash_biased_attention_bwd`` with its Pallas kernels in interpret mode,
and the differentiable entry under autograd against ``jax.vjp`` of
``_flash_diff_biased``, with numpy inputs."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tagan_tpu.ops.pallas import flash_geometric as JFG
from tagan_torch.ops import flash_geometric as TFG

# torch's CPU operations on one thread: the tier-1 command runs six
# pytest workers on 8 cores, and torch's default of a thread per core
# oversubscribes them
torch.set_num_threads(1)

# fp32 on both sides, sums in another order; errors are taken over each
# tensor's largest entry (at least 1), since gradients span many scales
TOL = 1e-4
BLOCK = 16      # the JAX kernels' tile here: N=40 pads to 3 x 3 blocks
SEED = -987654


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
    want = np.asarray(want, np.float64)
    got = got.detach().numpy().astype(np.float64)
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


@pytest.fixture(scope="module")
def biased_inputs():
    """One snapshot, H=3, N=40 (not a multiple of the 16-row tile), D != Dv:
    a mask with the diagonal, a dead row in the middle of a live tile, an
    empty key strip (keys 16..31: each row walks 2 of the 3 key blocks),
    a bias on the mask's pairs and the cotangent of out."""
    rng = np.random.default_rng(31)
    H, N, D, Dv = 3, 40, 16, 8
    q, k = (rng.standard_normal((H, N, D)).astype(np.float32)
            for _ in range(2))
    v, do = (rng.standard_normal((H, N, Dv)).astype(np.float32)
             for _ in range(2))
    adj = rng.random((N, N)) < 0.3
    np.fill_diagonal(adj, True)
    adj[:, BLOCK:2 * BLOCK] = False
    adj[5] = False
    bias = np.where(adj, rng.standard_normal((N, N)), 0.0).astype(np.float32)
    return q, k, v, do, adj, bias


def _metric_inputs(metric, biased_inputs):
    q, k, v, do, adj, bias = biased_inputs
    if metric in TFG._COSINE:
        q = q / np.linalg.norm(q, axis=-1, keepdims=True)
        k = k / np.linalg.norm(k, axis=-1, keepdims=True)
    sc = np.asarray([0.7, 1.1, 1.6], np.float32) \
        if metric in TFG.SCALED_METRICS else None
    return q, k, v, do, adj, bias, sc


def _jax_backward(q, k, v, do, adj, bias, sc, metric, rate, need):
    """JAX's forward and ``flash_biased_attention_bwd``; delta1 is read
    off the output of its walk A (``_biased_bwd_pre_kernel``)."""
    seeds = jnp.asarray([SEED, SEED ^ 0x5BD1E995], jnp.int32)
    jq, jk, jv, jadj, jb = (jnp.asarray(a) for a in (q, k, v, adj, bias))
    jsc = None if sc is None else jnp.asarray(sc)
    out, lse1, lse2 = JFG._flash_biased_forward(
        jq, jk, jv, jadj, jb, metric=metric, scale_param=jsc, block_m=BLOCK,
        block_n=BLOCK, seeds=seeds, dropout_rate=rate, return_lse=True)
    walk_a = {}
    pcall = JFG._pcall

    def capture(kernel, **kw):
        call = pcall(kernel, **kw)
        if getattr(kernel, "func", None) is not JFG._biased_bwd_pre_kernel:
            return call

        def run(*args):
            walk_a["delta1"], _ = res = call(*args)
            return res
        return run
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JFG, "_pcall", capture)
        grads = JFG.flash_biased_attention_bwd(
            jq, jk, jv, jb, jadj, out, lse1, lse2, jnp.asarray(do),
            metric=metric, scale=jsc, block_m=BLOCK, block_n=BLOCK,
            seeds=seeds, dropout_rate=rate, need_dscale=need)
    delta1 = np.asarray(walk_a["delta1"])[:q.shape[1]].T       # [H, N]
    return (out, lse1, lse2), grads, delta1


@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("metric", TFG.MXU_METRICS)
def test_biased_plain_backward_matches_pallas(metric, rate, biased_inputs,
                                              interpret):
    """dq, dk, dv, dscale (gaussian/rbf), delta1 and dB (under the mask)
    of the plain biased backward and of its three parts against JAX's,
    every metric, dropout 0 and 0.3 from the same seed pair (pairs that
    drop1 drops and drop2 keeps, and the opposite, both occur); a dead
    row gives zeros; the public entry on CPU tensors is the plain
    version."""
    q, k, v, do, adj, bias, sc = _metric_inputs(metric, biased_inputs)
    need = metric in TFG.SCALED_METRICS
    (out, lse1, lse2), want, want_d1 = _jax_backward(
        q, k, v, do, adj, bias, sc, metric, rate, need)
    seeds = TFG.biased_seeds(SEED, 1, "cpu")
    q1, k1, v1, do1, m1, b1, o1, l1, l2 = (
        _t(a)[None] for a in (q, k, v, do, adj, bias, out, lse1, lse2))
    scale = None if sc is None else _t(sc)
    got = TFG.flash_biased_backward_plain(q1, k1, v1, m1, b1, o1, l1, l2,
                                          do1, metric, scale, rate, seeds,
                                          need)
    assert (got[4] is None) == (not need)
    on = m1 != 0
    for g, w in zip(got[:3], want[:3]):
        assert _err(g[0], w) <= TOL
    assert _err(got[3][on], np.asarray(want[3])[adj]) <= TOL
    assert torch.all(got[3][~on] == 0)
    if need:
        assert _err(got[4], want[4]) <= TOL
    assert torch.all(got[0][0, :, 5] == 0)             # the dead row's dq
    # the three parts, as B6, B7a and B7b split the work
    d2 = (do1 * o1).sum(-1)
    rows = (l1, l2, d2)
    d1, db = TFG.flash_biased_bwd_pre_plain(q1, k1, v1, m1, b1, do1, *rows,
                                            metric, scale, rate, seeds)
    dq, dsc = TFG.flash_biased_bwd_dq_plain(q1, k1, v1, m1, b1, do1, *rows,
                                            d1, metric, scale, rate, seeds,
                                            need)
    dk, dv = TFG.flash_biased_bwd_dkv_plain(q1, k1, v1, m1, b1, do1, *rows,
                                            d1, metric, scale, rate, seeds)
    assert _err(d1[0], want_d1) <= TOL
    assert torch.all(d1[0, :, 5] == 0)
    for g, w in zip((dq, dk, dv, db), got[:4]):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    if need:
        torch.testing.assert_close(dsc, got[4], rtol=0, atol=0)
    api = TFG.flash_biased_attention_bwd(
        q1, k1, v1, b1, m1, o1, l1, l2, do1, metric=metric, scale=scale,
        seeds=seeds, dropout_rate=rate, need_dscale=need)
    assert len(api) == 4 + need
    for g, w in zip(api, got):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    if rate:
        thresh = TFG._keep_thresh(rate)
        keep1, keep2 = (TFG._keep_rows(seeds[:, i], 3, 0, 40, 40, "cpu")
                        < thresh for i in (0, 1))
        assert bool((on[:, None] & keep2 & ~keep1).any())
        assert bool((on[:, None] & keep1 & ~keep2).any())


@pytest.mark.parametrize("metric", ["gaussian_kernel", "cosine_distance"])
def test_biased_autograd_matches_jax_vjp(metric, biased_inputs, interpret):
    """flash_geometric_attention with bias= under autograd (the cosine
    normalisation pulled back outside the Function) against jax.vjp of
    ``_flash_diff_biased``, with the bias and the scale requiring grad
    and dropout on: dq, dk, dv, dscale and dB at the mask's pairs."""
    q, k, v, do, adj, bias = biased_inputs
    sc = np.asarray([0.7, 1.1, 1.6], np.float32)
    rate = 0.3
    seeds = jnp.asarray([SEED, SEED ^ 0x5BD1E995], jnp.int32)
    jadj = jnp.asarray(adj)
    (jl, jc), (il, ic) = JFG.make_block_plans_from_mask(jadj, BLOCK, BLOCK)
    _, vjp = jax.vjp(
        lambda q, k, v, s, b: JFG._flash_diff_biased(
            q, k, v, s, b, jadj, jl, jc, il, ic, seeds, metric, BLOCK,
            BLOCK, False, rate),
        *(jnp.asarray(a) for a in (q, k, v, sc, bias)))
    want = vjp(jnp.asarray(do))
    leaves = [_t(a)[None].requires_grad_() for a in (q, k, v, bias)]
    scale = _t(sc).requires_grad_()
    out = TFG.flash_geometric_attention(
        *leaves[:3], _t(adj)[None], metric=metric, scale_param=scale,
        dropout_rate=rate, dropout_seed=SEED, bias=leaves[3])
    (out * _t(do)).sum().backward()
    for t, w in zip(leaves[:3], want[:3]):
        assert _err(t.grad[0], w) <= TOL
    assert _err(scale.grad, want[3]) <= TOL
    assert _err(leaves[3].grad[0][_t(adj)], np.asarray(want[4])[adj]) <= TOL
