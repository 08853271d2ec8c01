"""The port's backward (tagan_torch.ops.flash_geometric and autograd through
the layers and the model) against the JAX package's on the CPU: the
plain backward against ``flash_geometric_attention_bwd`` (its Pallas
kernels in interpret mode), the flash layer's parameter gradients
against ``jax.grad`` of ``apply_flash``, and the whole model's loss
gradient against ``jax.grad`` for the dense and flash backends."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tagan_torch as pt
import tagan_tpu as tt
from tagan_tpu.data.synthetic import create_dynamic_synthetic_data
from tagan_tpu.nn.geometric import GeometricAttention as JGeo
from tagan_tpu.nn.model import TAGAN as JTAGAN
from tagan_tpu.nn.model import batched_forward as j_batched_forward
from tagan_tpu.ops.pallas import flash_geometric as JFG
from tagan_torch.convert import params_from_jax
from tagan_torch.nn.geometric import GeometricAttention as TGeo
from tagan_torch.ops import flash_geometric as TFG

# fp32 on both sides, sums in another order; errors are taken over each
# tensor's largest entry (at least 1 for the attention outputs), since
# gradients span many scales
TOL = 1e-4


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


def _check_grads(got, want):
    """Each parameter's gradient against its own largest entry. One that
    is zero in exact arithmetic (below 1e-6 of the largest gradient: a
    bias that adds a constant to every score of a softmax row) is fp32
    noise on both sides and must stay below that level."""
    assert set(got) == set(want)
    noise = 1e-6 * max(w.abs().max().item() for w in want.values())
    for name, param in got.items():
        g, w = param.grad, want[name]
        assert torch.isfinite(g).all(), name
        m = w.abs().max().item()
        if m < noise:
            assert g.abs().max().item() < noise, name
        else:
            assert (g - w).abs().max().item() <= TOL * m, name


@pytest.fixture(scope="module")
def attn_inputs():
    """One snapshot, 2 heads, N=44 (not a multiple of the 16-row JAX
    tile), D != Dv, a dead row, cotangents of out and lse."""
    rng = np.random.default_rng(0)
    H, N, D, Dv = 2, 44, 16, 8
    q, k = (rng.standard_normal((H, N, D)).astype(np.float32)
            for _ in range(2))
    v, do = (rng.standard_normal((H, N, Dv)).astype(np.float32)
             for _ in range(2))
    dlse = rng.standard_normal((H, N)).astype(np.float32)
    adj = rng.random((N, N)) < 0.3
    np.fill_diagonal(adj, True)
    adj[3] = False
    return q, k, v, do, dlse, adj


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("metric", TFG.MXU_METRICS)
def test_plain_backward_matches_jax(metric, rate, fused, attn_inputs,
                                    interpret):
    """Every metric, dropout 0 and 0.1 from the same seed (the keep bits
    are equal), dscale for gaussian/rbf, an lse cotangent, a dead row."""
    q, k, v, do, dlse, adj = attn_inputs
    if metric in TFG._COSINE:
        q = q / np.linalg.norm(q, axis=-1, keepdims=True)
        k = k / np.linalg.norm(k, axis=-1, keepdims=True)
    scaled = metric in TFG.SCALED_METRICS
    sc = np.asarray([0.7, 1.6], np.float32) if scaled else None
    seed = -987
    jkw = dict(metric=metric, block_m=16, block_n=16,
               scale_param=None if sc is None else jnp.asarray(sc),
               seed=jnp.asarray([seed], jnp.int32), dropout_rate=rate)
    jq, jk, jv, jadj = (jnp.asarray(a) for a in (q, k, v, adj))
    out, lse = JFG._flash_forward(jq, jk, jv, jadj, return_lse=True, **jkw)
    want = JFG.flash_geometric_attention_bwd(
        jq, jk, jv, jadj, out, lse, jnp.asarray(do), metric=metric,
        scale=None if sc is None else jnp.asarray(sc), block_m=16,
        block_n=16, seed=jnp.asarray([seed], jnp.int32), dropout_rate=rate,
        need_dscale=scaled, fused=fused, dlse=jnp.asarray(dlse))
    got = TFG.flash_geometric_backward_plain(
        *(_t(a)[None] for a in (q, k, v, adj, out, lse, do)), metric,
        None if sc is None else _t(sc), rate,
        torch.tensor([seed], dtype=torch.int32), scaled, _t(dlse)[None])
    assert (got[3] is None) == (not scaled)
    for g, w in zip(got[:3], want[:3]):
        assert _err(g[0], w) <= TOL
    if scaled:
        assert _err(got[3], want[3]) <= TOL
    # the picker's public entry on CPU tensors is the plain version
    api = TFG.flash_geometric_attention_bwd(
        *(_t(a)[None] for a in (q, k, v, adj, out, lse, do)), metric=metric,
        scale=None if sc is None else _t(sc),
        seed=torch.tensor([seed], dtype=torch.int32), dropout_rate=rate,
        need_dscale=scaled, fused=fused, dlse=_t(dlse)[None])
    for g, w in zip(api, got):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_autograd_function_matches_plain_backward(attn_inputs):
    """flash_geometric_attention under autograd returns the plain
    backward's gradients, dscale included, and none for a scale that
    does not require one."""
    q, k, v, do, _, adj = attn_inputs
    leaves = [_t(a)[None].requires_grad_() for a in (q, k, v)]
    sigma = torch.tensor([0.8, 1.5], requires_grad=True)
    seed = torch.tensor([5], dtype=torch.int32)
    out = TFG.flash_geometric_attention(
        *leaves, _t(adj)[None], metric="gaussian_kernel", scale_param=sigma,
        dropout_rate=0.1, dropout_seed=seed)
    (out * _t(do)).sum().backward()
    fwd_out, lse = TFG.flash_geometric_forward_plain(
        *(t.detach() for t in leaves), _t(adj)[None], "gaussian_kernel",
        sigma.detach(), 0.1, seed)
    want = TFG.flash_geometric_backward_plain(
        *(t.detach() for t in leaves), _t(adj)[None], fwd_out, lse,
        _t(do)[None], "gaussian_kernel", sigma.detach(), 0.1, seed, True)
    for t, w in zip(leaves + [sigma], want):
        torch.testing.assert_close(t.grad, w, rtol=0, atol=0)
    fixed = torch.tensor([0.8, 1.5])
    q2 = _t(q)[None].requires_grad_()
    TFG.flash_geometric_attention(q2, *leaves[1:], _t(adj)[None],
                                  metric="gaussian_kernel",
                                  scale_param=fixed).sum().backward()
    assert fixed.grad is None and torch.isfinite(q2.grad).all()


@pytest.mark.parametrize("metric,learnable", [
    ("cosine_similarity", False), ("gaussian_kernel", True),
    ("mahalanobis", True)])
def test_flash_layer_gradients_match_jax(metric, learnable, interpret):
    """Gradients of every parameter and of the input through the flash
    path: the cosine normalisation and the mahalanobis factors pulled
    back outside the attention Function, as JAX pulls them back outside
    its custom_vjp."""
    hid, heads, n = 16, 2, 30
    jl = JGeo(hidden_dim=hid, num_heads=heads, dropout=0.0,
              distance_metric=metric, learnable_distance=learnable)
    p = jl.init(jax.random.key(3))
    tl = TGeo(hid, heads, metric, True, learnable, dropout=0.0)
    tl.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                              p)))
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, n, hid)).astype(np.float32)
    w = rng.standard_normal((2, n, hid)).astype(np.float32)
    adj = rng.random((2, n, n)) < 0.25
    adj[:, np.arange(n), np.arange(n)] = True
    adj[0, 4] = False

    def jloss(p, x):
        return jnp.sum(jl.apply_flash(p, x, jnp.asarray(adj), block_m=16,
                                      block_n=16) * w)
    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(p, jnp.asarray(x))
    tx = _t(x).requires_grad_()
    (tl.apply_flash(tx, _t(adj)) * _t(w)).sum().backward()
    _check_grads(dict(tl.named_parameters()),
                 params_from_jax(jax.tree_util.tree_map(np.asarray, jgp)))
    assert _err(tx.grad, jgx) <= TOL


@pytest.fixture(scope="module")
def churn_batch():
    """Three churn sequences (nodes drop out, so LayerNorms see all-zero
    rows), one shorter than the others (a padded final snapshot)."""
    data = create_dynamic_synthetic_data(
        num_samples=3, sequence_length=4, num_nodes_range=(10, 20),
        node_feature_dim=8, seed=1)
    seqs = [s for s, _ in data]
    seqs[1] = seqs[1][:3]
    return seqs, tt.pad_dims_for(seqs)


@pytest.mark.parametrize("backend", ["dense", "flash"])
def test_model_loss_gradient_matches_jax(backend, churn_batch, interpret):
    """d(batch loss)/d(every parameter) of the whole model against
    jax.grad, with finite gradients on churn data."""
    seqs, (T, N, E, _) = churn_batch
    cfg = dict(hidden_dim=16, num_heads=2, num_layers=2, node_feature_dim=8,
               output_dim=1, loss_type="bce", dropout=0.0,
               flash_block_m=16, flash_block_n=16, spatial_backend=backend)
    jm = JTAGAN(tt.TAGANConfig(**cfg))
    jp = jm.init(jax.random.key(0))
    tm = pt.TAGAN(pt.TAGANConfig(**cfg), device="cpu")
    tm.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                              jp)))
    dense = backend == "dense"
    jb = tt.batch_sequences([tt.build_sequence(
        s, max_nodes=N, max_edges=E, max_time=T, dense_adj=dense)
        for s in seqs])
    tb = pt.batch_sequences([pt.build_sequence(
        s, max_nodes=N, max_edges=E, max_time=T, dense_adj=dense)
        for s in seqs])
    labels = np.asarray([1.0, 0.0, 1.0], np.float32)
    jloss, jg = jax.jit(jax.value_and_grad(
        lambda p: j_batched_forward(jm, p, jb, jnp.asarray(labels)).loss))(jp)
    loss = tm(tb, _t(labels)).loss
    loss.backward()
    assert abs(loss.item() - float(jloss)) <= TOL
    _check_grads(dict(tm.named_parameters()),
                 params_from_jax(jax.tree_util.tree_map(np.asarray, jg)))
