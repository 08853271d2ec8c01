"""The model's attention weights (``return_attention_weights``,
``infer_with_attention``) against the JAX package's on the CPU: the
first geometric layer's and the temporal attention's weights on the
dense backend, with and without edge features, the dense fallback of the
flash, csr and hybrid backends on sequences that carry their dense
adjacency, and JAX's ValueError on sequences packed without it."""

import jax
import numpy as np
import pytest
import torch

import tagan_torch as pt
import tagan_tpu as tt
from tagan_tpu.data.synthetic import create_dynamic_synthetic_data
from tagan_tpu.nn.model import TAGAN as JTAGAN
from tagan_torch.core.graph import attach_hybrid_plans

# torch's CPU operations on one thread: the tier-1 command runs six
# pytest workers on 8 cores, and torch's default of a thread per core
# oversubscribes them
torch.set_num_threads(1)

# fp32 on both sides, sums in another order
TOL = 1e-4


def _cfg(**kw):
    base = dict(hidden_dim=16, num_heads=2, num_layers=2, node_feature_dim=6,
                output_dim=1, loss_type="bce", dropout=0.0,
                head_num_layers=1)
    base.update(kw)
    return base


def _models(**kw):
    jm = JTAGAN(tt.TAGANConfig(**_cfg(**kw)))
    jp = jm.init(jax.random.key(0))
    tm = pt.TAGAN(pt.TAGANConfig(**_cfg(**kw)), device="cpu")
    tm.load_state_dict(pt.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jp)))
    return jm, jp, tm


@pytest.fixture(scope="module")
def data():
    """Three churn sequences with edge features, one of them shorter (a
    padded snapshot), and their dims."""
    d = create_dynamic_synthetic_data(
        num_samples=3, sequence_length=4, num_nodes_range=(8, 12),
        node_feature_dim=6, edge_feature_dim=3, seed=3)
    seqs = [s for s, _ in d]
    seqs[2] = seqs[2][:3]
    return seqs, tt.pad_dims_for(seqs)


def _batches(seqs, dims, dense_adj=True):
    T, N, E, Fe = dims
    kw = dict(max_nodes=N, max_edges=E, max_time=T, edge_feature_dim=Fe,
              dense_adj=dense_adj)
    return (tt.batch_sequences([tt.build_sequence(s, **kw) for s in seqs]),
            pt.batch_sequences([pt.build_sequence(s, **kw) for s in seqs]))


def _jax_weights(jm, jp, jb):
    out = jax.jit(jax.vmap(lambda s: jm(jp, s, return_attention_weights=True)
                           ))(jb)
    return out.logits, out.temporal_attention_weights, \
        out.geometric_attention_weights


def _check(out, want):
    logits, temporal, geometric = want
    for got, w in ((out.logits, logits),
                   (out.temporal_attention_weights, temporal),
                   (out.geometric_attention_weights, geometric)):
        assert got.shape == w.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=TOL,
                                   atol=TOL)


@pytest.fixture(scope="module")
def dense_want(data):
    """JAX's logits and weights of the dense model over the batch, and
    of the edge-feature model."""
    seqs, dims = data
    jb, _ = _batches(seqs, dims)
    out = {}
    for edge in (False, True):
        jm, jp, _ = _models(edge_feature_dim=dims[3], use_edge_features=edge)
        out[edge] = _jax_weights(jm, jp, jb)
    return out


@pytest.mark.parametrize("edge", [False, True])
def test_dense_weights_match_jax(edge, data, dense_want):
    """[B, N, H, T, T] temporal and [B, T, H, N, N] first-layer weights;
    a single sequence gives one sequence's weights."""
    seqs, dims = data
    _, tb = _batches(seqs, dims)
    _, _, tm = _models(edge_feature_dim=dims[3], use_edge_features=edge)
    with torch.no_grad():
        out = tm(tb, return_attention_weights=True)
        one = tm(tb.map(lambda t: t[1]), return_attention_weights=True)
        plain = tm(tb)
    _check(out, dense_want[edge])
    B, T, N = tb.x.shape[:3]
    assert out.temporal_attention_weights.shape == (B, N, 2, T, T)
    assert out.geometric_attention_weights.shape == (B, T, 2, N, N)
    assert plain.temporal_attention_weights is None \
        and plain.geometric_attention_weights is None
    np.testing.assert_allclose(plain.logits.numpy(), out.logits.numpy(),
                               rtol=1e-6, atol=1e-6)
    for got, want in ((one.temporal_attention_weights,
                       out.temporal_attention_weights[1]),
                      (one.geometric_attention_weights,
                       out.geometric_attention_weights[1])):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("edge", [False, True])
@pytest.mark.parametrize("backend", ["flash", "csr", "hybrid"])
def test_other_backends_fall_back_to_dense(backend, edge, data, dense_want):
    """On a sequence packed with its dense adjacency, the flash, csr and
    hybrid models return the dense path's weights and logits (JAX's
    rule), and their logits without weights agree."""
    seqs, dims = data
    _, tb = _batches(seqs, dims)
    _, _, tm = _models(spatial_backend=backend, edge_feature_dim=dims[3],
                       use_edge_features=edge)
    with torch.no_grad():
        out = tm(tb, return_attention_weights=True)
        if backend == "hybrid":
            tb = pt.batch_sequences(attach_hybrid_plans(
                [tb.map(lambda t, i=i: t[i]) for i in range(len(seqs))])[0])
        plain = tm(tb)
    _check(out, dense_want[edge])
    np.testing.assert_allclose(plain.logits.numpy(), out.logits.numpy(),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("backend", ["flash", "csr", "hybrid", "dense"])
def test_weights_without_dense_adj_raise(backend, data):
    """A sequence packed with ``dense_adj=False``: JAX's ValueError on
    both sides (the dense backend's own, which needs the adjacency
    anyway)."""
    seqs, dims = data
    jb, tb = _batches(seqs[:1], dims, dense_adj=False)
    jm, jp, tm = _models(spatial_backend=backend)
    with pytest.raises(ValueError) as want:
        jm(jp, jax.tree_util.tree_map(lambda a: a[0], jb),
           return_attention_weights=True)
    with pytest.raises(ValueError) as got:
        tm(tb, return_attention_weights=True)
    if backend != "dense":
        assert "return_attention_weights=True is not supported" \
            in str(want.value)
        assert str(got.value).split(":")[0] == str(want.value).split(":")[0]
    with pytest.raises(ValueError):
        tm.infer_with_attention(tb)


def test_infer_with_attention_matches_jax(data):
    """``infer_with_attention`` of one sequence on the flash model (the
    dense fallback on both sides) against JAX's."""
    seqs, dims = data
    jb, tb = _batches(seqs[:1], dims)
    jm, jp, tm = _models(spatial_backend="flash")
    js = jax.tree_util.tree_map(lambda a: a[0], jb)
    want = jax.jit(lambda p, s: jm.infer_with_attention(p, s))(jp, js)
    got = tm.infer_with_attention(tb.map(lambda t: t[0]))
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=TOL, atol=TOL, err_msg=k)
