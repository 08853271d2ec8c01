"""The port's model, packing and serving (tagan_torch) against the JAX
package's, end to end on the CPU with converted parameters; the flash
backend's Pallas forward runs in interpret mode."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tagan_torch as pt
import tagan_tpu as tt
from tagan_tpu.data.synthetic import (create_dynamic_synthetic_data,
                                      create_synthetic_data)
from tagan_tpu.nn.model import TAGAN as JTAGAN
from tagan_tpu.nn.model import batched_forward as j_batched_forward
from tagan_tpu.ops.pallas import flash_geometric as JFG
from tagan_tpu.serve import Predictor as JPredictor

# torch's CPU operations on one thread: the tier-1 command runs six
# pytest workers on 8 cores, and torch's default of a thread per core
# oversubscribes them
torch.set_num_threads(1)

TOL = 1e-4


@pytest.fixture(scope="module")
def interpret():
    import jax.experimental.pallas as pl
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JFG.pl, "pallas_call",
                   functools.partial(pl.pallas_call, interpret=True))
        yield


def _config(**kw):
    base = dict(hidden_dim=16, num_heads=2, num_layers=2, node_feature_dim=8,
                output_dim=1, loss_type="bce", dropout=0.0,
                flash_block_m=16, flash_block_n=16)
    base.update(kw)
    return base


def _models(**kw):
    cfg = _config(**kw)
    jm = JTAGAN(tt.TAGANConfig(**cfg))
    jp = jm.init(jax.random.key(0))
    tm = pt.TAGAN(pt.TAGANConfig(**cfg), device="cpu")
    tm.load_state_dict(pt.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jp)))
    return jm, jp, tm


@pytest.fixture(scope="module")
def churn_batch():
    """Three churn sequences, one shorter (a padded final snapshot)."""
    data = create_dynamic_synthetic_data(
        num_samples=3, sequence_length=4, num_nodes_range=(10, 20),
        node_feature_dim=8, seed=1)
    seqs = [s for s, _ in data]
    seqs[1] = seqs[1][:3]
    return seqs, tt.pad_dims_for(seqs)


@pytest.mark.parametrize("pooling", ["mean", "max", "attention", "logit"])
@pytest.mark.parametrize("backend", ["dense", "csr", "flash"])
def test_tagan_matches_jax(backend, pooling, churn_batch, interpret):
    seqs, (T, N, E, _) = churn_batch
    jm, jp, tm = _models(spatial_backend=backend, node_pooling=pooling)
    dense = backend == "dense"
    jb = tt.batch_sequences([tt.build_sequence(
        s, max_nodes=N, max_edges=E, max_time=T, dense_adj=dense)
        for s in seqs])
    tb = pt.batch_sequences([pt.build_sequence(
        s, max_nodes=N, max_edges=E, max_time=T, dense_adj=dense)
        for s in seqs])
    labels = np.asarray([1.0, 0.0, 1.0], np.float32)
    jo = jax.jit(lambda p, b, y: j_batched_forward(jm, p, b, y))(
        jp, jb, jnp.asarray(labels))
    with torch.no_grad():
        to = pt.batched_forward(tm, tb, torch.from_numpy(labels))
    for got, want in ((to.logits, jo.logits), (to.predictions,
                                               jo.predictions),
                      (to.loss, jo.loss), (to.memory.states,
                                           jo.memory.states)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=TOL, atol=TOL)
    for f in ("valid", "last_seen", "inactivity", "frequency"):
        np.testing.assert_array_equal(getattr(to.memory, f).numpy(),
                                      np.asarray(getattr(jo.memory, f)))


def test_single_sequence_and_memory_carry(churn_batch):
    """An unbatched sequence runs as a batch of one, and a memory passed
    back in matches the JAX model's carry."""
    seqs, (T, N, E, _) = churn_batch
    jm, jp, tm = _models(spatial_backend="dense", output_dim=3,
                         loss_type="ce")
    js = tt.build_sequence(seqs[0], max_nodes=N, max_edges=E, max_time=T)
    ts = pt.build_sequence(seqs[0], max_nodes=N, max_edges=E, max_time=T)
    fwd = jax.jit(lambda p, s, y, m: jm(p, s, y, m))
    j1 = fwd(jp, js, jnp.asarray(2), None)
    j2 = jax.jit(lambda p, s, m: jm(p, s, None, m))(jp, js, j1.memory)
    with torch.no_grad():
        t1 = tm(ts, torch.tensor(2))
        t2 = tm(ts, None, t1.memory)
        tb = tm(pt.batch_sequences([ts, ts]))
    assert t1.logits.shape == (3,) and t1.memory.states.shape == (N, 16)
    for got, want in ((t1.logits, j1.logits), (t1.loss, j1.loss),
                      (t2.logits, j2.logits),
                      (t2.memory.states, j2.memory.states)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tb.logits[1].numpy(), t1.logits.numpy(),
                               rtol=1e-6, atol=1e-6)
    hard = tm.infer(ts)["labels"]
    assert int(hard) == int(np.argmax(np.asarray(j1.predictions)))


@pytest.mark.parametrize("dense_adj", [True, False])
def test_build_sequence_matches_jax(dense_adj):
    data = create_dynamic_synthetic_data(
        num_samples=2, sequence_length=5, num_nodes_range=(8, 14),
        node_feature_dim=6, edge_feature_dim=3, seed=2)
    dims = tt.pad_dims_for([s for s, _ in data])
    assert pt.pad_dims_for([s for s, _ in data]) == dims
    T, N, E, Fe = dims
    for seq, _ in data:
        for kw in ({}, dict(max_nodes=N + 3, max_edges=E + 2,
                            max_time=T + 1, edge_feature_dim=Fe)):
            want = tt.build_sequence(seq, dense_adj=dense_adj, **kw)
            got = pt.build_sequence(seq, dense_adj=dense_adj, **kw)
            for f in ("x", "node_mask", "adj", "edge_src", "edge_dst",
                      "edge_mask", "edge_attr", "times", "time_mask",
                      "node_ids"):
                w = np.asarray(getattr(want, f))
                g = getattr(got, f).numpy()
                assert g.dtype == w.dtype, f
                np.testing.assert_array_equal(g, w, err_msg=f)
    snap = {"x": np.zeros((1, 6), np.float32),
            "edge_index": np.zeros((2, 0), np.int64), "node_ids": [2 ** 31]}
    with pytest.raises(ValueError, match="int32"):
        pt.build_sequence([snap])


@pytest.mark.parametrize("backend", ["flash", "dense", "csr"])
def test_predictor_matches_jax(backend, interpret):
    data = create_synthetic_data(
        num_samples=5, num_nodes_range=(6, 12), node_feature_dim=8,
        edge_feature_dim=0, sequence_length=3, seed=3)
    seqs = [s for s, _ in data]
    seqs[2] = seqs[2][:2]
    jm, jp, tm = _models(spatial_backend=backend)
    dims = tt.pad_dims_for(seqs)
    want = JPredictor(jm, jp, dims=dims, batch_size=4).predict_proba(seqs)
    pred = pt.Predictor(tm, dims=dims, batch_size=2)
    got = pred.predict_proba(seqs)
    assert got.shape == (5, 1)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    auto = pt.Predictor(tm, batch_size=3)
    np.testing.assert_allclose(auto(seqs), want, rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(pred.predict(seqs, threshold=0.5),
                                  (want[:, 0] > 0.5).astype(np.int32))
    T, N, E, Fe = dims
    built = pt.batch_sequences([pt.build_sequence(
        s, max_nodes=N, max_edges=E, max_time=T,
        dense_adj=backend == "dense") for s in seqs])
    np.testing.assert_allclose(pred.predict_proba(built), want, rtol=TOL,
                               atol=TOL)
    pred.warmup(2)


@pytest.mark.parametrize("override", [
    {"spatial_backend": "hybrid"}, {"spatial_backend": "ring"},
    {"compat_mode": "executed"}, {"temporal_attention_type": "standard"},
    {"temporal_attention_type": "multi_scale"},
    {"bf16_matmul": True, "use_edge_features": True, "edge_feature_dim": 3,
     "spatial_backend": "hybrid"}])
def test_outside_the_slice_raises(override):
    """What the port does not run raises NotImplementedError at
    construction. The hybrid backend runs and trains, with and without
    edge features, in fp32 and with bf16_matmul: a backward on a plan
    without the transposed walk raises ValueError for both models, and
    with it the edge-feature model's gradients are finite."""
    if override.get("spatial_backend") == "hybrid":
        rng = np.random.default_rng(0)
        snaps = [{"x": rng.standard_normal((12, 8)).astype(np.float32),
                  "edge_index": rng.integers(0, 12, (2, 30)),
                  "edge_attr": rng.standard_normal((30, 3)).astype(
                      np.float32),
                  "node_ids": np.arange(12), "timestep": float(t)}
                 for t in range(2)]
        seq = pt.build_sequence(snaps, dense_adj=False)
        model = pt.TAGAN(pt.TAGANConfig(**_config(**override)), device="cpu")
        loss = model(seq.with_hybrid_plan(), torch.tensor(1.0)).loss
        with pytest.raises(ValueError, match="transposed walk"):
            loss.backward()
        edge = pt.TAGAN(pt.TAGANConfig(**_config(**{
            "edge_feature_dim": 3, "use_edge_features": True, **override})),
            device="cpu")
        loss = edge(seq.with_hybrid_plan(), torch.tensor(1.0)).loss
        with pytest.raises(ValueError, match="transposed walk"):
            loss.backward()
        edge.zero_grad()
        edge(seq.with_hybrid_plan(transposed=True),
             torch.tensor(1.0)).loss.backward()
        assert all(torch.isfinite(p.grad).all()
                   for p in edge.parameters() if p.grad is not None)
        assert edge.edge_embedding.w.grad.abs().max() > 0
        return
    with pytest.raises(NotImplementedError):
        pt.TAGAN(pt.TAGANConfig(**_config(**override)), device="cpu")


def test_bf16_hybrid_raises():
    """bf16_matmul on the hybrid backend no longer raises: with and
    without edge features the hybrid bf16 model builds, runs and trains
    on the CPU, every gradient finite and the edge parameters' non-zero
    (its values are held against JAX's in `test_torch_hybrid_bf16.py`
    and `test_torch_hybrid_edge_bf16.py`)."""
    rng = np.random.default_rng(0)
    snaps = [{"x": rng.standard_normal((12, 8)).astype(np.float32),
              "edge_index": rng.integers(0, 12, (2, 30)),
              "edge_attr": rng.standard_normal((30, 3)).astype(np.float32),
              "node_ids": np.arange(12), "timestep": float(t)}
             for t in range(2)]
    seq = pt.build_sequence(snaps, dense_adj=False).with_hybrid_plan(
        transposed=True)
    for edge in ({}, {"use_edge_features": True, "edge_feature_dim": 3}):
        model = pt.TAGAN(pt.TAGANConfig(**_config(
            spatial_backend="hybrid", bf16_matmul=True, **edge)),
            device="cpu")
        loss = model(seq, torch.tensor(1.0)).loss
        loss.backward()
        assert torch.isfinite(loss)
        assert all(torch.isfinite(p.grad).all() for p in model.parameters())
        if edge:
            assert model.edge_embedding.w.grad.abs().max() > 0
            assert all(p.grad.abs().max() > 0
                       for n, p in model.named_parameters()
                       if "edge_bias" in n)


def test_edge_dim_without_edge_features_matches_jax(churn_batch):
    """edge_feature_dim > 0 without use_edge_features only adds the
    (unused) edge embedding, as in the JAX package."""
    seqs, (T, N, E, _) = churn_batch
    jm, jp, tm = _models(edge_feature_dim=3)
    js = tt.build_sequence(seqs[0], max_nodes=N, max_edges=E, max_time=T,
                           edge_feature_dim=3)
    ts = pt.build_sequence(seqs[0], max_nodes=N, max_edges=E, max_time=T,
                           edge_feature_dim=3)
    with torch.no_grad():
        got = tm(ts).logits.numpy()
    want = jax.jit(lambda p, s: jm(p, s).logits)(jp, js)
    np.testing.assert_allclose(got, np.asarray(want),
                               rtol=TOL, atol=TOL)
    from tagan_torch import serve
    for unported in (pt.Predictor.from_checkpoint, serve.StreamingSession,
                     serve.export_artifact, serve.load_artifact):
        with pytest.raises(NotImplementedError):
            unported("unused")
