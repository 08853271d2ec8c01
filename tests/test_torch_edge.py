"""The port's edge-feature path (tagan_torch) against the JAX package's
on the CPU: the plain versions of the edge-biased forward kernels (B4,
B5) against the Pallas kernels in interpret mode, the csr ops against
``tagan_tpu.ops.sparse``, and the model with edge features on the
dense, csr and flash backends (logits, memory, gradients, Predictor)
against the JAX model, with converted parameters and numpy inputs."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tagan_torch as pt
import tagan_tpu as tt
from tagan_tpu.nn.model import TAGAN as JTAGAN
from tagan_tpu.nn.model import batched_forward as j_batched_forward
from tagan_tpu.ops import distances as JD
from tagan_tpu.ops import sparse as JS
from tagan_tpu.ops.pallas import flash_geometric as JFG
from tagan_tpu.serve import Predictor as JPredictor
from tagan_torch.nn.model import edge_bias_matrix
from tagan_torch.ops import flash_geometric as TFG
from tagan_torch.ops import sparse as TS

# torch's CPU operations on one thread: the tier-1 command runs six
# pytest workers on 8 cores, and torch's default of a thread per core
# oversubscribes them
torch.set_num_threads(1)

# fp32 on both sides, sums in another order
TOL = 1e-4
# the flash path's norm expansion of squared distances against the dense
# path's subtract-then-square (tests/test_flash_kernel.py uses 2e-4 too)
TOL_FLASH_DENSE = 2e-4
# the csr ops against XLA's: the same per-edge arithmetic
TOL_OPS = 1e-5


@pytest.fixture(scope="module")
def interpret():
    import jax.experimental.pallas as pl
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JFG.pl, "pallas_call",
                   functools.partial(pl.pallas_call, interpret=True))
        yield


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# B4, B5: the plain versions against the Pallas kernels
# ---------------------------------------------------------------------------

def _bias_data(seed=21, H=2, N=70, D=16, Dv=8):
    """The JAX tests' sizes (tests/test_flash_kernel.py `_bias_data`):
    q, k, v, a mask with the diagonal, two dead rows (one the last) and
    a bias on the mask's pairs."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((H, N, D)).astype(np.float32)
    k = rng.standard_normal((H, N, D)).astype(np.float32)
    v = rng.standard_normal((H, N, Dv)).astype(np.float32)
    adj = rng.random((N, N)) < 0.3
    np.fill_diagonal(adj, True)
    adj[3] = False
    adj[N - 1] = False
    bias = np.where(adj, rng.standard_normal((N, N)), 0.0).astype(np.float32)
    return q, k, v, adj, bias


@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("metric", JFG.MXU_METRICS)
def test_biased_plain_matches_pallas(metric, rate, interpret):
    """lse1 (B4), out and lse2 (B5) against ``_flash_biased_forward`` at
    block 32: D != Dv, per-head sigma/gamma, both dropouts from the same
    seed pair (the keep bits are equal), dead rows exactly; and the
    differentiable entry with ``bias=`` (which derives the second seed)
    gives the same out."""
    q, k, v, adj, bias = _bias_data()
    if metric in TFG._COSINE:
        q = q / np.linalg.norm(q, axis=-1, keepdims=True)
        k = k / np.linalg.norm(k, axis=-1, keepdims=True)
    sc = np.asarray([0.7, 1.6], np.float32) \
        if metric in TFG.SCALED_METRICS else None
    seed = -987654
    w_out, w_lse1, w_lse2 = JFG._flash_biased_forward(
        *(jnp.asarray(a) for a in (q, k, v, adj, bias)), metric=metric,
        scale_param=None if sc is None else jnp.asarray(sc), block_m=32,
        block_n=32, seeds=jnp.asarray([seed, seed ^ 0x5BD1E995], jnp.int32),
        dropout_rate=rate, return_lse=True)
    seeds = TFG.biased_seeds(seed, 1, "cpu")
    assert seeds.tolist() == [[seed, seed ^ 0x5BD1E995]]
    folded = [_t(a)[None] for a in (q, k, v, adj, bias)]
    plan = TFG.make_block_plan(folded[3])
    out, lse1, lse2 = TFG.flash_biased_fwd(
        *folded, *plan, metric=metric,
        scale=None if sc is None else _t(sc), dropout_rate=rate,
        seeds=seeds)
    for got, want in ((out, w_out), (lse1, w_lse1), (lse2, w_lse2)):
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want),
                                   rtol=TOL, atol=TOL)
    for row in (3, q.shape[1] - 1):
        assert np.all(out[0, :, row].numpy() == 0)
        assert np.all(lse1[0, :, row].numpy() == TFG.LSE_DEAD)
        assert np.all(lse2[0, :, row].numpy() == TFG.LSE_DEAD)
    api = TFG.flash_geometric_attention(
        *folded[:4], metric=metric,
        scale_param=None if sc is None else _t(sc), dropout_rate=rate,
        dropout_seed=seed, bias=folded[4])
    np.testing.assert_allclose(api[0].numpy(), np.asarray(w_out), rtol=TOL,
                               atol=TOL)


def test_biased_folds_leading_dims_and_cpu_takes_plain():
    """Leading dims fold into one call, each slice with its own seed
    pair; on CPU tensors no kernel is launched, and a kernel wrapper
    refuses a CPU tensor."""
    slices = [_bias_data(seed=s, N=40) for s in range(4)]
    q, k, v, adj, bias = (np.stack([s[i] for s in slices]).reshape(
        (2, 2) + slices[0][i].shape) for i in range(5))
    seeds = np.asarray([[3, -4], [5, 2 ** 31 - 1]], np.int32)
    before = {kern.name: kern.launches for kern in TFG.KERNELS}
    out = TFG.flash_geometric_attention(
        _t(q), _t(k), _t(v), _t(adj), metric="euclidean", dropout_rate=0.2,
        dropout_seed=_t(seeds), bias=_t(bias))
    for a in range(2):
        for b in range(2):
            one = TFG.flash_geometric_attention(
                _t(q[a, b]), _t(k[a, b]), _t(v[a, b]), _t(adj[a, b]),
                metric="euclidean", dropout_rate=0.2,
                dropout_seed=int(seeds[a, b]), bias=_t(bias[a, b]))
            np.testing.assert_array_equal(out[a, b].numpy(), one.numpy())
    assert before == {kern.name: kern.launches for kern in TFG.KERNELS}
    one = [_t(a[0, 0])[None] for a in (q, k, v, adj, bias)]
    plan = TFG.make_block_plan(one[3])
    with pytest.raises(ValueError, match="CUDA"):
        TFG.flash_lse1_kernel(one[0], one[1], one[3], *plan, "dot_product",
                              torch.ones(2))
    with pytest.raises(ValueError, match="plan"):
        TFG.flash_biased_fwd(*one, plan[0], plan[1][..., 1:],
                             metric="dot_product")
    with pytest.raises(ValueError, match="return_lse"):
        TFG.flash_geometric_attention(*one[:4], bias=one[4], return_lse=True)


def test_biased_backward_matches_plain():
    """The edge-biased flash attention under autograd (on CPU tensors)
    gives the plain biased backward's dq, dk, dv and dB, with dropout and
    folded leading dims; a bias that requires no grad gets none."""
    slices = [_bias_data(seed=s, N=20) for s in range(2)]
    q, k, v, adj, bias = (_t(np.stack([s[i] for s in slices]))
                          for i in range(5))
    do = _t(np.random.default_rng(3).standard_normal(
        v.shape).astype(np.float32))
    leaves = [t.clone().requires_grad_() for t in (q, k, v, bias)]
    seed = torch.tensor([11, -12], dtype=torch.int32)
    out = TFG.flash_geometric_attention(*leaves[:3], adj, metric="euclidean",
                                        dropout_rate=0.2, dropout_seed=seed,
                                        bias=leaves[3])
    (out * do).sum().backward()
    seeds = TFG.biased_seeds(seed, 2, "cpu")
    fwd = TFG.flash_biased_fwd(q, k, v, adj, bias, *TFG.make_block_plan(adj),
                               metric="euclidean", dropout_rate=0.2,
                               seeds=seeds)
    want = TFG.flash_biased_backward_plain(
        q, k, v, adj, bias, fwd[0], fwd[1], fwd[2], do, "euclidean", None,
        0.2, seeds)
    for t, w in zip(leaves, want):
        torch.testing.assert_close(t.grad, w, rtol=0, atol=0)
    assert bool((leaves[3].grad != 0).any())
    q2 = q.clone().requires_grad_()
    TFG.flash_geometric_attention(q2, k, v, adj, metric="euclidean",
                                  bias=bias).sum().backward()
    assert bias.grad is None and torch.isfinite(q2.grad).all()


# ---------------------------------------------------------------------------
# csr ops against tagan_tpu.ops.sparse
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def edge_graph():
    """Two snapshots of 30 nodes: q, k [2, H, N, D], v [2, H, N, Dv], 80
    edges each (a query with no edge, masked edges, a duplicate), the
    per-head scales and the mahalanobis factors."""
    rng = np.random.default_rng(5)
    G, H, N, D, Dv, E = 2, 3, 30, 6, 5, 80
    q = rng.standard_normal((G, H, N, D)).astype(np.float32)
    k = rng.standard_normal((G, H, N, D)).astype(np.float32)
    v = rng.standard_normal((G, H, N, Dv)).astype(np.float32)
    q[0, 0, 2] = 0.0                               # zero-norm guard
    eq = rng.integers(0, N - 1, (G, E)).astype(np.int32)   # node N-1: none
    ek = rng.integers(0, N, (G, E)).astype(np.int32)
    eq[:, 1], ek[:, 1] = eq[:, 0], ek[:, 0]                # a duplicate
    em = rng.random((G, E)) < 0.85
    nm = rng.random((G, N)) < 0.9
    bias = rng.standard_normal((G, E)).astype(np.float32)
    hbias = rng.standard_normal((G, H, E)).astype(np.float32)
    scale = np.asarray([0.5, 1.0, 1.7], np.float32)
    f = rng.standard_normal((H, 4, D)).astype(np.float32)
    return dict(q=q, k=k, v=v, eq=eq, ek=ek, em=em, nm=nm, bias=bias,
                hbias=hbias, scale=scale, cov=np.einsum("hrd,hre->hde", f, f))


@pytest.mark.parametrize("metric", JD.ALL_METRICS)
def test_sparse_ops_match_jax(metric, edge_graph):
    """sddmm (edgewise_scores), segment_softmax, spmm, edge_attention
    with an [E] and an [H, E] bias, and add_self_loops, with a leading
    snapshot dim on the port's side, each snapshot against the JAX
    function."""
    d = edge_graph
    N = d["q"].shape[2]
    kw = dict(sigma=d["scale"] if metric == "gaussian_kernel" else None,
              gamma=d["scale"] if metric == "rbf_kernel" else None,
              cov_inv=d["cov"] if metric == "mahalanobis" else None)
    tkw = {a: None if b is None else _t(b) for a, b in kw.items()}
    jkw = {a: None if b is None else jnp.asarray(b) for a, b in kw.items()}
    q, k, v, eq, ek, em = (_t(d[n]) for n in ("q", "k", "v", "eq", "ek",
                                              "em"))
    scores = TS.sddmm(metric, q, k, eq, ek, **tkw)
    w = TS.segment_softmax(scores, eq, em, N)
    agg = TS.spmm(w, v, eq, ek, N)
    att = TS.edge_attention(metric, q, k, v, eq, ek, em, N, **tkw,
                            edge_bias=_t(d["bias"]))
    att_h = TS.edge_attention(metric, q, k, v, eq, ek, em, N, **tkw,
                              edge_bias=_t(d["hbias"]))
    loops = TS.add_self_loops(eq, ek, em, _t(d["nm"]))
    for g in range(2):
        jq, jk, jv = (jnp.asarray(d[n][g]) for n in ("q", "k", "v"))
        jeq, jek, jem = (jnp.asarray(d[n][g]) for n in ("eq", "ek", "em"))
        js = JS.sddmm(metric, jq, jk, jeq, jek, **jkw)
        jw = JS.segment_softmax(js, jeq, jem, N)
        pairs = [
            (scores[g], js), (w[g], jw),
            (agg[g], JS.spmm(jw, jv, jeq, jek, N)),
            (att[g], JS.edge_attention(metric, jq, jk, jv, jeq, jek, jem, N,
                                       **jkw,
                                       edge_bias=jnp.asarray(d["bias"][g]))),
            (att_h[g], JS.edge_attention(
                metric, jq, jk, jv, jeq, jek, jem, N, **jkw,
                edge_bias=jnp.asarray(d["hbias"][g])))]
        for got, want in pairs:
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=TOL_OPS, atol=TOL_OPS)
        jl = JS.add_self_loops(jeq, jek, jem, jnp.asarray(d["nm"][g]))
        for got, want in zip(loops, jl):
            np.testing.assert_array_equal(got[g].numpy(), np.asarray(want))
    assert np.all(w[:, :, ~d["em"][0]][0].numpy() == 0)
    assert np.all(agg[:, :, N - 1].numpy() == 0)      # a query with no edge


# ---------------------------------------------------------------------------
# The model with edge features against the JAX model
# ---------------------------------------------------------------------------

def _config(**kw):
    base = dict(hidden_dim=16, num_heads=2, num_layers=2, node_feature_dim=8,
                edge_feature_dim=4, use_edge_features=True, output_dim=1,
                loss_type="bce", dropout=0.0, flash_block_m=16,
                flash_block_n=16)
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


def _edge_sequences(seed, duplicates, num=3, T=3, ids=12):
    """``num`` sequences of T snapshots (one sequence a step shorter)
    over node ids 0..ids-1, each snapshot a random subset of the ids
    (so nodes come and go and N <= ids), ~2 unique non-loop edges per
    node with N(0, 1) features; ``duplicates`` adds a second copy of
    the first edge and a self edge to every snapshot."""
    rng = np.random.default_rng(seed)
    seqs = []
    for s in range(num):
        snaps = []
        for t in range(T - (s == 1)):
            nid = np.sort(rng.choice(ids, rng.integers(6, ids + 1),
                                     replace=False))
            n = len(nid)
            off = np.flatnonzero(~np.eye(n, dtype=bool).ravel())
            pick = rng.choice(off, 2 * n, replace=False)
            ei = np.stack([pick // n, pick % n])
            if duplicates:
                ei = np.concatenate([ei, ei[:, :1], [[1], [1]]], axis=1)
            snaps.append({
                "x": rng.standard_normal((n, 8)).astype(np.float32),
                "edge_index": ei, "node_ids": nid, "timestep": float(t),
                "edge_attr": rng.standard_normal(
                    (ei.shape[1], 4)).astype(np.float32)})
        seqs.append(snaps)
    return seqs


def _batches(seqs, dense):
    T, N, E, Fe = tt.pad_dims_for(seqs)
    kw = dict(max_nodes=N, max_edges=E, max_time=T, edge_feature_dim=Fe,
              dense_adj=dense)
    return (tt.batch_sequences([tt.build_sequence(s, **kw) for s in seqs]),
            pt.batch_sequences([pt.build_sequence(s, **kw) for s in seqs]))


@pytest.mark.parametrize("backend", ["dense", "csr", "flash"])
def test_edge_model_matches_jax(backend, interpret):
    """Logits, probabilities, loss and new memory with edge features
    (duplicate edges and a self edge included: each backend combines
    them as the JAX package's does) against the JAX model on the same
    backend."""
    seqs = _edge_sequences(7, duplicates=True)
    jm, jp, tm = _models(spatial_backend=backend)
    jb, tb = _batches(seqs, backend == "dense")
    labels = np.asarray([1.0, 0.0, 1.0], np.float32)
    jo = jax.jit(lambda p, b, y: j_batched_forward(jm, p, b, y))(
        jp, jb, jnp.asarray(labels))
    with torch.no_grad():
        to = pt.batched_forward(tm, tb, _t(labels))
    for got, want in ((to.logits, jo.logits), (to.predictions,
                                               jo.predictions),
                      (to.loss, jo.loss), (to.memory.states,
                                           jo.memory.states)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=TOL, atol=TOL)


def test_edge_backends_agree():
    """Without duplicate edges and self edges the three backends compute
    the same model: csr and flash against dense on logits and memory
    (2e-4 where flash's norm expansion meets dense), and a bias that
    changes the logits (against the model with the edge bias zeroed)."""
    seqs = _edge_sequences(8, duplicates=False)
    _, _, dense = _models(spatial_backend="dense", distance_metric="euclidean")
    outs = {}
    for backend in ("dense", "csr", "flash"):
        tm = pt.TAGAN(pt.TAGANConfig(**_config(spatial_backend=backend,
                                               distance_metric="euclidean")),
                      device="cpu")
        tm.load_state_dict(dense.state_dict())
        _, tb = _batches(seqs, backend == "dense")
        with torch.no_grad():
            outs[backend] = tm(tb)
    for backend in ("csr", "flash"):
        for f in ("logits", "predictions"):
            np.testing.assert_allclose(
                getattr(outs[backend], f).numpy(),
                getattr(outs["dense"], f).numpy(), rtol=TOL_FLASH_DENSE,
                atol=TOL_FLASH_DENSE)
        np.testing.assert_allclose(outs[backend].memory.states.numpy(),
                                   outs["dense"].memory.states.numpy(),
                                   rtol=TOL_FLASH_DENSE,
                                   atol=TOL_FLASH_DENSE)
    with torch.no_grad():
        for layer in dense.geometric_layers.values():
            layer.edge_bias.w.zero_()
            layer.edge_bias.b.zero_()
        _, tb = _batches(seqs, True)
        flat = dense(tb).logits
    assert not np.allclose(flat.numpy(), outs["dense"].logits.numpy(),
                           atol=1e-3)


def _check_grads(got, want):
    """Each parameter's gradient against its own largest entry; one that
    is zero in exact arithmetic (below 1e-6 of the largest gradient) is
    fp32 noise on both sides and must stay below that level."""
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


@pytest.mark.parametrize("backend", ["dense", "csr", "flash"])
def test_edge_model_gradients_match_jax(backend, interpret):
    """d(batch loss)/d(every parameter), edge_embedding and each layer's
    edge_bias included, against jax.grad, with duplicate edges and a
    self edge: dense and csr through autograd of plain torch, flash
    through the biased backward (dB read at the edges' pairs)."""
    seqs = _edge_sequences(9, duplicates=True)
    jm, jp, tm = _models(spatial_backend=backend)
    jb, tb = _batches(seqs, backend == "dense")
    labels = np.asarray([1.0, 0.0, 1.0], np.float32)
    jloss, jg = jax.jit(jax.value_and_grad(
        lambda p: j_batched_forward(jm, p, jb, jnp.asarray(labels)).loss))(jp)
    loss = tm(tb, _t(labels)).loss
    loss.backward()
    assert abs(loss.item() - float(jloss)) <= TOL
    names = dict(tm.named_parameters())
    assert "edge_embedding.w" in names
    assert "geometric_layers.layer_1.edge_bias.w" in names
    for name in ("edge_embedding.w", "geometric_layers.layer_0.edge_bias.w",
                 "geometric_layers.layer_1.edge_bias.w"):
        assert names[name].grad.abs().max() > 0, name
    _check_grads(names, pt.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jg)))


def test_edge_predictor_matches_jax(interpret):
    """Predictor.predict_proba on the flash model with edge features
    against the JAX Predictor (dims with Fe = 4, a padded final batch),
    and its warmup with an edge feature."""
    seqs = _edge_sequences(10, duplicates=True, num=5)
    jm, jp, tm = _models(spatial_backend="flash")
    dims = tt.pad_dims_for(seqs)
    assert dims[3] == 4 and pt.pad_dims_for(seqs) == dims
    want = JPredictor(jm, jp, dims=dims, batch_size=4).predict_proba(seqs)
    pred = pt.Predictor(tm, dims=dims, batch_size=2)
    got = pred.predict_proba(seqs)
    assert got.shape == (5, 1)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    pred.warmup(2)


def test_edge_bias_matrix_adds_duplicates():
    """The flash bias: duplicate edges add, masked edges add nothing, the
    diagonal is 0 unless a self edge is given."""
    src = torch.tensor([[0, 0, 2, 1, 3]], dtype=torch.int32)
    dst = torch.tensor([[1, 1, 2, 0, 3]], dtype=torch.int32)
    em = torch.tensor([[True, True, True, True, False]])
    b = torch.tensor([[0.5, 0.25, -1.0, 2.0, 7.0]])
    m = edge_bias_matrix(b, src, dst, em, 4)[0]
    want = torch.zeros(4, 4)
    want[0, 1], want[2, 2], want[1, 0] = 0.75, -1.0, 2.0
    torch.testing.assert_close(m, want, rtol=0, atol=0)


@pytest.mark.parametrize("backend", ["dense", "csr", "flash"])
def test_edge_training_all_backends(backend):
    """TAGANTrainer trains the edge-feature model with dropout on every
    backend (flash through B4-B7's plain versions here): finite losses,
    and the edge embedding and each layer's edge bias move."""
    seqs = _edge_sequences(11, duplicates=True, num=4)
    ds = pt.TemporalGraphDataset(seqs, [1.0, 0.0, 1.0, 0.0])
    cfg = pt.TAGANConfig(**_config(spatial_backend=backend, dropout=0.1))
    model = pt.TAGAN(cfg, device="cpu")
    before = {n: p.detach().clone() for n, p in model.named_parameters()
              if "edge" in n}
    tr = pt.TAGANTrainer(model, pt.ExperimentConfig(model=cfg, batch_size=2))
    res = tr.train(pt.TemporalGraphDataLoader(
        ds, batch_size=2, dense_adj=backend == "dense"), num_epochs=2,
        verbose=False)
    assert np.all(np.isfinite(res["history"]["train_loss"]))
    params = dict(model.named_parameters())
    assert len(before) == 6
    for name, p in before.items():
        assert not torch.equal(params[name].detach(), p), name
