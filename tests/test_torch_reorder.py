"""The port's host packing (core.graph, tagan_torch.native) against the
JAX package's: ``build_sequence`` with and without the reverse
Cuthill-McKee slot order against ``tagan_tpu``'s, with and without its
C++ packer, array for array; ``locality_order``'s C++ BFS and its Python
plain version against JAX's order; the CSR build; and the reordered
loader and Predictor against JAX's."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tagan_torch as pt
import tagan_tpu as tt
from tagan_tpu.core import graph as JG
from tagan_tpu.data.dataset import TemporalGraphDataLoader as JLoader
from tagan_tpu.data.dataset import TemporalGraphDataset as JDataset
from tagan_tpu.data.synthetic import (create_dynamic_synthetic_data,
                                      create_synthetic_data)
from tagan_tpu.nn.model import TAGAN as JTAGAN
from tagan_tpu.nn.model import batched_forward as j_batched_forward
from tagan_tpu.serve import Predictor as JPredictor
from tagan_torch import native
from tagan_torch.core import graph as TG
from tagan_torch.ops import build
from tagan_torch.ops.flash_geometric import make_block_plans_from_edges

# torch's CPU operations on one thread: the tier-1 command runs six
# pytest workers on 8 cores, and torch's default of a thread per core
# oversubscribes them
torch.set_num_threads(1)

# fp32 on both sides, sums in another order
TOL = 1e-4


def _banded_shuffled_snapshots(n=96, band=3, T=3, seed=0):
    """A banded graph with shuffled IDs (tests/test_reorder.py's): the
    worst case for sorted-ID slots, the best for RCM."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    pos = {nid: p for p, nid in enumerate(perm)}
    snaps = []
    for t in range(T):
        src, dst = [], []
        for i in range(n - 1):
            for j in range(i + 1, min(i + 1 + band, n)):
                src.append(perm[i])
                dst.append(perm[j])
        ei = np.asarray([[pos[s] for s in src], [pos[d] for d in dst]],
                        np.int64)
        snaps.append({"x": rng.standard_normal((n, 8)).astype(np.float32),
                      "edge_index": ei, "edge_attr": None,
                      "node_ids": list(perm), "timestep": float(t)})
    return snaps


def _churn():
    """Sequences whose node sets change from snapshot to snapshot, with
    edge features."""
    data = create_dynamic_synthetic_data(
        num_samples=3, sequence_length=5, num_nodes_range=(8, 14),
        node_feature_dim=6, edge_feature_dim=3, seed=2)
    return [s for s, _ in data]


def _static():
    data = create_synthetic_data(num_samples=2, sequence_length=4,
                                 node_feature_dim=6, edge_feature_dim=3,
                                 seed=0)
    return [s for s, _ in data]


def _mixed_times():
    """Sequences where some snapshots give a timestep and others do not:
    a step without one takes its index."""
    seqs = []
    for seq in _churn():
        snaps = []
        for t, snap in enumerate(seq):
            x, ei, ea, ids = TG._unpack_snapshot(snap)[:4]
            d = {"x": x, "edge_index": ei, "edge_attr": ea, "node_ids": ids}
            if t % 2 == 0:
                d["timestep"] = 10.0 + 3 * t
            snaps.append(d)
        seqs.append(snaps)
    return seqs


def _same(got, want, fields=TG._BASE_FIELDS):
    for f in fields:
        g, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert g.dtype == w.dtype, f
        np.testing.assert_array_equal(g, w, err_msg=f)


@pytest.mark.parametrize("dense_adj", [True, False])
@pytest.mark.parametrize("source", ["static", "churn"])
def test_build_sequence_pads_like_jax(source, dense_adj):
    """Array for array against ``tt.build_sequence``'s numpy packer at
    the sequences' own sizes and padded past them."""
    seqs = _static() if source == "static" else _churn()
    T, N, E, Fe = pt.pad_dims_for(seqs)
    for seq in seqs:
        for kw in ({}, dict(max_nodes=N + 5, max_edges=E + 3, max_time=T + 1,
                            edge_feature_dim=Fe)):
            _same(pt.build_sequence(seq, dense_adj=dense_adj, **kw),
                  tt.build_sequence(seq, dense_adj=dense_adj,
                                    use_native=False, **kw))


@pytest.mark.parametrize("reorder", [None, "rcm"])
def test_packer_overflow_errors(reorder):
    seq = _static()[0]
    T, N, E, _ = pt.pad_dims_for([seq])
    for kw in (dict(max_nodes=N - 1), dict(max_edges=E - 1),
               dict(max_time=T - 1)):
        with pytest.raises(ValueError):
            pt.build_sequence(seq, reorder=reorder, **kw)
    with pytest.raises(ValueError, match="unknown reorder"):
        pt.build_sequence(seq, reorder="sorted")


@pytest.mark.parametrize("reorder", [None, "rcm"])
@pytest.mark.parametrize("jax_native", [True, False])
@pytest.mark.parametrize("source", ["banded", "churn"])
def test_build_sequence_matches_jax(source, jax_native, reorder):
    """Array for array against ``tt.build_sequence`` with the same
    ``reorder``, packed by JAX's C++ packer and by its numpy packer,
    with and without the adjacency."""
    seqs = [_banded_shuffled_snapshots()] if source == "banded" \
        else _churn()
    T, N, E, Fe = tt.pad_dims_for(seqs)
    for seq in seqs:
        for dense_adj in (True, False):
            kw = dict(max_nodes=N + 2, max_edges=E, max_time=T,
                      edge_feature_dim=Fe, dense_adj=dense_adj,
                      reorder=reorder)
            _same(pt.build_sequence(seq, **kw),
                  tt.build_sequence(seq, use_native=jax_native, **kw))


@pytest.mark.parametrize("reorder", [None, "rcm"])
def test_mixed_timesteps_keep_their_times(reorder):
    """A snapshot keeps its own timestep and one without takes its index,
    as in JAX's numpy packer."""
    seqs = _mixed_times()
    T, N, E, Fe = tt.pad_dims_for(seqs)
    for seq in seqs:
        kw = dict(max_nodes=N, max_edges=E, max_time=T + 1,
                  edge_feature_dim=Fe, reorder=reorder)
        got = pt.build_sequence(seq, **kw)
        _same(got, tt.build_sequence(seq, use_native=False, **kw))
        want = [10.0 + 3 * t if t % 2 == 0 else float(t)
                for t in range(len(seq))] + [0.0]
        np.testing.assert_array_equal(got.times.numpy(),
                                      np.asarray(want, np.float32))


def test_packing_needs_no_compiler(monkeypatch):
    """Only ``reorder="rcm"`` loads the C++ library: without it a
    sequence packs where the library cannot be built."""
    def refuse():
        raise RuntimeError("g++ not found")
    monkeypatch.setattr(native, "_load", refuse)
    seq = _static()[0]
    want = tt.build_sequence(seq, use_native=False)
    _same(pt.build_sequence(seq), want)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        pt.build_sequence(seq, reorder="rcm")


def _random_unpacked(rng):
    """A multi-component graph over sparse, shuffled IDs, with duplicate
    edges and self loops, in `_unpack_snapshot`'s form."""
    n = int(rng.integers(5, 60))
    e = int(rng.integers(0, 4 * n))
    ids = rng.permutation(1000)[:n]
    ei = np.stack([rng.integers(0, n, e), rng.integers(0, n, e)])
    ei = np.concatenate([ei, ei[:, : e // 2],
                         np.stack([np.arange(min(3, n))] * 2)], axis=1)
    x = rng.standard_normal((n, 4)).astype(np.float32)
    return [(x, ei, None, ids, 0.0)]


def test_locality_order_matches_jax():
    """The C++ RCM, its Python plain version and JAX's order agree
    exactly."""
    rng = np.random.default_rng(7)
    cases = [_random_unpacked(rng) for _ in range(5)]
    cases.append([TG._unpack_snapshot(s)
                  for s in _banded_shuffled_snapshots()])
    cases.append([TG._unpack_snapshot(s) for s in _churn()[0]])
    for unpacked in cases:
        want = JG.locality_order([(x, ei, ea, [int(i) for i in ids], t)
                                  for (x, ei, ea, ids, t) in unpacked])
        got = TG.locality_order(unpacked)
        id_arr, src, dst = TG._union_graph(unpacked)
        plain = id_arr[TG._rcm_order_python(src, dst, len(id_arr))]
        assert got.dtype == np.int64
        np.testing.assert_array_equal(got, np.asarray(want, np.int64))
        np.testing.assert_array_equal(plain, got)


def test_coo_to_csr_matches_jax():
    """`coo_to_csr` on [T, E] tensors against JAX's ``coo_to_csr``."""
    rng = np.random.default_rng(0)
    T, E, n = 3, 40, 9
    eq = rng.integers(0, n, (T, E)).astype(np.int32)
    ek = rng.integers(0, n, (T, E)).astype(np.int32)
    em = rng.random((T, E)) > 0.3
    want = JG.coo_to_csr(jnp.asarray(eq), jnp.asarray(ek), jnp.asarray(em),
                         n)
    got = TG.coo_to_csr(torch.from_numpy(eq), torch.from_numpy(ek),
                        torch.from_numpy(em), n)
    for f in ("row_ptr", "col", "perm", "edge_mask"):
        g, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert g.dtype == w.dtype, f
        np.testing.assert_array_equal(g, w, err_msg=f)


def test_rcm_builds_from_the_ports_source(tmp_path, monkeypatch):
    """The library is built from ``tagan_torch/native/rcm.cpp`` into
    ``tagan_torch/_build/``, and a build that fails raises with the
    compiler's output instead of falling back."""
    assert native.SOURCE == build.PACKAGE / "native" / "rcm.cpp"
    path = Path(native._load()._name)
    assert path.parent == build.BUILD_DIR == build.PACKAGE / "_build"
    assert path == native.library_path() and path.exists()
    broken = tmp_path / "rcm.cpp"
    broken.write_text(native.SOURCE.read_text() + "\nnot C++ at all\n")
    monkeypatch.setattr(native, "SOURCE", broken)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native._build(tmp_path / "libbroken.so")
    assert not (tmp_path / "libbroken.so").exists()


def test_rcm_narrows_the_tiles_walked():
    """On the banded graph with shuffled IDs, RCM slots put the edges in
    the diagonal 64 x 64 tiles: the flash plan walks a fraction of the
    tiles the sorted-ID slots make it walk."""
    snaps = _banded_shuffled_snapshots(n=640, band=3, T=1)

    def walked(seq):
        plan, _ = make_block_plans_from_edges(
            seq.edge_src, seq.edge_dst, seq.edge_mask, seq.node_mask,
            seq.max_nodes)
        return int(plan[1].sum())

    plain = walked(pt.build_sequence(snaps, dense_adj=False))
    rcm = walked(pt.build_sequence(snaps, dense_adj=False, reorder="rcm"))
    n_t = 640 // 64
    assert rcm <= 3 * n_t < plain, (rcm, plain)


def _models(**kw):
    cfg = dict(hidden_dim=16, num_heads=2, num_layers=2, node_feature_dim=8,
               output_dim=1, loss_type="bce", dropout=0.0)
    cfg.update(kw)
    jm = JTAGAN(tt.TAGANConfig(**cfg))
    jp = jm.init(jax.random.key(0))
    tm = pt.TAGAN(pt.TAGANConfig(**cfg), device="cpu")
    tm.load_state_dict(pt.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jp)))
    return jm, jp, tm


@pytest.fixture(scope="module")
def shuffled_data():
    """Four banded sequences with shuffled IDs and their labels."""
    seqs = [_banded_shuffled_snapshots(n=40, band=2, T=3, seed=s)
            for s in range(4)]
    return seqs, [1.0, 0.0, 1.0, 0.0]


def test_reordered_loader_matches_jax(shuffled_data):
    """Batches of a ``reorder="rcm"`` loader against JAX's field for
    field, and the csr model's probabilities over them at TOL."""
    seqs, labels = shuffled_data
    kw = dict(batch_size=2, reorder="rcm", dense_adj=False)
    jl = JLoader(JDataset(seqs, labels), **kw)
    tl = pt.TemporalGraphDataLoader(pt.TemporalGraphDataset(seqs, labels),
                                    **kw)
    jm, jp, tm = _models(spatial_backend="csr")
    fwd = jax.jit(lambda p, b, y: j_batched_forward(jm, p, b, y))
    for (tb, ty, _), (jb, jy, _) in zip(tl, jl):
        _same(tb, jb)
        jo = fwd(jp, jb, jy)
        with torch.no_grad():
            to = pt.batched_forward(tm, tb, ty)
        np.testing.assert_allclose(to.predictions.numpy(),
                                   np.asarray(jo.predictions), rtol=TOL,
                                   atol=TOL)
        np.testing.assert_allclose(to.loss.item(), float(jo.loss),
                                   rtol=TOL, atol=TOL)
    # a hybrid-planned loader plans the reordered sequences
    hl = pt.TemporalGraphDataLoader(pt.TemporalGraphDataset(seqs, labels),
                                    plan="hybrid", **kw)
    for (hb, _, _), (tb, _, _) in zip(hl, tl):
        _same(hb, tb)
        assert hb.hyb_plan_t is not None


def test_reordered_predictor_matches_jax(shuffled_data):
    """``Predictor(reorder="rcm")`` on the dense model against JAX's
    Predictor with the same option, and against the sorted-ID slots; the
    hybrid model's (plain versions) against its sorted-ID slots."""
    seqs, _ = shuffled_data
    jm, jp, tm = _models(spatial_backend="dense")
    want = JPredictor(jm, jp, batch_size=2, reorder="rcm").predict_proba(
        seqs)
    got = pt.Predictor(tm, batch_size=2, reorder="rcm").predict_proba(seqs)
    plain = pt.Predictor(tm, batch_size=2).predict_proba(seqs)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, plain, rtol=TOL, atol=TOL)
    _, _, hm = _models(spatial_backend="hybrid")
    hyb = pt.Predictor(hm, batch_size=2, reorder="rcm").predict_proba(seqs)
    hyb_plain = pt.Predictor(hm, batch_size=2).predict_proba(seqs)
    np.testing.assert_allclose(hyb, hyb_plain, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(hyb, want, rtol=TOL, atol=TOL)
