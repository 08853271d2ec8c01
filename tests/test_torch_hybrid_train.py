"""Training the port's hybrid (band + residual) backend against the JAX
package's on the CPU: the compact plain backward (what B3a c and B3b c
compute) against ``flash_geometric_attention_bwd`` with 3-tuple plans in
interpret mode, the compact attention's, ``apply_hybrid``'s and the
model's gradients against ``jax.grad``, trainer steps over the loader's
``plan="hybrid"``, the loader's plans and what still raises. The JAX side
plans at 16 x 32 tiles, the port at its kernels' 64 x 64: every
gradient is held equal, never store against store."""

import functools
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tagan_torch as pt
import tagan_tpu as tt
from tagan_torch.core import graph as TG
from tagan_torch.core.graph import hybrid_plan_dims, merge_hybrid_dims
from tagan_torch.convert import params_from_jax
from tagan_torch.nn.geometric import GeometricAttention as TGA
from tagan_torch.ops import flash_geometric as TFG
from tagan_tpu.data.dataset import TemporalGraphDataLoader as JLoader
from tagan_tpu.data.dataset import TemporalGraphDataset as JDataset
from tagan_tpu.nn.geometric import GeometricAttention as JGA
from tagan_tpu.ops.pallas import flash_geometric as JFG
from tagan_tpu.train.trainer import TAGANTrainer as JTrainer

# torch's CPU operations on one thread: the tier-1 command runs six
# pytest workers on 8 cores, and torch's default of a thread per core
# oversubscribes them
torch.set_num_threads(1)

# fp32 on both sides, sums in another order (64 x 64 tiles against
# 16 x 32): outputs within 1e-5, gradients and parameters within 1e-4 of
# the largest entry
TOL_OUT = 1e-5
TOL = 1e-4
BM, BN = 16, 32          # the JAX side's tile
N, T, F, E = 70, 2, 8, 160
# gradients that are zero in exact arithmetic: the temporal attention's
# key and time-query biases add one constant to every score of a row
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


def _err(got, want):
    """max |got - want| over the largest entry of want (at least 1)."""
    want = np.asarray(want, np.float64)
    got = got.detach().numpy().astype(np.float64)
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


def _snaps(seed, fe=0, n=N, e=E, steps=T):
    """Banded snapshots (85% of edges within 12 slots of their source,
    the rest uniform: a non-empty residual), some nodes inactive in the
    second snapshot (dead rows)."""
    rng = np.random.default_rng(seed)
    out = []
    for t in range(steps):
        src = rng.integers(0, n, e)
        near = np.clip(src + rng.integers(-12, 13, e), 0, n - 1)
        dst = np.where(rng.random(e) < 0.85, near, rng.integers(0, n, e))
        ids = np.arange(n) if t == 0 else np.arange(n - 3)
        keep = (src < len(ids)) & (dst < len(ids))
        s = {"x": rng.standard_normal((len(ids), F)).astype(np.float32),
             "edge_index": np.stack([src[keep], dst[keep]]),
             "node_ids": ids, "timestep": float(t)}
        if fe:
            s["edge_attr"] = rng.standard_normal(
                (int(keep.sum()), fe)).astype(np.float32)
        out.append(s)
    return out


def _pair(snaps, fe=0, pack=True):
    """(JAX sequence at 16 x 32 tiles, the port's at 64 x 64 with the
    transposed walk)."""
    kw = dict(max_nodes=N, max_edges=E, max_time=T,
              edge_feature_dim=fe or None, dense_adj=False)
    js = tt.build_sequence(snaps, **kw).with_hybrid_plan(
        block_m=BM, block_n=BN, padded_residual=True)
    ts = pt.build_sequence(snaps, **kw).with_hybrid_plan(pack=pack,
                                                         transposed=True)
    return js, ts


def _jplan(js, t):
    return (tuple(p[t] for p in js.hyb_plan),
            tuple(p[t] for p in js.hyb_plan_t))


def _qkv(seed, metric, H=2, D=16, Dv=8):
    rng = np.random.default_rng(seed)
    q, k = (rng.standard_normal((H, N, D)).astype(np.float32)
            for _ in range(2))
    if metric in TFG._COSINE:
        q = q / np.linalg.norm(q, axis=-1, keepdims=True)
        k = k / np.linalg.norm(k, axis=-1, keepdims=True)
    v, do = (rng.standard_normal((H, N, Dv)).astype(np.float32)
             for _ in range(2))
    return q, k, v, do, rng.standard_normal((H, N)).astype(np.float32)


# ---------------------------------------------------------------------------
# The compact plain backward against the Pallas kernels (B3a c, B3b c)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("metric,rate,with_dlse", [
    ("scaled_dot_product", 0.0, True), ("dot_product", 0.3, True),
    ("squared_euclidean", 0.0, False), ("euclidean", 0.3, True),
    ("gaussian_kernel", 0.0, True), ("rbf_kernel", 0.3, False),
    ("cosine_similarity", 0.3, True), ("cosine_distance", 0.0, True)])
def test_compact_plain_backward_matches_pallas(metric, rate, with_dlse,
                                               interpret):
    """`flash_geometric_backward_compact_plain` against JAX's
    ``flash_geometric_attention_bwd`` with 3-tuple plans at 16 x 32
    tiles: dq, dk, dv and dscale (gaussian, rbf), D != Dv, per-head
    scales, the dropout hash bit for bit, with and without an lse
    cotangent, the bit and the int8 store, dead rows (inactive nodes)
    exactly zero in dq."""
    js, ts = _pair(_snaps(5))
    ts_i8 = pt.build_sequence(_snaps(5), max_nodes=N, max_edges=E,
                              max_time=T, dense_adj=False
                              ).with_hybrid_plan(pack=False)
    q, k, v, do, dlse = _qkv(6, metric)
    scale = np.asarray([0.7, 1.6], np.float32)
    t = 1
    jplan, jplan_t = _jplan(js, t)
    need = metric in TFG.SCALED_METRICS
    kw = dict(metric=metric, scale=jnp.asarray(scale), block_m=BM,
              block_n=BN, dropout_rate=rate,
              seed=jnp.asarray([-77], jnp.int32))
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    j_out, j_lse = JFG.flash_geometric_attention_lse(
        jq, jk, jv, js.hyb_mask_blocks[t], metric=metric,
        scale_param=kw["scale"], block_m=BM, block_n=BN, plan=jplan,
        plan_t=jplan_t, dropout_rate=rate, dropout_seed=kw["seed"])
    want = JFG.flash_geometric_attention_bwd(
        jq, jk, jv, js.hyb_mask_blocks[t], j_out, j_lse, jnp.asarray(do),
        plan=jplan, plan_t=jplan_t, need_dscale=need,
        dlse=jnp.asarray(dlse) if with_dlse else None, **kw)
    dead = np.asarray(j_lse)[0] == JFG.LSE_DEAD
    assert dead.any()
    for seq in (ts, ts_i8):
        plan = tuple(p[t:t + 1] for p in seq.hyb_plan)
        got = TFG.flash_geometric_backward_compact_plain(
            _t(q)[None], _t(k)[None], _t(v)[None],
            seq.hyb_mask_blocks[t:t + 1], _t(j_out)[None], _t(j_lse)[None],
            _t(do)[None], *plan, metric,
            _t(scale), rate, torch.tensor([-77], dtype=torch.int32), need,
            _t(dlse)[None] if with_dlse else None)
        for g, w in zip(got[:3], want[:3]):
            assert _err(g[0], w) <= TOL
        assert torch.all(got[0][0][:, dead] == 0)
        if need:
            assert _err(got[3], want[3]) <= TOL
        else:
            assert got[3] is None


def test_compact_plain_backward_matches_dense():
    """The compact plain backward against the dense plain backward (held
    against Pallas in `test_torch_backward.py`) where the port's 64 x 64
    tiling has edge cases the JAX side's 16 x 32 does not reach: a row
    tile with jcount = 0, a key tile with icount = 0 (dk and dv exactly
    zero there), N not a multiple of 64, dead rows, every metric with its
    dscale, dropout and an lse cotangent, both stores."""
    G, H, n, D, Dv = 2, 2, 150, 16, 8
    rng = np.random.default_rng(3)
    mask = torch.from_numpy(rng.random((G, n, n)) < 0.06)
    mask[1, 64:128] = False
    mask[0, :, 64:128] = False
    mask[:, 5] = False
    for metric in JFG.MXU_METRICS:
        q, k = (torch.from_numpy(rng.standard_normal((G, H, n, D)).astype(
            np.float32)) for _ in range(2))
        if metric in TFG._COSINE:
            q, k = TFG._l2_normalize(q), TFG._l2_normalize(k)
        v, do = (torch.from_numpy(rng.standard_normal((G, H, n, Dv)).astype(
            np.float32)) for _ in range(2))
        dlse = torch.from_numpy(rng.standard_normal((G, H, n)).astype(
            np.float32))
        scale, seed = torch.tensor([0.8, 1.5]), torch.tensor([9, -4],
                                                             dtype=torch.int32)
        need = metric in TFG.SCALED_METRICS
        out, lse = TFG.flash_geometric_forward_plain(q, k, v, mask, metric,
                                                     scale, 0.2, seed)
        want = TFG.flash_geometric_backward_plain(
            q, k, v, mask, out, lse, do, metric, scale, 0.2, seed, need, dlse)
        for pack in (True, False):
            store, plan = TFG.compact_from_mask(mask, pack=pack)
            assert int(plan[1][1, 1]) == 0
            assert int(TFG.compact_transposed_plan(mask)[1][0, 1]) == 0
            got = TFG.flash_geometric_backward_compact_plain(
                q, k, v, store, out, lse, do, *plan, metric, scale, 0.2,
                seed, need, dlse)
            for g, w in zip(got, want):
                if w is not None:
                    assert _err(g, w.numpy()) <= TOL_OUT
            assert torch.all(got[1][0, :, 64:128] == 0)
            assert torch.all(got[2][0, :, 64:128] == 0)


# ---------------------------------------------------------------------------
# Gradients through the compact attention, apply_hybrid and the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("metric,rate", [
    ("euclidean", 0.0), ("gaussian_kernel", 0.3), ("cosine_similarity", 0.0)])
def test_compact_attention_gradients_match_jax(metric, rate, interpret):
    """`flash_geometric_attention_lse` with 3-tuple plans (both snapshots
    folded) under autograd, against ``jax.grad`` of JAX's per snapshot:
    a loss on out and on the live rows' lse (its cotangent rides on
    delta), the scale's gradient, cosine normalised outside the
    Function, the int8 store for the scaled metrics."""
    js, ts = _pair(_snaps(8), pack=metric not in TFG.SCALED_METRICS)
    rng = np.random.default_rng(9)
    H, D, Dv = 2, 16, 8
    q, k = (rng.standard_normal((T, H, N, D)).astype(np.float32)
            for _ in range(2))
    v, wo = (rng.standard_normal((T, H, N, Dv)).astype(np.float32)
             for _ in range(2))
    wl = rng.standard_normal((T, H, N)).astype(np.float32)
    scale = np.asarray([0.9, 1.3], np.float32)
    seeds = np.asarray([11, -5], np.int32)

    def jloss(q, k, v, sc):
        total = 0.0
        for t in range(T):
            plan, plan_t = _jplan(js, t)
            o, l = JFG.flash_geometric_attention_lse(
                q[t], k[t], v[t], js.hyb_mask_blocks[t], metric=metric,
                scale_param=sc, block_m=BM, block_n=BN, plan=plan,
                plan_t=plan_t, dropout_rate=rate,
                dropout_seed=jnp.asarray(seeds[t:t + 1]) if rate else None)
            live = jnp.abs(l) < 1e29
            total = total + jnp.sum(o * wo[t]) \
                + jnp.sum(jnp.where(live, l, 0.0) * wl[t])
        return total
    want = jax.grad(jloss, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(a) for a in (q, k, v, scale)))
    leaves = [_t(a).requires_grad_() for a in (q, k, v, scale)]
    out, lse = TFG.flash_geometric_attention_lse(
        *leaves[:3], ts.hyb_mask_blocks, metric, leaves[3],
        plan=ts.hyb_plan, plan_t=ts.hyb_plan_t, dropout_rate=rate,
        dropout_seed=_t(seeds) if rate else None)
    live = lse.abs() < 1e29
    ((out * _t(wo)).sum() + (torch.where(live, lse, 0.0) * _t(wl)).sum()
     ).backward()
    for leaf, w in zip(leaves, want):
        assert torch.isfinite(leaf.grad).all()
        assert _err(leaf.grad, w) <= TOL


@pytest.mark.parametrize("metric", ["scaled_dot_product", "gaussian_kernel",
                                    "mahalanobis"])
def test_apply_hybrid_gradients_match_jax(metric, interpret):
    """``apply_hybrid``'s gradients (every parameter and the input) with
    both snapshots folded into one call, against ``jax.grad`` of JAX's
    per snapshot: the band (B1c with B3a c + B3b c's plain versions) and
    the COO residual merged through their logsumexps, so the band's lse
    gets a cotangent; a learnable gaussian scale and mahalanobis factors;
    inactive rows keep their input (and a zero gradient there is exact,
    not NaN)."""
    js, ts = _pair(_snaps(13))
    kw = dict(hidden_dim=16, num_heads=2, distance_metric=metric,
              learnable_distance=metric in ("gaussian_kernel",
                                            "mahalanobis"), dropout=0.0)
    jattn = JGA(**kw)
    jp = jattn.init(jax.random.key(4))
    tattn = TGA(**kw)
    tattn.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jp)))
    rng = np.random.default_rng(14)
    x = rng.standard_normal((T, N, 16)).astype(np.float32)
    w = rng.standard_normal((T, N, 16)).astype(np.float32)

    def jloss(p, x):
        total = 0.0
        for t in range(T):
            cplan, cplan_t = _jplan(js, t)
            y = jattn.apply_hybrid(
                p, x[t], js.hyb_mask_blocks[t], cplan, cplan_t,
                *(a[t] for a in js.hyb_res), js.node_mask[t], block_m=BM,
                block_n=BN)
            total = total + jnp.sum(y * w[t])
        return total
    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    tx = _t(x).requires_grad_()
    y = tattn.apply_hybrid(tx, ts.hyb_mask_blocks, ts.hyb_plan, ts.hyb_res,
                           ts.node_mask, plan_t=ts.hyb_plan_t)
    (y * _t(w)).sum().backward()
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jgp))
    for name, param in tattn.named_parameters():
        assert torch.isfinite(param.grad).all(), name
        assert _err(param.grad, want[name]) <= TOL, name
    assert torch.isfinite(tx.grad).all()
    assert _err(tx.grad, jgx) <= TOL
    inactive = ~ts.node_mask[1]
    assert torch.all(tx.grad[1][inactive] == _t(w)[1][inactive])


def _models(fe=0, **over):
    cfg = dict(hidden_dim=16, num_heads=2, num_layers=2, node_feature_dim=F,
               edge_feature_dim=fe, use_edge_features=fe > 0, output_dim=1,
               loss_type="bce", dropout=0.0, spatial_backend="hybrid",
               learning_rate=1e-2, weight_decay=0.05, gradient_clip_val=0.1)
    cfg.update(over)
    jm = tt.TAGAN(tt.TAGANConfig(**cfg))
    jp = jm.init(jax.random.key(0))
    tm = pt.TAGAN(pt.TAGANConfig(**cfg), device="cpu")
    tm.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jp)))
    return jm, jp, tm


def _check_grads(got, want):
    """Each parameter's gradient against its own largest entry; one that
    is zero in exact arithmetic (below 1e-6 of the largest) must stay at
    that noise level."""
    assert set(got) == set(want)
    want = {n: np.asarray(w) for n, w in want.items()}
    noise = 1e-6 * max(np.abs(w).max() for w in want.values())
    for name, param in got.items():
        g, w = param.grad, want[name]
        assert torch.isfinite(g).all(), name
        m = np.abs(w).max()
        if m < noise:
            assert g.abs().max().item() < noise, name
        else:
            assert np.abs(g.numpy() - w).max() <= TOL * m, name


def test_model_gradients_match_jax(interpret):
    """d(loss)/d(every parameter) of ``TAGAN(spatial_backend="hybrid")``
    on one sequence against ``jax.grad`` of JAX's model, and the loss."""
    jm, jp, tm = _models()
    js, ts = _pair(_snaps(21))
    y = np.float32(1.0)
    jloss, jg = jax.jit(jax.value_and_grad(
        lambda p: jm(p, js, jnp.asarray(y)).loss))(jp)
    loss = tm(ts, torch.tensor(y)).loss
    loss.backward()
    assert abs(loss.item() - float(jloss)) <= TOL_OUT
    _check_grads(dict(tm.named_parameters()),
                 params_from_jax(jax.tree_util.tree_map(np.asarray, jg)))


def test_trainer_steps_match_jax(interpret):
    """3 steps of both trainers over ``plan="hybrid"`` loaders (one
    sequence per batch; the JAX loader plans at 16 x 32) from the same
    parameters: clipping, AdamW with weight decay. The losses and, after
    every step, the parameters agree within 1e-4."""
    data = [_snaps(30 + s) for s in range(3)]
    labels = [1.0, 0.0, 1.0]
    exp = dict(batch_size=1, num_epochs=1, seed=0)
    jm, jp, tm = _models()
    jt = JTrainer(jm, tt.ExperimentConfig(model=jm.config, **exp), params=jp)
    tr = pt.TAGANTrainer(tm, pt.ExperimentConfig(model=tm.config, **exp))
    jl = JLoader(JDataset(data, labels), batch_size=1, dense_adj=False,
                 plan="hybrid", plan_kwargs=dict(block_m=BM, block_n=BN,
                                                 padded_residual=True))
    tl = pt.TemporalGraphDataLoader(pt.TemporalGraphDataset(data, labels),
                                    batch_size=1, dense_adj=False,
                                    plan="hybrid")
    steps = 0
    for (jb, jy, jmask), (tb, ty, tmask) in zip(jl, tl):
        jt.rng, r = jax.random.split(jt.rng)
        jt.params, jt.opt_state, jloss, _ = jt._train_step(
            jt.params, jt.opt_state, jb, jy, jmask, r, jnp.asarray(1.0))
        tloss, _ = tr._train_step(tb, ty, tmask)
        steps += 1
        assert abs(tloss.item() - float(jloss)) <= TOL
        want = params_from_jax(jax.tree_util.tree_map(np.asarray, jt.params))
        for name, param in tm.named_parameters():
            if name in ZERO_GRAD:
                assert torch.isfinite(param).all(), name
                continue
            np.testing.assert_allclose(param.detach().numpy(), want[name],
                                       rtol=TOL, atol=TOL, err_msg=name)
    assert steps == 3 and tr.optimizer.count == 3


# ---------------------------------------------------------------------------
# The plan and the loader
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pack", [True, False])
def test_transposed_walk_reads_the_same_tiles(pack):
    """``with_hybrid_plan(transposed=True)``: for every key tile, its
    walk lists exactly the row tiles whose walks list it, and each step's
    islot names the same store slot as the row walk's jslot; the pin
    gains ``Wi``, merges only with pins that have it, and a plan past it
    raises."""
    ts = _pair(_snaps(2), pack=pack)[1]
    for t in range(T):
        jl, jc, jsl = (p[t].numpy() for p in ts.hyb_plan)
        il, ic, isl = (p[t].numpy() for p in ts.hyb_plan_t)
        rows = {(i, jl[i, w]): jsl[i, w] for i in range(jl.shape[0])
                for w in range(jc[i])}
        cols = {(il[j, w], j): isl[j, w] for j in range(il.shape[0])
                for w in range(ic[j])}
        assert rows == cols
    TFG.check_compact_plan(*ts.hyb_plan_t, ts.hyb_mask_blocks, N)
    dims = hybrid_plan_dims(ts)
    assert sorted(dims) == ["Er", "S", "Wi", "Wj", "pack"]
    plain = dict(dims)
    del plain["Wi"]
    with pytest.raises(ValueError, match="transposed walk"):
        merge_hybrid_dims([dims, plain])
    assert merge_hybrid_dims([dims, dict(dims, Wi=dims["Wi"] + 1)])["Wi"] \
        == dims["Wi"] + 1
    base = pt.build_sequence(_snaps(2), max_nodes=N, max_edges=E,
                             max_time=T, dense_adj=False)
    assert base.with_hybrid_plan(pin=dims).hyb_plan_t is not None
    assert base.with_hybrid_plan(pin=plain).hyb_plan_t is None
    with pytest.raises(ValueError, match="exceeds its pin"):
        base.with_hybrid_plan(pin=dict(dims, Wi=1))


def test_loader_plans_each_sequence_once(monkeypatch):
    """``TemporalGraphDataLoader(plan="hybrid")`` with more worker threads
    than batches in flight per bucket, one sequence per batch, two
    buckets and a shortened thread switch interval: the first access to
    a bucket plans each member exactly once with the transposed walk
    (threads asking for the same bucket wait for it), records the
    bucket's pin (with ``Wi``), and later batches and epochs take the
    cache; ``plan_kwargs`` reach the planner as given."""
    calls = []
    layout = TG._hybrid_layout

    def counting(seq, *a):
        calls.append(seq.max_nodes)
        return layout(seq, *a)
    monkeypatch.setattr(TG, "_hybrid_layout", counting)
    data = [_snaps(40 + s, n=N - 10 * (s % 2)) for s in range(6)]
    ds = pt.TemporalGraphDataset(data, [1.0, 0.0] * 3)
    loader = pt.TemporalGraphDataLoader(
        ds, batch_size=1, shuffle=True, num_buckets=2, num_workers=6,
        prefetch=6, dense_adj=False, plan="hybrid",
        plan_kwargs=dict(pack=False))
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for _ in range(2):
            for batch, _, _ in loader:
                assert batch.hyb_plan_t[0].shape[:2] == (1, T)
                assert batch.hyb_mask_blocks.dtype == torch.int8
                assert hybrid_plan_dims(batch) in loader.plan_pins.values()
    finally:
        sys.setswitchinterval(interval)
    assert sorted(calls) == sorted([N, N - 10] * 3)
    assert sorted(loader.plan_pins) == [0, 1]
    assert all("Wi" in pin and not pin["pack"]
               for pin in loader.plan_pins.values())
    with pytest.raises(NotImplementedError):
        pt.TemporalGraphDataLoader(ds, plan="ring")
    # the slot reordering is ported: a reordered loader plans too
    rcm = pt.TemporalGraphDataLoader(ds, batch_size=1, dense_adj=False,
                                     plan="hybrid", reorder="rcm")
    assert rcm.reorder == "rcm" and next(iter(rcm))[0].hyb_plan_t is not None


# ---------------------------------------------------------------------------
# What raises
# ---------------------------------------------------------------------------

def test_backward_without_transposed_walk_raises():
    """A backward through the compact attention, or through the hybrid
    model, on a plan built without the transposed walk: ValueError that
    names the fix, never zeros."""
    ts = pt.build_sequence(_snaps(3), max_nodes=N, max_edges=E, max_time=T,
                           dense_adj=False).with_hybrid_plan()
    q = torch.randn(T, 2, N, 16, requires_grad=True)
    out, _ = TFG.flash_geometric_attention_lse(
        q, q.detach(), q.detach(), ts.hyb_mask_blocks, "euclidean",
        plan=ts.hyb_plan)
    with pytest.raises(ValueError, match="plan with the transposed walk"):
        out.sum().backward()
    tm = _models()[2]
    with pytest.raises(ValueError, match="transposed walk"):
        tm(ts, torch.tensor(1.0)).loss.backward()


@pytest.mark.parametrize("field", ["islot", "icount", "ilist"])
def test_bad_transposed_plan_raises(field):
    """A caller's transposed walk with an islot past the store, a count
    past its width, or a row tile past N: ValueError on the host, before
    any backward runs (the kernels' wrappers check the same before a
    launch; `test_torch_gpu.py`)."""
    ts = _pair(_snaps(4))[1]
    il, ic, isl = (p.clone() for p in ts.hyb_plan_t)
    if field == "islot":
        isl[0, 0, 0] = ts.hyb_mask_blocks.shape[1]
    elif field == "icount":
        ic[0, 0] = il.shape[-1] + 1
    else:
        il[0, 0, 0] = 5
    q = torch.randn(T, 2, N, 16)
    with pytest.raises(ValueError):
        TFG.flash_geometric_attention_lse(
            q, q, q, ts.hyb_mask_blocks, "euclidean", plan=ts.hyb_plan,
            plan_t=(il, ic, isl))
    out, lse = TFG.flash_geometric_attention_lse(
        q, q, q, ts.hyb_mask_blocks, "euclidean", plan=ts.hyb_plan)
    with pytest.raises(ValueError):
        TFG.flash_geometric_attention_bwd(
            q[0:1], q[0:1], q[0:1], ts.hyb_mask_blocks[0:1], out[0:1],
            lse[0:1], out[0:1], metric="euclidean",
            plan=tuple(p[0:1] for p in ts.hyb_plan),
            plan_t=(il[0:1], ic[0:1], isl[0:1]))


def test_edge_feature_hybrid_backward_raises():
    """The edge-feature hybrid model (B4c, B5c forward; B6c, B7a c, B7b c
    backward) serves and trains: its backward raises ValueError without
    the transposed walk, and with it gives finite gradients, non-zero on
    the edge embedding and on each layer's edge bias (their values are
    held against ``jax.grad`` in `test_torch_hybrid_edge_train.py`)."""
    tm = _models(fe=4)[2]
    base = pt.build_sequence(_snaps(6, fe=4), max_nodes=N, max_edges=E,
                             max_time=T, dense_adj=False)
    loss = tm(base.with_hybrid_plan(), torch.tensor(1.0)).loss
    assert torch.isfinite(loss)
    with pytest.raises(ValueError, match="transposed walk"):
        loss.backward()
    tm.zero_grad()
    tm(base.with_hybrid_plan(transposed=True),
       torch.tensor(1.0)).loss.backward()
    for name, param in tm.named_parameters():
        assert torch.isfinite(param.grad).all(), name
        if "edge" in name and name.endswith(".w"):
            assert param.grad.abs().max() > 0, name
