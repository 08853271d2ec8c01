"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs an NVIDIA GPU (marked ``gpu``) and skips
without one.

This file imports only torch, numpy and tagan_torch, so it also runs on a
machine without JAX, skipping the JAX-side conftest:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py
"""

import contextlib

import numpy as np
import pytest
import torch

import tagan_torch as pt
from tagan_torch.dist import mesh as TM
from tagan_torch.ops import flash_geometric as FG
from tagan_torch.ops import ring_flash as TF
from tagan_torch.ops import ring_gather as TG

# fp32 on both sides, sums in another order (kernel: 64-key online
# softmax steps; plain: one dense row)
TOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(G, H, N, D, Dv, seed=0):
    """q, k, v, int8 mask with dead rows (one of them the last row) and,
    for G > 1, a query tile with no keys at all."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((G, H, N, D)).astype(np.float32)
    k = rng.standard_normal((G, H, N, D)).astype(np.float32)
    v = rng.standard_normal((G, H, N, Dv)).astype(np.float32)
    mask = (rng.random((G, N, N)) < 0.1).astype(np.int8)
    mask[0, 5] = 0
    mask[:, N - 1] = 0
    if G > 1:
        mask[1, FG.BLOCK_M:2 * FG.BLOCK_M] = 0
    return tuple(torch.from_numpy(a) for a in (q, k, v, mask))


@pytest.mark.gpu
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("metric", FG.MXU_METRICS)
def test_kernel_matches_plain(metric, rate, cuda):
    """N=150 (not a tile multiple), D != Dv, per-head scale, dropout from
    per-snapshot seeds including a negative one; dead rows exactly."""
    G, H, N = 2, 3, 150
    q, k, v, mask = (t.to(cuda) for t in _inputs(G, H, N, 16, 8))
    if metric in FG._COSINE:
        q, k = FG._l2_normalize(q), FG._l2_normalize(k)
    scale = torch.tensor([0.7, 1.3, 2.0], device=cuda)
    seed = torch.tensor([-7, 12345], dtype=torch.int32, device=cuda)
    jlist, jcount = FG.make_block_plan(mask)
    before = FG.flash_geometric_fwd_kernel.launches
    out, lse = FG.flash_geometric_fwd(q, k, v, mask, jlist, jcount,
                                      metric=metric, scale=scale, seed=seed,
                                      dropout_rate=rate)
    assert FG.flash_geometric_fwd_kernel.launches == before + 1
    p_out, p_lse = FG.flash_geometric_forward_plain(q, k, v, mask, metric,
                                                    scale, rate, seed)
    torch.cuda.synchronize()
    dead = (mask == 0).all(-1)[:, None, :].expand(G, H, N)
    assert torch.all(out[dead] == 0) and torch.all(lse[dead] == FG.LSE_DEAD)
    assert (out - p_out).abs().max().item() <= TOL
    assert (lse - p_lse)[~dead].abs().max().item() <= TOL


@pytest.mark.gpu
@pytest.mark.parametrize("D,Dv", [(7, 3), (40, 72), (128, 128)])
def test_kernel_head_dims(D, Dv, cuda):
    q, k, v, mask = (t.to(cuda) for t in _inputs(1, 2, 200, D, Dv, seed=1))
    jlist, jcount = FG.make_block_plan(mask)
    out, lse = FG.flash_geometric_fwd(q, k, v, mask, jlist, jcount,
                                      metric="euclidean")
    p_out, p_lse = FG.flash_geometric_forward_plain(q, k, v, mask,
                                                    "euclidean")
    torch.cuda.synchronize()
    assert (out - p_out).abs().max().item() <= TOL
    assert (lse - p_lse).abs().max().item() <= TOL


@pytest.mark.gpu
def test_kernel_refuses_what_it_does_not_take(cuda):
    q, k, v, mask = (t.to(cuda) for t in _inputs(1, 2, 70, 16, 16))
    jlist, jcount = FG.make_block_plan(mask)
    kern = FG.flash_geometric_fwd_kernel
    ones = torch.ones(2, device=cuda)
    seed = torch.zeros(1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        kern(q.transpose(-1, -2).contiguous().transpose(-1, -2), k, v, mask,
             jlist, jcount, "dot_product", ones, seed, 0.0)
    with pytest.raises(ValueError, match="int32"):
        kern(q, k, v, mask, jlist.long(), jcount, "dot_product", ones, seed,
             0.0)
    with pytest.raises(ValueError, match="on cpu"):
        kern(q, k, v, mask.cpu(), jlist, jcount, "dot_product", ones, seed,
             0.0)
    lse = torch.zeros(1, 2, 70, device=cuda)
    ilist, icount = FG._transposed_plan(mask)
    with pytest.raises(ValueError, match="lse shape"):
        FG.flash_geometric_bwd_fused_kernel(
            q, k, v, mask, v, lse[..., :-1], lse, ilist, icount,
            "dot_product", ones, seed, 0.0, False)
    with pytest.raises(ValueError, match="float32"):
        FG.flash_geometric_bwd_dq_kernel(
            q, k, v, mask, v.double(), lse, lse, jlist, jcount,
            "dot_product", ones, seed, 0.0, False)


@pytest.mark.gpu
@pytest.mark.parametrize("field,value", [("jlist", -1), ("jlist", 3),
                                         ("jcount", 4)])
def test_bad_plan_raises_before_launch(field, value, cuda):
    """N=150 gives 3 key tiles: a plan pointing outside them is refused on
    the host and the kernel is not launched."""
    q, k, v, mask = (t.to(cuda) for t in _inputs(1, 2, 150, 16, 16))
    jlist, jcount = FG.make_block_plan(mask)
    (jlist if field == "jlist" else jcount)[0, 1] = value
    before = FG.flash_geometric_fwd_kernel.launches
    with pytest.raises(ValueError, match="plan"):
        FG.flash_geometric_fwd(q, k, v, mask, jlist, jcount,
                               metric="dot_product")
    with pytest.raises(ValueError, match="plan"):
        FG.flash_geometric_attention(q, k, v, mask, metric="dot_product",
                                     plan=(jlist, jcount))
    assert FG.flash_geometric_fwd_kernel.launches == before


def _bwd_inputs(G, H, N, D, Dv, seed=0):
    """`_inputs` plus an empty key strip (snapshot 0, keys 64..127), the
    output cotangent do and an lse cotangent."""
    q, k, v, mask = _inputs(G, H, N, D, Dv, seed)
    mask[0, :, FG.BLOCK_N:2 * FG.BLOCK_N] = 0
    rng = np.random.default_rng(seed + 100)
    do = torch.from_numpy(rng.standard_normal((G, H, N, Dv)).astype(np.float32))
    dlse = torch.from_numpy(rng.standard_normal((G, H, N)).astype(np.float32))
    return q, k, v, mask, do, dlse


def _close(got, want):
    """Max abs error over the largest entry (at least 1): fp32 on both
    sides, sums in another order (and dq by atomics under B2)."""
    return ((got - want).abs().max() / want.abs().max().clamp(min=1.0)).item()


def _backward_vs_plain(cuda, G, H, N, D, Dv, metric, rate, fused, dlse=True):
    q, k, v, mask, do, dl = (t.to(cuda) for t in _bwd_inputs(G, H, N, D, Dv))
    if metric in FG._COSINE:
        q, k = FG._l2_normalize(q), FG._l2_normalize(k)
    scale = torch.linspace(0.7, 2.0, H, device=cuda)
    seed = torch.tensor([-7, 12345][:G], dtype=torch.int32, device=cuda)
    need = metric in FG.SCALED_METRICS
    dl = dl if dlse else None
    out, lse = FG.flash_geometric_forward_plain(q, k, v, mask, metric, scale,
                                                rate, seed)
    plan, plan_t = FG.make_block_plans_from_mask(mask)
    kern = FG.flash_geometric_bwd_fused_kernel if fused \
        else FG.flash_geometric_bwd_dkv_kernel
    before = kern.launches
    got = FG.flash_geometric_attention_bwd(
        q, k, v, mask, out, lse, do, metric=metric, scale=scale, plan=plan,
        plan_t=plan_t, seed=seed, dropout_rate=rate, need_dscale=need,
        fused=fused, dlse=dl)
    assert kern.launches == before + 1
    want = FG.flash_geometric_backward_plain(q, k, v, mask, out, lse, do,
                                             metric, scale, rate, seed, need,
                                             dl)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        assert _close(g, w) <= TOL


@pytest.mark.gpu
@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("metric", FG.MXU_METRICS)
def test_backward_kernels_match_plain(metric, rate, fused, cuda):
    """B2 (fused) and B3a + B3b against the plain backward: N=150, D != Dv,
    dead rows, an empty query tile and an empty key strip, per-head
    scales with their gradient, dropout bits from per-snapshot seeds, and
    an lse cotangent."""
    _backward_vs_plain(cuda, 2, 3, 150, 16, 8, metric, rate, fused)


@pytest.mark.gpu
@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("D,Dv", [(7, 3), (40, 72), (128, 128)])
def test_backward_kernel_head_dims(D, Dv, fused, cuda):
    _backward_vs_plain(cuda, 1, 2, 200, D, Dv, "gaussian_kernel", 0.1, fused,
                       dlse=False)


@pytest.mark.gpu
@pytest.mark.parametrize("fused", [True, False])
def test_autograd_on_gpu_matches_cpu(fused, cuda, monkeypatch):
    """flash_geometric_attention under autograd: B1 and the picked backward
    on the card against the plain versions on the CPU, with a learnable
    scale."""
    monkeypatch.setattr(FG, "FUSED_BWD", fused)
    q, k, v, mask, do, _ = _bwd_inputs(2, 2, 130, 16, 16)
    grads = {}
    for dev in ("cuda", "cpu"):
        leaves = [t.to(dev).requires_grad_() for t in (q, k, v)]
        sigma = torch.tensor([0.8, 1.5], device=dev, requires_grad=True)
        out = FG.flash_geometric_attention(
            *leaves, mask.to(dev), metric="gaussian_kernel",
            scale_param=sigma, dropout_rate=0.1,
            dropout_seed=torch.tensor([3, 4], dtype=torch.int32))
        (out * do.to(dev)).sum().backward()
        grads[dev] = [t.grad.cpu() for t in leaves + [sigma]]
    for g, w in zip(grads["cuda"], grads["cpu"]):
        assert _close(g, w) <= TOL


@pytest.mark.gpu
@pytest.mark.parametrize("metric", ["euclidean", "gaussian_kernel"])
@pytest.mark.parametrize("fused", [True, False])
def test_trainer_step_on_gpu_matches_cpu(fused, metric, cuda, monkeypatch):
    """One TAGANTrainer step of the flash model, card (kernels) vs CPU
    (plain versions): the loss, every parameter's gradient (learnable
    sigma included) and the kernels launched (B1 and the picked backward
    once per layer)."""
    monkeypatch.setattr(FG, "FUSED_BWD", fused)
    rng = np.random.default_rng(4)
    n, e, T = 100, 800, 3
    seqs = [[{"x": rng.standard_normal((n, 8)).astype(np.float32),
              "edge_index": rng.integers(0, n, (2, e)),
              "node_ids": np.arange(n), "timestep": float(t)}
             for t in range(T)] for _ in range(2)]
    cfg = pt.TAGANConfig(hidden_dim=32, num_heads=2, num_layers=2,
                         node_feature_dim=8, output_dim=1, loss_type="bce",
                         dropout=0.0, spatial_backend="flash",
                         distance_metric=metric,
                         learnable_distance=metric == "gaussian_kernel")
    ds = pt.TemporalGraphDataset(seqs, [1.0, 0.0])
    batch, labels, smask = next(iter(pt.TemporalGraphDataLoader(
        ds, batch_size=2, dense_adj=False)))
    got = {}
    for dev in ("cuda", "cpu"):
        model = pt.TAGAN(cfg, device=dev,
                         generator=torch.Generator().manual_seed(0))
        tr = pt.TAGANTrainer(model, pt.ExperimentConfig(model=cfg))
        before = {k.name: k.launches for k in FG.KERNELS}
        loss, _ = tr._loss(batch, labels, smask, True)
        loss.backward()
        launched = {k.name: k.launches - before[k.name] for k in FG.KERNELS}
        got[dev] = (loss.item(), {n: p.grad.detach().cpu().clone()
                                  for n, p in model.named_parameters()})
        tr.optimizer.step()
        if dev == "cuda":
            want = {k.name: 0 for k in FG.KERNELS}
            want[FG.flash_geometric_fwd_kernel.name] = 2
            for kern in ((FG.flash_geometric_bwd_fused_kernel,) if fused else
                         (FG.flash_geometric_bwd_dq_kernel,
                          FG.flash_geometric_bwd_dkv_kernel)):
                want[kern.name] = 2
            assert launched == want
    assert abs(got["cuda"][0] - got["cpu"][0]) <= TOL
    _grads_close(got["cuda"][1], got["cpu"][1])


def _grads_close(got, want):
    """The card's gradients against the CPU's, each against its own largest
    entry; one that is zero in exact arithmetic (below 1e-6 of the largest
    gradient) is fp32 noise on both sides."""
    noise = 1e-6 * max(g.abs().max() for g in want.values())
    for name, g in want.items():
        card = got[name]
        assert torch.isfinite(card).all(), name
        if g.abs().max() < noise:
            assert card.abs().max() < noise, name
        else:
            assert (card - g).abs().max() <= TOL * g.abs().max(), name


@pytest.mark.gpu
def test_predictor_on_gpu_matches_cpu(cuda):
    """The flash model through Predictor: card (kernel) vs CPU (plain
    version), one kernel launch per layer per batch."""
    rng = np.random.default_rng(2)
    n, e, T = 100, 800, 3
    seqs = [[{"x": rng.standard_normal((n, 8)).astype(np.float32),
              "edge_index": rng.integers(0, n, (2, e)),
              "node_ids": np.arange(n), "timestep": float(t)}
             for t in range(T)] for _ in range(3)]
    cfg = pt.TAGANConfig(hidden_dim=32, num_heads=2, num_layers=2,
                         node_feature_dim=8, output_dim=1, loss_type="bce",
                         spatial_backend="flash")
    got = {}
    for dev in ("cuda", "cpu"):
        model = pt.TAGAN(cfg, device=dev,
                         generator=torch.Generator().manual_seed(0))
        before = FG.flash_geometric_fwd_kernel.launches
        got[dev] = pt.Predictor(model, batch_size=2).predict_proba(seqs)
        launched = FG.flash_geometric_fwd_kernel.launches - before
        assert launched == (2 * cfg.num_layers if dev == "cuda" else 0)
    assert np.isfinite(got["cuda"]).all() and got["cuda"].shape == (3, 1)
    np.testing.assert_allclose(got["cuda"], got["cpu"], rtol=0, atol=TOL)


def _biased_inputs(G, H, N, D, Dv, metric, seed=0):
    """`_inputs` with cosine q/k normalised, a per-head scale, two hash
    seeds per snapshot and a bias on the mask's pairs built as the model
    builds it: per-edge values added at (src, dst), with every edge
    given twice (duplicates add)."""
    q, k, v, mask = _inputs(G, H, N, D, Dv, seed)
    if metric in FG._COSINE:
        q, k = FG._l2_normalize(q), FG._l2_normalize(k)
    rng = np.random.default_rng(seed + 200)
    g, src, dst = (torch.from_numpy(a) for a in np.nonzero(mask.numpy()))
    b = torch.from_numpy(rng.standard_normal(len(g)).astype(np.float32))
    bias = torch.zeros(G, N, N)
    bias.index_put_((g, src, dst), b, accumulate=True)
    bias.index_put_((g, src, dst), 0.5 * b, accumulate=True)
    scale = torch.linspace(0.7, 2.0, H)
    seeds = FG.biased_seeds(torch.tensor([-7, 12345, 3][:G],
                                         dtype=torch.int32), G, "cpu")
    return q, k, v, mask, bias, scale, seeds


def _biased_vs_plain(cuda, G, H, N, D, Dv, metric, rate, seed=0):
    """B4 against the plain lse1 and B5 against the plain second walk on
    the same lse1: out, lse1 and lse2 within TOL, dead rows exactly, one
    launch each."""
    args = [t.to(cuda) for t in _biased_inputs(G, H, N, D, Dv, metric, seed)]
    q, k, v, mask, bias, scale, seeds = args
    jlist, jcount = FG.make_block_plan(mask)
    before = [kern.launches for kern in (FG.flash_lse1_kernel,
                                         FG.flash_biased_fwd_kernel)]
    lse1 = FG.flash_lse1_kernel(q, k, mask, jlist, jcount, metric, scale)
    p_lse1 = FG.flash_lse1_plain(q, k, mask, metric, scale)
    out, lse2 = FG.flash_biased_fwd_kernel(q, k, v, mask, bias, p_lse1,
                                           jlist, jcount, metric, scale,
                                           seeds, rate)
    p_out, p_lse2 = FG.flash_biased_forward_plain(q, k, v, mask, bias,
                                                  p_lse1, metric, scale,
                                                  rate, seeds)
    torch.cuda.synchronize()
    assert [kern.launches for kern in (FG.flash_lse1_kernel,
                                       FG.flash_biased_fwd_kernel)] == \
        [n + 1 for n in before]
    dead = (mask == 0).all(-1)[:, None, :].expand(G, H, N)
    for lse in (lse1, lse2):
        assert torch.all(lse[dead] == FG.LSE_DEAD)
    assert torch.all(out[dead] == 0)
    assert (out - p_out).abs().max().item() <= TOL
    assert (lse1 - p_lse1)[~dead].abs().max().item() <= TOL
    assert (lse2 - p_lse2)[~dead].abs().max().item() <= TOL


@pytest.mark.gpu
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("metric", FG.MXU_METRICS)
def test_biased_kernels_match_plain(metric, rate, cuda):
    """B4 and B5: N=150 (not a tile multiple), D != Dv, dead rows and an
    empty query tile, per-head scales, both dropouts from per-snapshot
    seed pairs, a bias with duplicate-edge sums."""
    _biased_vs_plain(cuda, 2, 3, 150, 16, 8, metric, rate)


@pytest.mark.gpu
@pytest.mark.parametrize("D,Dv", [(7, 3), (40, 72), (128, 128)])
def test_biased_kernel_head_dims(D, Dv, cuda):
    _biased_vs_plain(cuda, 1, 2, 200, D, Dv, "gaussian_kernel", 0.1, seed=1)


@pytest.mark.gpu
@pytest.mark.parametrize("field,value", [("jlist", -1), ("jlist", 3),
                                         ("jcount", 4)])
def test_biased_bad_plan_raises_before_launch(field, value, cuda):
    """A plan pointing outside the 3 key tiles of N=150 is refused on the
    host; neither B4 nor B5 is launched."""
    q, k, v, mask, bias, _, _ = (t.to(cuda) for t in _biased_inputs(
        1, 2, 150, 16, 16, "dot_product"))
    jlist, jcount = FG.make_block_plan(mask)
    (jlist if field == "jlist" else jcount)[0, 1] = value
    before = [kern.launches for kern in (FG.flash_lse1_kernel,
                                         FG.flash_biased_fwd_kernel)]
    with pytest.raises(ValueError, match="plan"):
        FG.flash_biased_fwd(q, k, v, mask, bias, jlist, jcount,
                            metric="dot_product")
    with pytest.raises(ValueError, match="plan"):
        FG.flash_geometric_attention(q, k, v, mask, metric="dot_product",
                                     plan=(jlist, jcount), bias=bias)
    assert [kern.launches for kern in (FG.flash_lse1_kernel,
                                       FG.flash_biased_fwd_kernel)] == before


@pytest.mark.gpu
def test_edge_predictor_on_gpu_matches_cpu(cuda):
    """The flash model with edge features through Predictor: card (B4
    and B5 once per layer per batch, no B1) vs CPU (plain versions)."""
    rng = np.random.default_rng(3)
    n, e, T = 100, 800, 3
    seqs = [[{"x": rng.standard_normal((n, 8)).astype(np.float32),
              "edge_index": rng.integers(0, n, (2, e)),
              "edge_attr": rng.standard_normal((e, 4)).astype(np.float32),
              "node_ids": np.arange(n), "timestep": float(t)}
             for t in range(T)] for _ in range(3)]
    cfg = pt.TAGANConfig(hidden_dim=32, num_heads=2, num_layers=2,
                         node_feature_dim=8, edge_feature_dim=4,
                         use_edge_features=True, output_dim=1,
                         loss_type="bce", spatial_backend="flash")
    got = {}
    for dev in ("cuda", "cpu"):
        model = pt.TAGAN(cfg, device=dev,
                         generator=torch.Generator().manual_seed(0))
        before = {k.name: k.launches for k in FG.KERNELS}
        got[dev] = pt.Predictor(model, batch_size=2).predict_proba(seqs)
        launched = {k.name: k.launches - before[k.name] for k in FG.KERNELS}
        want = {k.name: 0 for k in FG.KERNELS}
        if dev == "cuda":
            want[FG.flash_lse1_kernel.name] = 2 * cfg.num_layers
            want[FG.flash_biased_fwd_kernel.name] = 2 * cfg.num_layers
        assert launched == want
    assert np.isfinite(got["cuda"]).all() and got["cuda"].shape == (3, 1)
    np.testing.assert_allclose(got["cuda"], got["cpu"], rtol=0, atol=TOL)


def _biased_bwd_vs_plain(cuda, G, H, N, D, Dv, metric, rate, seed=0):
    """The fp32 row walk (B6 and B7a) and key walk (B7b) against the
    plain parts on the plain forward's statistics, with an empty key strip
    (snapshot 0, keys 64..127): delta1, dq, dscale (gaussian/rbf), dk and
    dv within TOL over their largest entry, dB at the mask's pairs (the
    only ones the row walk writes); one launch each."""
    args = [t.to(cuda) for t in _biased_inputs(G, H, N, D, Dv, metric, seed)]
    q, k, v, mask, bias, scale, seeds = args
    mask[0, :, FG.BLOCK_N:2 * FG.BLOCK_N] = 0
    bias = torch.where(mask != 0, bias, torch.zeros_like(bias))
    do = torch.from_numpy(np.random.default_rng(seed + 300).standard_normal(
        (G, H, N, Dv)).astype(np.float32)).to(cuda)
    need = metric in FG.SCALED_METRICS
    lse1 = FG.flash_lse1_plain(q, k, mask, metric, scale)
    out, lse2 = FG.flash_biased_forward_plain(q, k, v, mask, bias, lse1,
                                              metric, scale, rate, seeds)
    d2 = (do * out).sum(-1)
    common = (q, k, v, mask, bias, do, lse1, lse2, d2)
    plan, plan_t = FG.make_block_plans_from_mask(mask)
    kernels = (FG.flash_biased_bwd_row_kernel, FG.flash_biased_bwd_key_kernel)
    before = [kern.launches for kern in kernels]
    d1, db, dq, dsc = FG.flash_biased_bwd_row_kernel(
        *common, *plan, metric, scale, seeds, rate, need)
    dk, dv = FG.flash_biased_bwd_key_kernel(*common, d1, *plan_t, metric,
                                            scale, seeds, rate)
    torch.cuda.synchronize()
    assert [kern.launches for kern in kernels] == [n + 1 for n in before]
    p_d1, p_db = FG.flash_biased_bwd_pre_plain(*common, metric, scale, rate,
                                               seeds)
    p_dq, p_dsc = FG.flash_biased_bwd_dq_plain(*common, p_d1, metric, scale,
                                               rate, seeds, need)
    p_dk, p_dv = FG.flash_biased_bwd_dkv_plain(*common, p_d1, metric, scale,
                                               rate, seeds)
    for g, w in ((d1, p_d1), (dq, p_dq), (dk, p_dk), (dv, p_dv)):
        assert torch.isfinite(g).all()
        assert _close(g, w) <= TOL
    on = mask != 0
    assert torch.isfinite(db[on]).all()
    assert _close(db[on], p_db[on]) <= TOL
    assert (dsc is None) == (not need)
    if need:
        assert _close(dsc, p_dsc) <= TOL


@pytest.mark.gpu
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("metric", FG.MXU_METRICS)
def test_biased_backward_kernels_match_plain(metric, rate, cuda):
    """The fp32 row and key walks: N=150 (not a tile multiple), D != Dv,
    dead rows, an empty query tile and an empty key strip, per-head scales
    with their gradient, both dropouts from per-snapshot seed pairs, a
    bias with duplicate-edge sums."""
    _biased_bwd_vs_plain(cuda, 2, 3, 150, 16, 8, metric, rate)


@pytest.mark.gpu
@pytest.mark.parametrize("D,Dv", [(7, 3), (40, 72), (128, 128)])
def test_biased_backward_kernel_head_dims(D, Dv, cuda):
    _biased_bwd_vs_plain(cuda, 1, 2, 200, D, Dv, "gaussian_kernel", 0.1,
                         seed=1)


@pytest.mark.gpu
@pytest.mark.parametrize("field,value", [("jlist", -1), ("jlist", 3),
                                         ("jcount", 4)])
def test_biased_backward_bad_plan_raises_before_launch(field, value, cuda):
    """A forward or transposed plan pointing outside the 3 tiles of N=150
    is refused on the host; neither walk is launched."""
    q, k, v, mask, bias, _, _ = (t.to(cuda) for t in _biased_inputs(
        1, 2, 150, 16, 16, "dot_product"))
    plan, plan_t = FG.make_block_plans_from_mask(mask)
    out = torch.zeros_like(v)
    lse = torch.zeros(q.shape[:3], device=cuda)
    kernels = (FG.flash_biased_bwd_row_kernel, FG.flash_biased_bwd_key_kernel)
    before = [kern.launches for kern in kernels]
    for which in (0, 1):
        bad = [t.clone() for t in (plan, plan_t)[which]]
        (bad[0] if field == "jlist" else bad[1])[0, 1] = value
        plans = (bad, plan_t) if which == 0 else (plan, bad)
        with pytest.raises(ValueError, match="plan"):
            FG.flash_biased_attention_bwd(
                q, k, v, bias, mask, out, lse, lse, out, metric="dot_product",
                plan=tuple(plans[0]), plan_t=tuple(plans[1]))
    assert [kern.launches for kern in kernels] == before


def _edge_seqs(rng, n, e, T, num, short=False):
    """``num`` sequences of T snapshots with 4 edge features; with
    ``short`` the second is one snapshot shorter and its snapshots have
    fewer edges, so a batch of them has padded edges (at (0, 0)) and a
    padded snapshot in which the walk visits no block."""
    seqs = []
    for s in range(num):
        snaps = []
        for t in range(T - (short and s == 1)):
            ee = e - (short and s == 1) * e // 4
            snaps.append({"x": rng.standard_normal((n, 8)).astype(np.float32),
                          "edge_index": rng.integers(0, n, (2, ee)),
                          "edge_attr": rng.standard_normal(
                              (ee, 4)).astype(np.float32),
                          "node_ids": np.arange(n), "timestep": float(t)})
        seqs.append(snaps)
    return seqs


def _edge_step(cfg, batch, labels, smask, dev):
    """One TAGANTrainer step's loss, gradients and launches on ``dev``."""
    model = pt.TAGAN(cfg, device=dev, generator=torch.Generator().manual_seed(0))
    tr = pt.TAGANTrainer(model, pt.ExperimentConfig(model=cfg))
    before = {k.name: k.launches for k in FG.KERNELS}
    loss, _ = tr._loss(batch, labels, smask, True)
    loss.backward()
    launched = {k.name: k.launches - before[k.name] for k in FG.KERNELS}
    grads = {n: p.grad.detach().cpu().clone()
             for n, p in model.named_parameters()}
    tr.optimizer.step()
    return loss.item(), grads, launched


@pytest.mark.gpu
@pytest.mark.parametrize("metric", ["euclidean", "gaussian_kernel"])
def test_edge_trainer_step_on_gpu_matches_cpu(metric, cuda):
    """One TAGANTrainer step of the flash model with edge features, card
    (B4, B5, the row walk and the key walk once per layer) vs CPU (plain
    versions): the
    loss and every gradient, edge_embedding, edge_bias and a learnable
    sigma included."""
    seqs = _edge_seqs(np.random.default_rng(5), 100, 800, 3, 2)
    cfg = pt.TAGANConfig(hidden_dim=32, num_heads=2, num_layers=2,
                         node_feature_dim=8, edge_feature_dim=4,
                         use_edge_features=True, output_dim=1,
                         loss_type="bce", dropout=0.0,
                         spatial_backend="flash", distance_metric=metric,
                         learnable_distance=metric == "gaussian_kernel")
    batch, labels, smask = next(iter(pt.TemporalGraphDataLoader(
        pt.TemporalGraphDataset(seqs, [1.0, 0.0]), batch_size=2,
        dense_adj=False)))
    got = {dev: _edge_step(cfg, batch, labels, smask, dev)
           for dev in ("cuda", "cpu")}
    want = {k.name: 0 for k in FG.KERNELS}
    for kern in (FG.flash_lse1_kernel, FG.flash_biased_fwd_kernel,
                 FG.flash_biased_bwd_row_kernel,
                 FG.flash_biased_bwd_key_kernel):
        want[kern.name] = cfg.num_layers
    assert got["cuda"][2] == want
    assert abs(got["cuda"][0] - got["cpu"][0]) <= TOL
    for name in ("edge_embedding.w", "geometric_layers.layer_0.edge_bias.w",
                 "geometric_layers.layer_1.edge_bias.w"):
        assert got["cuda"][1][name].abs().max() > 0, name
    _grads_close(got["cuda"][1], got["cpu"][1])


@pytest.mark.gpu
def test_edge_padded_edges_on_unwalked_blocks(cuda):
    """A batch whose padded edges (at (0, 0)) lie in a padded snapshot
    where the walk visits no block, so the row walk leaves its dB unset
    there: with the
    allocator's memory filled with NaN first, the gradients stay finite
    and equal the CPU's (the model reads dB at edges through a select)."""
    seqs = _edge_seqs(np.random.default_rng(6), 100, 800, 3, 2, short=True)
    cfg = pt.TAGANConfig(hidden_dim=32, num_heads=2, num_layers=2,
                         node_feature_dim=8, edge_feature_dim=4,
                         use_edge_features=True, output_dim=1,
                         loss_type="bce", dropout=0.0,
                         spatial_backend="flash")
    batch, labels, smask = next(iter(pt.TemporalGraphDataLoader(
        pt.TemporalGraphDataset(seqs, [1.0, 0.0]), batch_size=2,
        dense_adj=False)))
    em = batch.edge_mask
    assert not bool(em[1, -1].any()) and not bool(batch.node_mask[1, -1].any())
    from tagan_torch.nn.model import flash_structures
    _, (_, jcount), _ = flash_structures(
        batch.edge_src, batch.edge_dst, em, batch.node_mask, batch.max_nodes)
    assert int(jcount[1, -1].sum()) == 0
    N = batch.max_nodes
    nan = torch.full((4 * batch.x.shape[0] * batch.x.shape[1] * N * N,),
                     float("nan"), device=cuda)
    del nan
    got = {dev: _edge_step(cfg, batch, labels, smask, dev)
           for dev in ("cuda", "cpu")}
    assert abs(got["cuda"][0] - got["cpu"][0]) <= TOL
    _grads_close(got["cuda"][1], got["cpu"][1])


# ---------------------------------------------------------------------------
# B1c, B4c, B5c: the compact-store forms of the hybrid backend's band
# ---------------------------------------------------------------------------

COMPACT = (FG.flash_geometric_fwd_compact_kernel, FG.flash_lse1_compact_kernel,
           FG.flash_biased_fwd_compact_kernel)


def _compact_inputs(G, H, N, D, Dv, metric, pack, seed=0):
    """`_biased_inputs` with the mask and the bias moved to a compact
    store (bits or int8) and a bias store in its slots: dead rows, a
    query tile with jcount = 0 (snapshot 1, rows 64..127), the ragged
    edge of N."""
    q, k, v, mask, bias, scale, seeds = _biased_inputs(G, H, N, D, Dv,
                                                       metric, seed)
    store, plan = FG.compact_from_mask(mask, pack=pack)
    bias_store = FG.compact_values(mask, bias)
    if G > 1:
        assert int(plan[1][1, 1]) == 0
    return q, k, v, mask, bias, store, bias_store, plan, scale, seeds


def _compact_vs_plain(cuda, G, H, N, D, Dv, metric, rate, pack, seed=0):
    """B1c, B4c and B5c (on a union-like lse1: B4c's plus a constant)
    against their compact plain versions and B1c, B4c against the dense
    plain versions: within TOL, dead rows exactly, one launch each."""
    q, k, v, mask, bias, store, bias_store, plan, scale, seeds = (
        t.to(cuda) if torch.is_tensor(t) else tuple(p.to(cuda) for p in t)
        for t in _compact_inputs(G, H, N, D, Dv, metric, pack, seed))
    seed1 = seeds[:, 0].contiguous()
    before = [kern.launches for kern in COMPACT]
    out, lse = FG.flash_geometric_fwd_compact(
        q, k, v, store, *plan, metric=metric, scale=scale, seed=seed1,
        dropout_rate=rate)
    lse1 = FG.flash_lse1_compact(q, k, store, *plan, metric=metric,
                                 scale=scale)
    lse1_u = torch.where(lse1 < 1e29, lse1 + 0.25, lse1).contiguous()
    out2, lse2 = FG.flash_biased_fwd_compact(
        q, k, v, store, bias_store, lse1_u, *plan, metric=metric, scale=scale,
        seeds=seeds, dropout_rate=rate)
    assert [kern.launches for kern in COMPACT] == [n + 1 for n in before]
    p_out, p_lse = FG.flash_geometric_forward_compact_plain(
        q, k, v, store, *plan, metric, scale, rate, seed1)
    p_lse1 = FG.flash_lse1_compact_plain(q, k, store, *plan, metric, scale)
    p_out2, p_lse2 = FG.flash_biased_forward_compact_plain(
        q, k, v, store, bias_store, lse1_u, *plan, metric, scale, rate, seeds)
    d_out, d_lse = FG.flash_geometric_forward_plain(q, k, v, mask, metric,
                                                    scale, rate, seed1)
    torch.cuda.synchronize()
    dead = (mask == 0).all(-1)[:, None, :].expand(G, H, N)
    for t in (lse, lse1, lse2):
        assert torch.all(t[dead] == FG.LSE_DEAD)
    assert torch.all(out[dead] == 0) and torch.all(out2[dead] == 0)
    for got, want in ((out, p_out), (out2, p_out2), (out, d_out)):
        assert (got - want).abs().max().item() <= TOL
    for got, want in ((lse, p_lse), (lse1, p_lse1), (lse2, p_lse2),
                      (lse, d_lse)):
        assert (got - want)[~dead].abs().max().item() <= TOL


@pytest.mark.gpu
@pytest.mark.parametrize("pack", [True, False])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("metric", FG.MXU_METRICS)
def test_compact_kernels_match_plain(metric, rate, pack, cuda):
    """B1c, B4c and B5c, bit and int8 stores: N=150 (not a tile
    multiple), D != Dv, dead rows, a row tile with jcount = 0, per-head
    scales, dropout from per-snapshot seeds (negative included)."""
    _compact_vs_plain(cuda, 2, 3, 150, 16, 8, metric, rate, pack)


@pytest.mark.gpu
@pytest.mark.parametrize("D,Dv", [(7, 3), (40, 72), (128, 128)])
def test_compact_kernel_head_dims(D, Dv, cuda):
    _compact_vs_plain(cuda, 1, 2, 200, D, Dv, "gaussian_kernel", 0.1, True,
                      seed=1)


@pytest.mark.gpu
@pytest.mark.parametrize("fault", ["jslot_low", "jslot_high", "jlist",
                                   "tile", "dtype"])
def test_compact_bad_plan_raises_before_launch(fault, cuda):
    """A caller's jslot outside [0, S), jlist outside the key tiles, a
    store at another tile or of another dtype: ValueError on the host,
    no compact kernel launched."""
    q, k, v, mask, bias, store, bias_store, plan, scale, seeds = (
        t.to(cuda) if torch.is_tensor(t) else tuple(p.to(cuda) for p in t)
        for t in _compact_inputs(1, 2, 150, 16, 16, "dot_product", True))
    jlist, jcount, jslot = (p.clone() for p in plan)
    S = store.shape[1]
    if fault == "jslot_low":
        jslot[0, 1, 0] = -1
    elif fault == "jslot_high":
        jslot[0, 1, 0] = S
    elif fault == "jlist":
        jlist[0, 1, 0] = 3
    elif fault == "tile":
        store = store.reshape(1, S * 2, 32)
    else:
        store = store.to(torch.int32)
    before = [kern.launches for kern in COMPACT]
    lse1 = torch.zeros(1, 2, 150, device=cuda)
    for call in (
            lambda: FG.flash_geometric_fwd_compact(
                q, k, v, store, jlist, jcount, jslot, metric="dot_product"),
            lambda: FG.flash_lse1_compact(q, k, store, jlist, jcount, jslot,
                                          metric="dot_product"),
            lambda: FG.flash_biased_fwd_compact(
                q, k, v, store, bias_store, lse1, jlist, jcount, jslot,
                metric="dot_product")):
        with pytest.raises(ValueError):
            call()
    assert [kern.launches for kern in COMPACT] == before


COMPACT_BWD = (FG.flash_geometric_bwd_dq_compact_kernel,
               FG.flash_geometric_bwd_dkv_compact_kernel)


def _compact_bwd_inputs(G, H, N, D, Dv, metric, pack, seed=0):
    """`_biased_inputs`' q, k, v, mask, scale and first seeds, plus a key
    tile with icount = 0 (snapshot 0, keys 64..127) beside the row tile
    with jcount = 0 and the dead rows; the store, both walks, a forward
    (out, lse) from the compact plain version, dO and an lse
    cotangent."""
    q, k, v, mask, _, scale, seeds = _biased_inputs(G, H, N, D, Dv, metric,
                                                    seed)
    mask[0, :, FG.BLOCK_N:2 * FG.BLOCK_N] = 0
    store, plan = FG.compact_from_mask(mask, pack=pack)
    plan_t = FG.compact_transposed_plan(mask)
    assert int(plan_t[1][0, 1]) == 0
    rng = np.random.default_rng(seed + 300)
    do = torch.from_numpy(rng.standard_normal((G, H, N, Dv)).astype(
        np.float32))
    dlse = torch.from_numpy(rng.standard_normal((G, H, N)).astype(
        np.float32))
    return q, k, v, mask, store, plan, plan_t, scale, \
        seeds[:, 0].contiguous(), do, dlse


def _compact_bwd_vs_plain(cuda, G, H, N, D, Dv, metric, rate, pack, seed=0):
    """B3a c then B3b c (through `flash_geometric_attention_bwd` with
    3-tuple plans) against the compact plain backward: dq, dk, dv and
    dscale within TOL of the largest entry, dq zero on dead rows and dk,
    dv zero on the key tile with icount = 0, one launch each."""
    q, k, v, mask, store, plan, plan_t, scale, seed1, do, dlse = (
        t.to(cuda) if torch.is_tensor(t) else tuple(p.to(cuda) for p in t)
        for t in _compact_bwd_inputs(G, H, N, D, Dv, metric, pack, seed))
    out, lse = (t.contiguous() for t in
                FG.flash_geometric_forward_compact_plain(
                    q, k, v, store, *plan, metric, scale, rate, seed1))
    need = metric in FG.SCALED_METRICS
    before = [kern.launches for kern in COMPACT_BWD]
    got = FG.flash_geometric_attention_bwd(
        q, k, v, store, out, lse, do, metric=metric, scale=scale, plan=plan,
        plan_t=plan_t, seed=seed1, dropout_rate=rate, need_dscale=need,
        dlse=dlse)
    assert [kern.launches for kern in COMPACT_BWD] == [n + 1 for n in before]
    want = FG.flash_geometric_backward_compact_plain(
        q, k, v, store, out, lse, do, *plan, metric, scale, rate, seed1,
        need, dlse)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert ((g - w).abs().max() / w.abs().max().clamp(min=1.0)).item() \
            <= TOL
    dead = (mask == 0).all(-1)[:, None, :].expand(G, H, N)
    assert torch.all(got[0][dead] == 0)
    assert torch.all(got[1][0, :, FG.BLOCK_N:2 * FG.BLOCK_N] == 0)
    assert torch.all(got[2][0, :, FG.BLOCK_N:2 * FG.BLOCK_N] == 0)


@pytest.mark.gpu
@pytest.mark.parametrize("pack", [True, False])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("metric", FG.MXU_METRICS)
def test_compact_backward_kernels_match_plain(metric, rate, pack, cuda):
    """B3a c and B3b c, bit and int8 stores: N=150 (not a tile multiple),
    D != Dv, dead rows, a row tile with jcount = 0 and a key tile with
    icount = 0, per-head scales with dscale, dropout from per-snapshot
    seeds (negative included), a non-zero lse cotangent."""
    _compact_bwd_vs_plain(cuda, 2, 3, 150, 16, 8, metric, rate, pack)


@pytest.mark.gpu
@pytest.mark.parametrize("D,Dv", [(7, 3), (40, 72), (128, 128)])
def test_compact_backward_head_dims(D, Dv, cuda):
    _compact_bwd_vs_plain(cuda, 1, 2, 200, D, Dv, "gaussian_kernel", 0.1,
                          False, seed=1)


@pytest.mark.gpu
@pytest.mark.parametrize("fault", ["islot", "icount", "ilist", "jslot"])
def test_compact_backward_bad_plan_raises_before_launch(fault, cuda):
    """The wrappers of B3a c and B3b c check the walk's values: an islot
    or jslot past the store, a count past the walk's width or a tile past
    N raises ValueError on the host, and no kernel is launched."""
    q, k, v, mask, store, plan, plan_t, scale, seed1, do, dlse = (
        t.to(cuda) if torch.is_tensor(t) else tuple(p.to(cuda) for p in t)
        for t in _compact_bwd_inputs(1, 2, 150, 16, 16, "dot_product", True))
    jl, jc, js = (p.clone() for p in plan)
    il, ic, isl = (p.clone() for p in plan_t)
    S = store.shape[1]
    if fault == "islot":
        isl[0, 0, 0] = S
    elif fault == "icount":
        ic[0, 0] = il.shape[-1] + 1
    elif fault == "ilist":
        il[0, 0, 0] = 3
    else:
        js[0, 0, 0] = -1
    lse = torch.zeros(1, 2, 150, device=cuda)
    before = [kern.launches for kern in COMPACT_BWD]
    with pytest.raises(ValueError):
        if fault == "jslot":
            FG.flash_geometric_bwd_dq_compact_kernel(
                q, k, v, store, do, lse, lse, jl, jc, js, "dot_product",
                scale, seed1, 0.0, False)
        else:
            FG.flash_geometric_bwd_dkv_compact_kernel(
                q, k, v, store, do, lse, lse, il, ic, isl, "dot_product",
                scale, seed1, 0.0)
    assert [kern.launches for kern in COMPACT_BWD] == before


@pytest.mark.gpu
def test_hybrid_trainer_step_on_gpu_matches_cpu(cuda):
    """One training step of the hybrid model over a ``plan="hybrid"``
    loader on the card (B1c, B3a c and B3b c once per layer; no other
    kernel) and on the CPU (plain versions), from the same weights: the
    loss and every gradient."""
    seqs = _hybrid_seqs(np.random.default_rng(8), 300, 2400, 2, 1, 0)
    cfg = pt.TAGANConfig(hidden_dim=32, num_heads=2, num_layers=2,
                         node_feature_dim=8, output_dim=1, loss_type="bce",
                         dropout=0.0, spatial_backend="hybrid")
    got = {}
    for dev in ("cuda", "cpu"):
        model = pt.TAGAN(cfg, device=dev,
                         generator=torch.Generator().manual_seed(0))
        loader = pt.TemporalGraphDataLoader(
            pt.TemporalGraphDataset(seqs, [1.0]), batch_size=1,
            dense_adj=False, plan="hybrid")
        batch, labels, _ = next(iter(loader))
        before = {k.name: k.launches for k in FG.KERNELS}
        loss = model(batch, labels).loss
        loss.backward()
        launched = {k.name: k.launches - before[k.name] for k in FG.KERNELS}
        want = {k.name: 0 for k in FG.KERNELS}
        if dev == "cuda":
            for kern in (FG.flash_geometric_fwd_compact_kernel,) + COMPACT_BWD:
                want[kern.name] = cfg.num_layers
        assert launched == want
        got[dev] = (loss.item(), {n: p.grad.cpu()
                                  for n, p in model.named_parameters()})
    assert abs(got["cuda"][0] - got["cpu"][0]) <= TOL
    scale = max(g.abs().max().item() for g in got["cpu"][1].values())
    for name, g in got["cpu"][1].items():
        assert torch.isfinite(got["cuda"][1][name]).all(), name
        assert (got["cuda"][1][name] - g).abs().max().item() <= TOL * scale, \
            name


def _hybrid_seqs(rng, n, e, T, num, fe):
    seqs = []
    for _ in range(num):
        snaps = []
        for t in range(T):
            src = rng.integers(0, n, e)
            near = np.clip(src + rng.integers(-40, 41, e), 0, n - 1)
            dst = np.where(rng.random(e) < 0.9, near, rng.integers(0, n, e))
            s = {"x": rng.standard_normal((n, 8)).astype(np.float32),
                 "edge_index": np.stack([src, dst]),
                 "node_ids": np.arange(n), "timestep": float(t)}
            if fe:
                s["edge_attr"] = rng.standard_normal((e, fe)).astype(
                    np.float32)
            snaps.append(s)
        seqs.append(snaps)
    return seqs


@pytest.mark.gpu
@pytest.mark.parametrize("fe", [0, 4])
def test_hybrid_predictor_on_gpu_matches_cpu(fe, cuda):
    """The hybrid model through Predictor, without and with edge
    features: card (B1c, or B4c and B5c, once per layer per batch; no
    other kernel) vs CPU (plain versions)."""
    seqs = _hybrid_seqs(np.random.default_rng(7), 300, 2400, 2, 3, fe)
    cfg = pt.TAGANConfig(hidden_dim=32, num_heads=2, num_layers=2,
                         node_feature_dim=8, edge_feature_dim=fe,
                         use_edge_features=fe > 0, output_dim=1,
                         loss_type="bce", spatial_backend="hybrid")
    got = {}
    for dev in ("cuda", "cpu"):
        model = pt.TAGAN(cfg, device=dev,
                         generator=torch.Generator().manual_seed(0))
        before = {k.name: k.launches for k in FG.KERNELS}
        got[dev] = pt.Predictor(model, batch_size=2).predict_proba(seqs)
        launched = {k.name: k.launches - before[k.name] for k in FG.KERNELS}
        want = {k.name: 0 for k in FG.KERNELS}
        if dev == "cuda":
            for kern in ((FG.flash_lse1_compact_kernel,
                          FG.flash_biased_fwd_compact_kernel) if fe else
                         (FG.flash_geometric_fwd_compact_kernel,)):
                want[kern.name] = 2 * cfg.num_layers
        assert launched == want
    assert np.isfinite(got["cuda"]).all() and got["cuda"].shape == (3, 1)
    np.testing.assert_allclose(got["cuda"], got["cpu"], rtol=0, atol=TOL)


# ---------------------------------------------------------------------------
# B6c, B7a c, B7b c: the compact-store biased backward of the edge-feature
# hybrid band; in fp32 the compact row walk (B6c and B7a c) and key walk
# (B7b c)
# ---------------------------------------------------------------------------

COMPACT_BIASED_BWD = (FG.flash_biased_bwd_row_compact_kernel,
                      FG.flash_biased_bwd_key_compact_kernel)


def band_mask(G, N, seed=0, deg=4, width=150):
    """int8 [G, N, N] like the hybrid backend's band: ~``deg`` keys a row
    within ``width`` of it and the diagonal (~1 valid pair a row a walked
    64 x 64 tile, over several tiles), and in every snapshot where N
    allows: a whole 64 x 64 tile (rows 0-63, keys 64-127), a tile holding
    one pair (rows 128-191, keys 0-63), a key tile no row reaches (keys
    192-255: its transposed walk is empty), rows past 128 keys (rows
    260-263, 150 keys each: the row walk's lists overflow and it walks
    its slots again) and dead rows (300-304 and the last row). Shared by
    the CPU test of the compact plain biased backward against JAX
    (test_torch_fp32_compact_biased_bwd.py)."""
    rng = np.random.default_rng(seed)
    mask = np.zeros((G, N, N), np.int8)
    for g in range(G):
        rows = np.repeat(np.arange(N), deg)
        cols = np.clip(rows + rng.integers(-width, width + 1, rows.size), 0,
                       N - 1)
        mask[g, rows, cols] = 1
        mask[g, np.arange(N), np.arange(N)] = 1
        if N >= 128:
            mask[g, :64, 64:128] = 1
        if N >= 192:
            mask[g, 128:192, :64] = 0
            mask[g, 130, 17] = 1
        if N >= 256:
            mask[g, :, 192:256] = 0
        if N >= 264:
            keys = np.r_[0:192, 256:N]
            for r in range(260, 264):
                mask[g, r, rng.choice(keys, 150, replace=False)] = 1
        if N >= 305:
            mask[g, 300:305] = 0
        mask[g, N - 1] = 0
    return mask


def band_compact(mask, pack, seed=0):
    """The compact store and both walks of ``mask`` (`compact_from_mask`,
    `compact_transposed_plan`) with two cases that a mask does not make:
    a walked slot whose bits are all 0 (slot S, appended to every
    snapshot's store, walked by row tile 0 at the last key tile that no
    row of it reaches and that some row does, in both walks, each one
    column wider), and walk entries past the counts naming random tiles
    and occupied slots (a walk that read past its count would add their
    pairs). Returns (store with S + 1 slots, plan, plan_t)."""
    store, plan = FG.compact_from_mask(mask, pack=pack)
    plan_t = FG.compact_transposed_plan(mask)
    G, S = store.shape[:2]
    store = torch.cat([store, torch.zeros_like(store[:, :1])], 1)
    occ = FG._occ_from_mask(mask, FG.BLOCK_M, FG.BLOCK_N)
    n_t = occ.shape[-1]
    jb = max(j for j in range(n_t)
             if not occ[:, 0, j].any() and occ[:, :, j].any(-1).all())
    rng = np.random.default_rng(seed + 77)

    def widen(p, tile, step):
        lst, cnt, sl = (torch.nn.functional.pad(x, (0, 1)) if x.dim() == 3
                        else x.clone() for x in p)
        g = torch.arange(G)
        at = cnt[g, tile].long()
        lst[g, tile, at] = step
        sl[g, tile, at] = S
        cnt[:, tile] += 1
        past = torch.arange(lst.shape[-1]) >= cnt[..., None]
        lst = torch.where(past, torch.from_numpy(rng.integers(
            0, n_t, lst.shape).astype(np.int32)), lst)
        sl = torch.where(past, torch.from_numpy(rng.integers(
            0, S, sl.shape).astype(np.int32)), sl)
        return lst, cnt, sl
    return store, widen(plan, 0, jb), widen(plan_t, jb, 0)


def _compact_biased_bwd_inputs(G, H, N, D, Dv, metric, pack, rate, seed=0,
                               qk_scale=1.0, band=False):
    """`_biased_inputs` on the compact store with a key tile whose
    transposed walk is empty (snapshot 0, keys 64..127, icount = 0), the
    row tile with jcount = 0 and, in snapshot 1, fewer occupied tiles
    than the store's S (slots no walk visits); with ``band``, `band_mask`
    and `band_compact`'s store and walks (its empty key tile keys
    192..255 where N allows, a walked slot with no bit, walk entries past
    the counts) and a bias at its pairs. Union-like statistics as the
    hybrid backward passes them: the compact plain forward's lse1 and
    lse2 raised by a constant on live rows, lse2 = NEG_INF on dead rows
    (the merge's mark), delta2 = rowsum(dO out) and a residual delta1
    (N(0, 1) on live rows), and dO 0 on rows with no pair (C10).
    ``qk_scale`` scales q and k (but cosine metrics' unit rows) before
    the statistics are formed."""
    q, k, v, mask, bias, scale, seeds = _biased_inputs(G, H, N, D, Dv,
                                                       metric, seed)
    if metric not in FG._COSINE:
        q, k = qk_scale * q, qk_scale * k
    rng = np.random.default_rng(seed + 400)
    if band:
        mask = torch.from_numpy(band_mask(G, N, seed))
        bias = torch.from_numpy(rng.standard_normal((G, N, N)).astype(
            np.float32)) * (mask != 0)
        store, plan, plan_t = band_compact(mask, pack, seed)
        bias_store = FG.compact_values(mask, bias)
        bias_store = torch.cat([bias_store, torch.randn(
            (G, 1) + bias_store.shape[2:],
            generator=torch.Generator().manual_seed(seed))], 1)
    else:
        mask[0, :, FG.BLOCK_N:2 * FG.BLOCK_N] = 0
        if G > 1:
            mask[1, :, 2 * FG.BLOCK_N:] = 0
        bias = torch.where(mask != 0, bias, torch.zeros(()))
        store, plan = FG.compact_from_mask(mask, pack=pack)
        plan_t = FG.compact_transposed_plan(mask)
        assert int(plan_t[1][0, 1]) == 0
        bias_store = FG.compact_values(mask, bias)
    lse1 = FG.flash_lse1_compact_plain(q, k, store, *plan, metric, scale)
    live = lse1 < 1e29
    lse1 = torch.where(live, lse1 + 0.25, lse1)
    out, lse2 = FG.flash_biased_forward_compact_plain(
        q, k, v, store, bias_store, lse1, *plan, metric, scale, rate, seeds)
    lse2 = torch.where(live, lse2 + 0.1, torch.full_like(lse2, -1e30))
    do = torch.from_numpy(rng.standard_normal((G, H, N, Dv)).astype(
        np.float32)) * live[..., None]
    d1_rest = torch.from_numpy(rng.standard_normal((G, H, N)).astype(
        np.float32)) * live
    return (q, k, v, mask, store, bias_store, plan, plan_t, scale, seeds, do,
            lse1, lse2, (do * out).sum(-1), d1_rest)


def _compact_biased_bwd_vs_plain(cuda, G, H, N, D, Dv, metric, rate, pack,
                                 seed=0, band=False):
    """The row walk (B6c and B7a c, the residual's delta1 added between
    its passes), then the key walk (B7b c) on the union's delta1
    (`_biased_backward_compact`), against the compact plain parts: delta1,
    dB at the store's pairs, dq, dk, dv and dscale within TOL of the
    largest entry; dq zero on dead rows, dk and dv zero on the key tile
    with icount = 0; one launch each, and the union's delta1 away from
    the band's alone."""
    (q, k, v, mask, store, bias_store, plan, plan_t, scale, seeds, do, lse1,
     lse2, delta2, d1_rest) = (
        t.to(cuda) if torch.is_tensor(t) else tuple(p.to(cuda) for p in t)
        for t in _compact_biased_bwd_inputs(G, H, N, D, Dv, metric, pack,
                                            rate, seed, band=band))
    need = metric in FG.SCALED_METRICS
    rows = (do, lse1, lse2, delta2)
    before = [kern.launches for kern in COMPACT_BIASED_BWD]
    got = FG._biased_backward_compact(q, k, v, store, bias_store, *rows, plan,
                                      plan_t, metric, scale, rate, seeds,
                                      need, d1_rest)
    assert [kern.launches for kern in COMPACT_BIASED_BWD] == \
        [n + 1 for n in before]
    common = (q, k, v, store, bias_store, *rows)
    p_d1, p_db = FG.flash_biased_bwd_pre_compact_plain(
        *common, *plan, metric, scale, rate, seeds)
    d1u = p_d1 + d1_rest
    p_dq, p_dsc = FG.flash_biased_bwd_dq_compact_plain(
        *common, d1u, *plan, metric, scale, rate, seeds, need)
    p_dk, p_dv = FG.flash_biased_bwd_dkv_compact_plain(
        *common, d1u, *plan, metric, scale, rate, seeds)
    torch.cuda.synchronize()
    dq, dk, dv, db, dsc, d1 = got
    on = FG.store_pairs(store)
    for g, w in ((d1, d1u), (db[on], p_db[on]), (dq, p_dq), (dk, p_dk),
                 (dv, p_dv)) + (((dsc, p_dsc),) if need else ()):
        assert torch.isfinite(g).all()
        assert ((g - w).abs().max() / w.abs().max().clamp(min=1.0)).item() \
            <= TOL
    if not need:
        assert dsc is None
    assert db[on].abs().max() > 0
    assert (d1u - p_d1).abs().max() > 100 * TOL
    dead = (mask == 0).all(-1)[:, None, :].expand(G, H, N)
    assert torch.all(dq[dead] == 0)
    empty = slice(3 * FG.BLOCK_N, 4 * FG.BLOCK_N) if band \
        else slice(FG.BLOCK_N, 2 * FG.BLOCK_N)
    assert torch.all(dk[0, :, empty] == 0)
    assert torch.all(dv[0, :, empty] == 0)


@pytest.mark.gpu
@pytest.mark.parametrize("pack", [True, False])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("metric", FG.MXU_METRICS)
def test_compact_biased_backward_kernels_match_plain(metric, rate, pack,
                                                     cuda):
    """The compact row and key walks, bit and int8 stores: N=150 (not a
    tile multiple), D != Dv, dead rows (lse2 the merge's NEG_INF), a row
    tile with jcount = 0, a key tile with icount = 0, unvisited slots,
    per-head scales with dscale, both dropouts from per-snapshot seed
    pairs (negative included)."""
    _compact_biased_bwd_vs_plain(cuda, 2, 3, 150, 16, 8, metric, rate, pack)


@pytest.mark.gpu
@pytest.mark.parametrize("pack", [True, False])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("metric", FG.MXU_METRICS)
def test_compact_biased_backward_walks_band(metric, rate, pack, cuda):
    """The compact walks at `band_mask`'s cases over `band_compact`'s
    walks: N=330 (N % 16 = 10), ~1 pair a row a walked tile, a whole
    tile, a one-pair tile, a walked slot with no bit, walk entries past
    the counts, a key tile no row reaches, rows past 128 keys, dead rows
    (dO 0 there), both stores, both dropouts."""
    _compact_biased_bwd_vs_plain(cuda, 2, 4, 330, 16, 16, metric, rate, pack,
                                 seed=3, band=True)


@pytest.mark.gpu
@pytest.mark.parametrize("D,Dv", [(7, 3), (40, 72), (128, 128)])
def test_compact_biased_backward_head_dims(D, Dv, cuda):
    _compact_biased_bwd_vs_plain(cuda, 1, 2, 200, D, Dv, "gaussian_kernel",
                                 0.1, False, seed=1)


@pytest.mark.gpu
@pytest.mark.parametrize("pack", [True, False])
def test_compact_biased_backward_wide_heads_one_head(pack, cuda):
    """(D, Dv) = (128, 128) with H = 1 at the band's cases: the widest
    rows, one head a warp."""
    _compact_biased_bwd_vs_plain(cuda, 1, 1, 330, 128, 128, "euclidean",
                                 0.1, pack, seed=4, band=True)


@pytest.mark.gpu
@pytest.mark.parametrize("H", [1, 4, 8, 40])
def test_compact_biased_backward_fold(H, cuda):
    """Folds of 1, 4, 8 and 40 heads at the band's cases (past 32 heads
    the row walk launches once per head group, each adding into dB, and
    the key walk takes 8 heads a block)."""
    _compact_biased_bwd_vs_plain(cuda, 2, H, 330, 16, 16, "gaussian_kernel",
                                 0.1, True, seed=5, band=True)


@pytest.mark.gpu
@pytest.mark.parametrize("metric,rate", [("euclidean", 0.0),
                                         ("gaussian_kernel", 0.1)])
def test_compact_biased_backward_deterministic(metric, rate, cuda):
    """dq, dk, dv, dB (at the store's pairs), delta1 and dscale of the two
    compact walks are bit-identical over 20 repeated calls: neither sums
    with atomics."""
    (q, k, v, mask, store, bias_store, plan, plan_t, scale, seeds, do, lse1,
     lse2, delta2, d1_rest) = (
        t.to(cuda) if torch.is_tensor(t) else tuple(p.to(cuda) for p in t)
        for t in _compact_biased_bwd_inputs(2, 4, 1008, 16, 16, metric,
                                            True, rate, 3, band=True))
    need = metric in FG.SCALED_METRICS
    on = FG.store_pairs(store)
    first = None
    for _ in range(20):
        got = FG._biased_backward_compact(
            q, k, v, store, bias_store, do, lse1, lse2, delta2, plan, plan_t,
            metric, scale, rate, seeds, need, d1_rest)
        got = [t.clone() for t in got[:3]] + [got[3][on]] + [
            t.clone() for t in got[4:] if t is not None]
        if first is None:
            first = got
        for a, b in zip(got, first):
            assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("fault", ["jslot", "jcount", "islot", "ilist"])
def test_compact_biased_backward_bad_plan_raises_before_launch(fault, cuda):
    """The wrappers of the compact row and key walks check the walk's
    values: a jslot or islot past the store, a count past the walk's
    width or a tile past N raises ValueError on the host, and no kernel
    is launched."""
    (q, k, v, mask, store, bias_store, plan, plan_t, scale, seeds, do, lse1,
     lse2, delta2, _) = (
        t.to(cuda) if torch.is_tensor(t) else tuple(p.to(cuda) for p in t)
        for t in _compact_biased_bwd_inputs(1, 2, 150, 16, 16, "dot_product",
                                            True, 0.0))
    jl, jc, js = (p.clone() for p in plan)
    il, ic, isl = (p.clone() for p in plan_t)
    S = store.shape[1]
    if fault == "jslot":
        js[0, 0, 0] = S
    elif fault == "jcount":
        jc[0, 0] = jl.shape[-1] + 1
    elif fault == "islot":
        isl[0, 0, 0] = -1
    else:
        il[0, 0, 0] = 3
    common = (q, k, v, store, bias_store, do, lse1, lse2, delta2)
    before = [kern.launches for kern in COMPACT_BIASED_BWD]
    calls = [lambda: FG.flash_biased_bwd_key_compact_kernel(
        *common, lse1, il, ic, isl, "dot_product", scale, seeds, 0.0)] \
        if fault in ("islot", "ilist") else [
        lambda: FG.flash_biased_bwd_row_compact_kernel(
            *common, None, jl, jc, js, "dot_product", scale, seeds, 0.0,
            False),
        lambda: FG._biased_backward_compact(
            *common, (jl, jc, js), plan_t, "dot_product", scale, 0.0, seeds,
            False, lse1)]
    for call in calls:
        with pytest.raises(ValueError):
            call()
    assert [kern.launches for kern in COMPACT_BIASED_BWD] == before


def _hybrid_edge_step(cuda, metric, nan_fill=False, bf16=False):
    """One training step of the edge-feature hybrid model over a
    ``plan="hybrid"`` loader on the card (B4c, B5c and the compact row
    and key walks once per layer; no other kernel) and on the CPU (plain
    versions), from the same weights: the loss and every gradient, the
    edge embedding's and each layer's edge bias's included. With
    ``nan_fill`` the card's allocator is first filled with NaN, so that an
    output entry a kernel leaves unset and the model reads (a dB entry of
    the row walk, an out or lse2 row of B5c's walk) would show. With
    ``bf16`` the model takes ``bf16_matmul=True`` (the bf16 forms of the
    five kernels), its plain contractions pinned to fp32, and is held to
    `test_hybrid_edge_bf16_trainer_step_on_gpu_matches_cpu`'s gates for
    that case: the loss within the max gate, each gradient within
    `BF16_EDGE_GRAD` of its largest entry."""
    from tagan_torch.core.module import default_matmul_precision
    seqs = _hybrid_seqs(np.random.default_rng(9), 300, 2400, 2, 1, 4)
    cfg = pt.TAGANConfig(hidden_dim=32, num_heads=2, num_layers=2,
                         node_feature_dim=8, edge_feature_dim=4,
                         use_edge_features=True, output_dim=1,
                         loss_type="bce", dropout=0.0,
                         spatial_backend="hybrid", distance_metric=metric,
                         learnable_distance=metric == "gaussian_kernel",
                         bf16_matmul=bf16)
    kernels = COMPACT_BIASED_BF16 if bf16 else (
        FG.flash_lse1_compact_kernel, FG.flash_biased_fwd_compact_kernel) \
        + COMPACT_BIASED_BWD
    got = {}
    for dev in ("cuda", "cpu"):
        if dev == "cuda" and nan_fill:
            nan = torch.full((64 << 20,), float("nan"), device=cuda)
            del nan
        model = pt.TAGAN(cfg, device=dev,
                         generator=torch.Generator().manual_seed(0))
        if bf16:
            model.precision = lambda: default_matmul_precision("highest")
        loader = pt.TemporalGraphDataLoader(
            pt.TemporalGraphDataset(seqs, [1.0]), batch_size=1,
            dense_adj=False, plan="hybrid")
        batch, labels, _ = next(iter(loader))
        before = {k.name: k.launches for k in FG.KERNELS}
        loss = model(batch, labels).loss
        loss.backward()
        launched = {k.name: k.launches - before[k.name] for k in FG.KERNELS}
        want = {k.name: 0 for k in FG.KERNELS}
        if dev == "cuda":
            for kern in kernels:
                want[kern.name] = cfg.num_layers
        assert launched == want
        got[dev] = (loss.item(), {n: p.grad.cpu()
                                  for n, p in model.named_parameters()})
    assert got["cpu"][1]["edge_embedding.w"].abs().max() > 0
    if bf16:
        assert abs(got["cuda"][0] - got["cpu"][0]) <= BF16_MAX_TOL
        for name, g in got["cpu"][1].items():
            card = got["cuda"][1][name]
            assert torch.isfinite(card).all(), name
            if name in ("temporal_attention.k.b",
                        "temporal_attention.time_encoding.basis_proj.b",
                        "temporal_attention.time_q_proj.b"):
                continue    # zero in exact arithmetic: fp32 noise
            assert (card - g).abs().max() <= BF16_EDGE_GRAD * \
                g.abs().max(), name
        return
    assert abs(got["cuda"][0] - got["cpu"][0]) <= TOL
    scale = max(g.abs().max().item() for g in got["cpu"][1].values())
    for name, g in got["cpu"][1].items():
        assert torch.isfinite(got["cuda"][1][name]).all(), name
        assert (got["cuda"][1][name] - g).abs().max().item() <= TOL * scale, \
            name


@pytest.mark.gpu
@pytest.mark.parametrize("metric", ["euclidean", "gaussian_kernel"])
def test_hybrid_edge_trainer_step_on_gpu_matches_cpu(metric, cuda):
    """`_hybrid_edge_step`: one step on the card against the CPU."""
    _hybrid_edge_step(cuda, metric)


@pytest.mark.gpu
def test_compact_biased_backward_unset_db_never_read(cuda):
    """The compact row walk leaves dB unset off the store's pairs (its
    `torch.empty` never zeroed), and the bias store's backward reads it
    at band edges only: after the allocator's memory is filled with NaN,
    one step's gradients are finite and within TOL of the CPU's
    (`_hybrid_edge_step`)."""
    _hybrid_edge_step(cuda, "euclidean", nan_fill=True)


@pytest.mark.gpu
def test_hybrid_edge_bf16_step_over_nan_filled_memory(cuda):
    """`test_compact_biased_backward_unset_db_never_read` with
    ``bf16_matmul=True``: after the allocator's memory is filled with NaN,
    one step through the bf16 forms of B4c, B5c and the compact row and
    key walks gives finite gradients within the bf16 step's gates of the
    CPU's (`_hybrid_edge_step`). The bf16 row walk leaves dB unset off the
    store's pairs, and B5c's walk must set every out and lse2 entry the
    model reads."""
    _hybrid_edge_step(cuda, "euclidean", nan_fill=True, bf16=True)


# -- the bf16 forms (bf16_matmul=True) ----------------------------------------

# the bf16 forms against the plain bf16 versions, three gates over the
# plain version's largest entry: max error bf16-class (an fp32 sum in
# another order can flip a bf16 rounding, which moves one term by up to
# 2^-8 of itself), mean error fp32-class (a systematic slip moves every
# entry), and the witness: the mean distance from the fp32 result at least
# 100 times the mean error
BF16_MAX_TOL = 2e-3
BF16_MEAN_TOL = 1e-5
BF16_WITNESS = 100
BF16_KERNELS = (FG.flash_geometric_fwd_bf16_kernel,
                FG.flash_geometric_bwd_fused_bf16_kernel,
                FG.flash_geometric_bwd_dq_bf16_kernel,
                FG.flash_geometric_bwd_dkv_bf16_kernel)


def _bf16_gates(got, want, f32, witness=True, mean=True):
    m = want.abs().max().clamp(min=1e-30)
    err = (got - want).abs()
    mx, mn = (err.max() / m).item(), (err.mean() / m).item()
    assert torch.isfinite(got).all()
    assert mx <= BF16_MAX_TOL
    if mean:
        assert mn <= BF16_MEAN_TOL
    if witness:
        wit = ((f32 - want).abs().mean() / m).item()
        assert wit >= max(BF16_WITNESS * mn, BF16_MEAN_TOL)


def _bf16_vs_plain(cuda, G, H, N, D, Dv, metric, rate):
    q, k, v, mask, do, dl = (t.to(cuda) for t in _bwd_inputs(G, H, N, D, Dv))
    if metric in FG._COSINE:
        q, k = FG._l2_normalize(q), FG._l2_normalize(k)
    scale = torch.linspace(0.7, 2.0, H, device=cuda)
    seed = torch.tensor([-7, 12345][:G], dtype=torch.int32, device=cuda)
    need = metric in FG.SCALED_METRICS
    plan, plan_t = FG.make_block_plans_from_mask(mask)
    before = [k_.launches for k_ in BF16_KERNELS]
    out, lse = FG.flash_geometric_fwd(q, k, v, mask, *plan, metric=metric,
                                      scale=scale, seed=seed,
                                      dropout_rate=rate, bf16=True)
    p_out, p_lse = FG.flash_geometric_forward_plain(
        q, k, v, mask, metric, scale, rate, seed, True, plan)
    f_out, _ = FG.flash_geometric_forward_plain(q, k, v, mask, metric, scale,
                                                rate, seed)
    torch.cuda.synchronize()
    dead = (mask == 0).all(-1)[:, None, :].expand(G, H, N)
    assert torch.all(out[dead] == 0) and torch.all(lse[dead] == FG.LSE_DEAD)
    _bf16_gates(out[~dead], p_out[~dead], f_out[~dead])
    _bf16_gates(lse[~dead], p_lse[~dead], p_lse[~dead], witness=False)
    args = (q, k, v, mask, p_out, p_lse, do)
    kw = dict(metric=metric, scale=scale, plan=plan, plan_t=plan_t,
              seed=seed, dropout_rate=rate, need_dscale=need, dlse=dl)
    want = FG.flash_geometric_backward_plain(*args, metric, scale, rate, seed,
                                             need, dl, True)
    f32 = FG.flash_geometric_backward_plain(*args, metric, scale, rate, seed,
                                            need, dl)
    for fused in (True, False):
        got = FG.flash_geometric_attention_bwd(*args, fused=fused, bf16=True,
                                               **kw)
        torch.cuda.synchronize()
        for i, (g, w, f) in enumerate(zip(got, want, f32)):
            _bf16_gates(g, w, f, witness=i < 3, mean=i < 3)
    assert [k_.launches - b for k_, b in zip(BF16_KERNELS, before)] \
        == [1, 1, 1, 1]


@pytest.mark.gpu
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("metric", FG.MXU_METRICS)
def test_bf16_kernels_match_plain(metric, rate, cuda):
    """B1, B2, B3a and B3b in their bf16 forms against the plain bf16
    versions (the forward walking the same plan): N=150, D != Dv, dead
    rows, an empty query tile and key strip, per-head scales with their
    gradient (the max gate alone: dscale is a sum of many terms), dropout
    and an lse cotangent."""
    _bf16_vs_plain(cuda, 2, 3, 150, 16, 8, metric, rate)


@pytest.mark.gpu
@pytest.mark.parametrize("metric", ["scaled_dot_product", "gaussian_kernel"])
@pytest.mark.parametrize("D,Dv", [(8, 8), (12, 12), (40, 72), (128, 128)])
def test_bf16_kernel_head_dims(D, Dv, metric, cuda):
    """Head dims whose sqrt is not a power of two (the scaled dot's factor
    comes after the rounded product), a multi-lane width, and the widest
    (128, 128), where rounded copies of the q and k tiles beside the
    fp32 tiles would pass the 227 KB of shared memory a block may
    have."""
    _bf16_vs_plain(cuda, 1, 2, 200, D, Dv, metric, 0.1)


@pytest.mark.gpu
@pytest.mark.parametrize("fused", [True, False])
def test_bf16_autograd_on_gpu_matches_cpu(fused, cuda, monkeypatch):
    """flash_geometric_attention(bf16=True) under autograd: the bf16 forms
    on the card against the plain bf16 versions on the CPU, a learnable
    scale, dropout; the CPU's fp32 gradients the witness."""
    monkeypatch.setattr(FG, "FUSED_BWD", fused)
    q, k, v, mask, do, _ = _bwd_inputs(2, 2, 130, 16, 16)
    grads = {}
    for dev, bf16 in (("cuda", True), ("cpu", True), ("cpu", False)):
        leaves = [t.to(dev).clone().requires_grad_() for t in (q, k, v)]
        sigma = torch.tensor([0.8, 1.5], device=dev, requires_grad=True)
        out = FG.flash_geometric_attention(
            *leaves, mask.to(dev), metric="gaussian_kernel",
            scale_param=sigma, dropout_rate=0.1,
            dropout_seed=torch.tensor([3, 4], dtype=torch.int32), bf16=bf16)
        (out * do.to(dev)).sum().backward()
        grads[dev, bf16] = [t.grad.cpu() for t in leaves + [sigma]]
    for i, (g, w, f) in enumerate(zip(grads["cuda", True], grads["cpu", True],
                                      grads["cpu", False])):
        _bf16_gates(g, w, f, witness=i < 3, mean=i < 3)


def _bf16_model_cfg(**kw):
    return pt.TAGANConfig(**{**dict(
        hidden_dim=32, num_heads=2, num_layers=2, node_feature_dim=8,
        output_dim=1, loss_type="bce", dropout=0.0, spatial_backend="flash",
        bf16_matmul=True), **kw})


@pytest.mark.gpu
@pytest.mark.parametrize("fused", [True, False])
def test_bf16_trainer_step_on_gpu_matches_cpu(fused, cuda, monkeypatch):
    """One TAGANTrainer step of the bf16 flash model, card against CPU,
    the bf16 forms launched once per layer (the fp32 forms never). With
    the plain contractions pinned to fp32 the card's kernels alone differ
    from the CPU's plain versions: each gradient within the max gate.
    With every contraction at bf16 (the model as it runs) a rounding
    flipped by an fp32 sum order moves its value by 2^-8 and the
    roundings it feeds flip in turn: bf16-class tolerances (the loss
    within 2e-2, each gradient within 1e-1 of its largest entry)."""
    from tagan_torch.core.module import default_matmul_precision
    monkeypatch.setattr(FG, "FUSED_BWD", fused)
    rng = np.random.default_rng(4)
    n, e, T = 100, 800, 3
    seqs = [[{"x": rng.standard_normal((n, 8)).astype(np.float32),
              "edge_index": rng.integers(0, n, (2, e)),
              "node_ids": np.arange(n), "timestep": float(t)}
             for t in range(T)] for _ in range(2)]
    cfg = _bf16_model_cfg(distance_metric="gaussian_kernel",
                          learnable_distance=True)
    ds = pt.TemporalGraphDataset(seqs, [1.0, 0.0])
    batch, labels, smask = next(iter(pt.TemporalGraphDataLoader(
        ds, batch_size=2, dense_adj=False)))
    for contractions, loss_tol, grad_tol in (("highest", BF16_MAX_TOL,
                                              BF16_MAX_TOL),
                                             (None, 2e-2, 1e-1)):
        got = {}
        for dev in ("cuda", "cpu"):
            model = pt.TAGAN(cfg, device=dev,
                             generator=torch.Generator().manual_seed(0))
            if contractions is not None:
                model.precision = \
                    lambda: default_matmul_precision(contractions)
            tr = pt.TAGANTrainer(model, pt.ExperimentConfig(model=cfg))
            before = {k.name: k.launches for k in FG.KERNELS}
            loss, _ = tr._loss(batch, labels, smask, True)
            loss.backward()
            launched = {k.name: k.launches - before[k.name]
                        for k in FG.KERNELS}
            got[dev] = (loss.item(), {n_: p.grad.detach().cpu().clone()
                                      for n_, p in model.named_parameters()})
            if dev == "cuda":
                want = {k.name: 0 for k in FG.KERNELS}
                want[FG.flash_geometric_fwd_bf16_kernel.name] = 2
                for kern in BF16_KERNELS[1:2] if fused else BF16_KERNELS[2:]:
                    want[kern.name] = 2
                assert launched == want
        assert abs(got["cuda"][0] - got["cpu"][0]) <= loss_tol
        for name, g in got["cpu"][1].items():
            if name in ("temporal_attention.k.b",
                        "temporal_attention.time_encoding.basis_proj.b",
                        "temporal_attention.time_q_proj.b"):
                continue    # zero in exact arithmetic: fp32 noise
            card = got["cuda"][1][name]
            assert torch.isfinite(card).all(), name
            assert (card - g).abs().max() <= grad_tol * g.abs().max(), name


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["lse1", "fwd", "row", "key"])
def test_bf16_refused_before_launch(kernel, cuda):
    """Every bf16 form has an entry now, and the edge-feature hybrid bf16
    model builds on the card; what is refused before any launch is a bad
    walk: a jslot (islot) past the store raises ValueError on the host at
    each compact edge-biased bf16 entry (B4c and B5c through their public
    entries, the bf16 row walk (B6c and B7a c) and key walk (B7b c) at
    their wrappers), and no kernel is launched."""
    (q, k, v, mask, store, bias_store, plan, plan_t, scale, seeds, do, lse1,
     lse2, delta2, _) = (
        t.to(cuda) if torch.is_tensor(t) else tuple(p.to(cuda) for p in t)
        for t in _compact_biased_bwd_inputs(1, 2, 150, 16, 16, "dot_product",
                                            True, 0.0))
    pt.TAGAN(_bf16_model_cfg(spatial_backend="hybrid",
                             use_edge_features=True, edge_feature_dim=4),
             device=cuda)
    jl, jc, js = (p.clone() for p in plan)
    il, ic, isl = (p.clone() for p in plan_t)
    js[0, 0, 0] = isl[0, 0, 0] = store.shape[1]
    common = (q, k, v, store, bias_store, do, lse1, lse2, delta2)
    calls = {
        "lse1": lambda: FG.flash_lse1_compact(
            q, k, store, jl, jc, js, metric="dot_product", bf16=True),
        "fwd": lambda: FG.flash_biased_fwd_compact(
            q, k, v, store, bias_store, lse1, jl, jc, js,
            metric="dot_product", bf16=True),
        "row": lambda: FG.flash_biased_bwd_row_compact_bf16_kernel(
            *common, lse1, jl, jc, js, "dot_product", scale, seeds, 0.0,
            False),
        "key": lambda: FG.flash_biased_bwd_key_compact_bf16_kernel(
            *common, lse1, il, ic, isl, "dot_product", scale, seeds, 0.0)}
    before = {k_.name: k_.launches for k_ in FG.KERNELS}
    with pytest.raises(ValueError, match="jslot"):
        calls[kernel]()
    assert {k_.name: k_.launches for k_ in FG.KERNELS} == before


# -- the compact bf16 forms (B1c, B3a c, B3b c) --------------------------------

COMPACT_BF16 = (FG.flash_geometric_fwd_compact_bf16_kernel,
                FG.flash_geometric_bwd_dq_compact_bf16_kernel,
                FG.flash_geometric_bwd_dkv_compact_bf16_kernel)


def _compact_bf16_vs_plain(cuda, G, H, N, D, Dv, metric, rate, pack, seed=0):
    """B1c, B3a c and B3b c in their bf16 forms through the public entries
    (``flash_geometric_fwd_compact``, ``flash_geometric_attention_bwd``
    with 3-tuple plans and bf16=True) on the dense bf16 forms' inputs
    (`_bwd_inputs`) in a compact store, against the compact plain bf16
    versions under the bf16 gates, the plain fp32 versions the witness:
    out and lse (dead rows exactly), dq, dk, dv (dq zero on dead rows,
    dk and dv zero on the key tile with icount = 0) and dscale; each
    compact bf16 entry launched once and nothing else."""
    q, k, v, mask, do, dlse = (t.to(cuda) for t in _bwd_inputs(
        G, H, N, D, Dv, seed))
    if metric in FG._COSINE:
        q, k = FG._l2_normalize(q), FG._l2_normalize(k)
    scale = torch.linspace(0.7, 2.0, H, device=cuda)
    seed1 = torch.tensor([-7, 12345][:G], dtype=torch.int32, device=cuda)
    store, plan = FG.compact_from_mask(mask, pack=pack)
    plan_t = FG.compact_transposed_plan(mask)
    need = metric in FG.SCALED_METRICS
    before = {k_.name: k_.launches for k_ in FG.KERNELS}
    out, lse = FG.flash_geometric_fwd_compact(
        q, k, v, store, *plan, metric=metric, scale=scale, seed=seed1,
        dropout_rate=rate, bf16=True)
    fwd = (q, k, v, store, *plan, metric, scale, rate, seed1)
    p_out, p_lse = FG.flash_geometric_forward_compact_plain(*fwd, bf16=True)
    f_out, _ = FG.flash_geometric_forward_compact_plain(*fwd)
    torch.cuda.synchronize()
    dead = (mask == 0).all(-1)[:, None, :].expand(G, H, N)
    assert torch.all(out[dead] == 0) and torch.all(lse[dead] == FG.LSE_DEAD)
    _bf16_gates(out[~dead], p_out[~dead], f_out[~dead])
    _bf16_gates(lse[~dead], p_lse[~dead], p_lse[~dead], witness=False)
    args = (q, k, v, store, p_out, p_lse, do)
    got = FG.flash_geometric_attention_bwd(
        *args, metric=metric, scale=scale, plan=plan, plan_t=plan_t,
        seed=seed1, dropout_rate=rate, need_dscale=need, dlse=dlse,
        bf16=True)
    torch.cuda.synchronize()
    rest = (*plan, metric, scale, rate, seed1, need, dlse)
    want = FG.flash_geometric_backward_compact_plain(*args, *rest, bf16=True)
    f32 = FG.flash_geometric_backward_compact_plain(*args, *rest)
    for i, (g, w, f) in enumerate(zip(got, want, f32)):
        _bf16_gates(g, w, f, witness=i < 3, mean=i < 3)
    assert torch.all(got[0][dead] == 0)
    assert torch.all(got[1][0, :, FG.BLOCK_N:2 * FG.BLOCK_N] == 0)
    assert torch.all(got[2][0, :, FG.BLOCK_N:2 * FG.BLOCK_N] == 0)
    launched = {k_.name: k_.launches - before[k_.name] for k_ in FG.KERNELS}
    expect = {k_.name: 0 for k_ in FG.KERNELS}
    expect.update({k_.name: 1 for k_ in COMPACT_BF16})
    assert launched == expect


@pytest.mark.gpu
@pytest.mark.parametrize("pack", [True, False])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("metric", FG.MXU_METRICS)
def test_compact_bf16_kernels_match_plain(metric, rate, pack, cuda):
    """B1c, B3a c and B3b c's bf16 forms, bit and int8 stores: N=150 (not
    a tile multiple), D != Dv, dead rows, a row tile with jcount = 0 and
    a key tile with icount = 0, per-head scales with their gradient (the
    max gate alone), dropout, an lse cotangent."""
    _compact_bf16_vs_plain(cuda, 2, 3, 150, 16, 8, metric, rate, pack)


@pytest.mark.gpu
@pytest.mark.parametrize("pack", [True, False])
@pytest.mark.parametrize("D,Dv", [(16, 16), (8, 8), (12, 12), (7, 3),
                                  (128, 128)])
def test_compact_bf16_kernel_head_dims(D, Dv, pack, cuda):
    """Head dims whose sqrt is not a power of two, D != Dv, and the
    widest, (128, 128), where the compact backward's tile-row words sit
    past the dense tiles in shared memory."""
    _compact_bf16_vs_plain(cuda, 1, 2, 200, D, Dv, "gaussian_kernel", 0.1,
                           pack, seed=1)


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["fwd", "dq", "dkv"])
def test_compact_bf16_bad_jslot_raises_before_launch(kernel, cuda):
    """A jslot (islot) past the store raises ValueError on the host at
    each compact bf16 entry, and no kernel is launched."""
    q, k, v, mask, store, plan, plan_t, scale, seed1, do, dlse = (
        t.to(cuda) if torch.is_tensor(t) else tuple(p.to(cuda) for p in t)
        for t in _compact_bwd_inputs(1, 2, 150, 16, 16, "dot_product", True))
    jl, jc, js = (p.clone() for p in plan)
    il, ic, isl = (p.clone() for p in plan_t)
    js[0, 0, 0] = isl[0, 0, 0] = store.shape[1]
    lse = torch.zeros(1, 2, 150, device=cuda)
    before = {k_.name: k_.launches for k_ in FG.KERNELS}
    with pytest.raises(ValueError, match="jslot"):
        if kernel == "fwd":
            FG.flash_geometric_fwd_compact(q, k, v, store, jl, jc, js,
                                           metric="dot_product", bf16=True)
        elif kernel == "dq":
            FG.flash_geometric_bwd_dq_compact_bf16_kernel(
                q, k, v, store, do, lse, lse, jl, jc, js, "dot_product",
                scale, seed1, 0.0, False)
        else:
            FG.flash_geometric_bwd_dkv_compact_bf16_kernel(
                q, k, v, store, do, lse, lse, il, ic, isl, "dot_product",
                scale, seed1, 0.0)
    assert {k_.name: k_.launches for k_ in FG.KERNELS} == before


@pytest.mark.gpu
def test_hybrid_bf16_trainer_step_on_gpu_matches_cpu(cuda):
    """One TAGANTrainer step of the 100-node hybrid model with
    bf16_matmul=True over a ``plan="hybrid"`` loader, card against CPU:
    the bf16 forms of B1c, B3a c and B3b c launched once per layer,
    nothing else. With the plain contractions pinned to fp32 the card's
    kernels alone differ from the CPU's plain versions: the loss and
    each gradient within the max gate (2e-3); with every contraction at
    bf16 within bf16-class tolerances (the loss 2e-2, each gradient 1e-1
    of its largest entry), as in the flash model's test above."""
    from tagan_torch.core.module import default_matmul_precision
    seqs = _hybrid_seqs(np.random.default_rng(5), 100, 800, 3, 2, 0)
    cfg = _bf16_model_cfg(spatial_backend="hybrid",
                          distance_metric="gaussian_kernel",
                          learnable_distance=True)
    batch, labels, smask = next(iter(pt.TemporalGraphDataLoader(
        pt.TemporalGraphDataset(seqs, [1.0, 0.0]), batch_size=2,
        dense_adj=False, plan="hybrid")))
    want = {k_.name: 0 for k_ in FG.KERNELS}
    want.update({k_.name: cfg.num_layers for k_ in COMPACT_BF16})
    for contractions, loss_tol, grad_tol in (("highest", BF16_MAX_TOL,
                                              BF16_MAX_TOL),
                                             (None, 2e-2, 1e-1)):
        got = {}
        for dev in ("cuda", "cpu"):
            model = pt.TAGAN(cfg, device=dev,
                             generator=torch.Generator().manual_seed(0))
            if contractions is not None:
                model.precision = \
                    lambda: default_matmul_precision(contractions)
            tr = pt.TAGANTrainer(model, pt.ExperimentConfig(model=cfg))
            before = {k_.name: k_.launches for k_ in FG.KERNELS}
            loss, _ = tr._loss(batch, labels, smask, True)
            loss.backward()
            launched = {k_.name: k_.launches - before[k_.name]
                        for k_ in FG.KERNELS}
            got[dev] = (loss.item(), {n_: p.grad.detach().cpu().clone()
                                      for n_, p in model.named_parameters()})
            if dev == "cuda":
                assert launched == want
        assert abs(got["cuda"][0] - got["cpu"][0]) <= loss_tol
        for name, g in got["cpu"][1].items():
            if name in ("temporal_attention.k.b",
                        "temporal_attention.time_encoding.basis_proj.b",
                        "temporal_attention.time_q_proj.b"):
                continue    # zero in exact arithmetic: fp32 noise
            card = got["cuda"][1][name]
            assert torch.isfinite(card).all(), name
            assert (card - g).abs().max() <= grad_tol * g.abs().max(), name


# -- the edge-biased bf16 forms (B4, B5, B6, B7a, B7b) --------------------------

# B4 and B5 bf16, then the row walk (B6 and B7a bf16) and the key walk (B7b
# bf16)
BIASED_BF16 = (FG.flash_lse1_bf16_kernel, FG.flash_biased_fwd_bf16_kernel,
               FG.flash_biased_bwd_row_bf16_kernel,
               FG.flash_biased_bwd_key_bf16_kernel)


def _biased_bf16_vs_plain(cuda, G, H, N, D, Dv, metric, rate, seed=0):
    """B4, B5, B6, B7a and B7b in their bf16 forms through the public
    entries (``flash_biased_fwd``, ``flash_biased_attention_bwd`` with
    bf16=True) against the plain bf16 versions under the bf16 gates, the
    plain fp32 versions the witness: lse1, out and lse2 (B5 on the
    kernel's lse1, walking the same plan), dq, dk, dv, dB at the mask's
    pairs (the row walk writes no other) and dscale; dead rows exactly;
    each bf16 kernel launched once and nothing else."""
    args = [t.to(cuda) for t in _biased_inputs(G, H, N, D, Dv, metric, seed)]
    q, k, v, mask, bias, scale, seeds = args
    mask[0, :, FG.BLOCK_N:2 * FG.BLOCK_N] = 0
    bias = torch.where(mask != 0, bias, torch.zeros_like(bias))
    do = torch.from_numpy(np.random.default_rng(seed + 300).standard_normal(
        (G, H, N, Dv)).astype(np.float32)).to(cuda)
    need = metric in FG.SCALED_METRICS
    plan, plan_t = FG.make_block_plans_from_mask(mask)
    before = {k_.name: k_.launches for k_ in FG.KERNELS}
    out, lse1, lse2 = FG.flash_biased_fwd(
        q, k, v, mask, bias, *plan, metric=metric, scale=scale,
        dropout_rate=rate, seeds=seeds, bf16=True)
    dead = (mask == 0).all(-1)[:, None, :].expand(G, H, N)
    for t in (lse1, lse2):
        assert torch.all(t[dead] == FG.LSE_DEAD)
    assert torch.all(out[dead] == 0)
    p_lse1 = FG.flash_lse1_plain(q, k, mask, metric, scale, True)
    _bf16_gates(lse1[~dead], p_lse1[~dead], p_lse1[~dead], witness=False)
    fwd = (q, k, v, mask, bias, lse1, metric, scale, rate, seeds)
    p_out, p_lse2 = FG.flash_biased_forward_plain(*fwd, True, plan)
    f_out, _ = FG.flash_biased_forward_plain(*fwd)
    _bf16_gates(out[~dead], p_out[~dead], f_out[~dead])
    _bf16_gates(lse2[~dead], p_lse2[~dead], p_lse2[~dead], witness=False)
    stats = (q, k, v, mask, bias, p_out, p_lse1, p_lse2, do, metric, scale,
             rate, seeds, need)
    got = FG.flash_biased_attention_bwd(
        q, k, v, bias, mask, p_out, p_lse1, p_lse2, do, metric=metric,
        scale=scale, plan=plan, plan_t=plan_t, seeds=seeds, dropout_rate=rate,
        need_dscale=need, bf16=True)
    torch.cuda.synchronize()
    want = FG.flash_biased_backward_plain(*stats, bf16=True)
    f32 = FG.flash_biased_backward_plain(*stats)
    for g, w, f in zip(got[:3], want[:3], f32[:3]):
        _bf16_gates(g, w, f)
    on = mask != 0
    _bf16_gates(got[3][on], want[3][on], f32[3][on])
    if need:
        _bf16_gates(got[4], want[4], f32[4], witness=False, mean=False)
    launched = {k_.name: k_.launches - before[k_.name] for k_ in FG.KERNELS}
    expect = {k_.name: 0 for k_ in FG.KERNELS}
    expect.update({k_.name: 1 for k_ in BIASED_BF16})
    assert launched == expect


@pytest.mark.gpu
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("metric", FG.MXU_METRICS)
def test_biased_bf16_kernels_match_plain(metric, rate, cuda):
    """B4-B7b's bf16 forms: N=150 (not a tile multiple), D != Dv, dead
    rows, an empty query tile and key strip, per-head scales with their
    gradient, both dropouts, a bias with duplicate-edge sums."""
    _biased_bf16_vs_plain(cuda, 2, 3, 150, 16, 8, metric, rate)


@pytest.mark.gpu
@pytest.mark.parametrize("metric", ["scaled_dot_product", "gaussian_kernel"])
@pytest.mark.parametrize("D,Dv", [(16, 16), (8, 8), (12, 12), (7, 3),
                                  (128, 128)])
def test_biased_bf16_kernel_head_dims(D, Dv, metric, cuda):
    """Head dims whose sqrt is not a power of two, D != Dv, and the
    widest, whose tiles the bf16 forms round in place."""
    _biased_bf16_vs_plain(cuda, 1, 2, 200, D, Dv, metric, 0.1, seed=1)


@pytest.mark.gpu
def test_biased_bf16_autograd_on_gpu_matches_cpu(cuda):
    """flash_geometric_attention(bias=..., bf16=True) under autograd: the
    bf16 forms on the card against the plain bf16 versions on the CPU,
    with a learnable sigma and the bias requiring grad (read at the
    mask's pairs), dropout on; the CPU's fp32 gradients the witness."""
    q, k, v, mask, bias, _, _ = _biased_inputs(2, 2, 130, 16, 16,
                                               "gaussian_kernel")
    do = torch.from_numpy(np.random.default_rng(9).standard_normal(
        v.shape).astype(np.float32))
    on = mask != 0
    grads = {}
    for dev, bf16 in (("cuda", True), ("cpu", True), ("cpu", False)):
        leaves = [t.to(dev).clone().requires_grad_() for t in (q, k, v, bias)]
        sigma = torch.tensor([0.8, 1.5], device=dev, requires_grad=True)
        out = FG.flash_geometric_attention(
            *leaves[:3], mask.to(dev), metric="gaussian_kernel",
            scale_param=sigma, dropout_rate=0.1,
            dropout_seed=torch.tensor([3, 4], dtype=torch.int32),
            bias=leaves[3], bf16=bf16)
        (out * do.to(dev)).sum().backward()
        grads[dev, bf16] = [t.grad.cpu() for t in leaves[:3]] + [
            leaves[3].grad.cpu()[on], sigma.grad.cpu()]
    for i, (g, w, f) in enumerate(zip(grads["cuda", True], grads["cpu", True],
                                      grads["cpu", False])):
        _bf16_gates(g, w, f, witness=i < 4, mean=i < 4)


# the edge-feature bf16 model with its kernels alone at bf16, card against
# CPU: a bf16 rounding that an fp32 sum order flips (2^-8 of one term)
# reaches the gradients through the first softmax's chain ds = w1 (dw1 -
# delta1), whose terms cancel, so layer 0's q and k weights (gradients
# ~1e-4 of the edge biases') carry a larger share of it: each gradient
# within 1e-2 of its largest entry (measured 4.9e-3 at most; 3.1e-3 for
# the plain bf16 model on the same graphs; the card's fp32 model stands
# 2e-6 from the CPU's)
BF16_EDGE_GRAD = 1e-2


@pytest.mark.gpu
def test_edge_bf16_trainer_step_on_gpu_matches_cpu(cuda):
    """One TAGANTrainer step of the edge-feature flash model with
    bf16_matmul=True, card against CPU: the bf16 forms of B4, B5, B6, B7a
    and B7b launched once per layer, nothing else. With the plain
    contractions pinned to fp32 the loss within the max gate and each
    gradient within `BF16_EDGE_GRAD`; with every contraction at bf16
    within bf16-class tolerances (the loss 2e-2, each gradient 1e-1 of
    its largest entry), as in the plain bf16 model's test above; the edge
    parameters' gradients non-zero."""
    from tagan_torch.core.module import default_matmul_precision
    seqs = _edge_seqs(np.random.default_rng(7), 100, 800, 3, 2)
    cfg = _bf16_model_cfg(edge_feature_dim=4, use_edge_features=True,
                          distance_metric="gaussian_kernel",
                          learnable_distance=True)
    batch, labels, smask = next(iter(pt.TemporalGraphDataLoader(
        pt.TemporalGraphDataset(seqs, [1.0, 0.0]), batch_size=2,
        dense_adj=False)))
    want = {k_.name: 0 for k_ in FG.KERNELS}
    want.update({k_.name: cfg.num_layers for k_ in BIASED_BF16})
    for contractions, loss_tol, grad_tol in (("highest", BF16_MAX_TOL,
                                              BF16_EDGE_GRAD),
                                             (None, 2e-2, 1e-1)):
        got = {}
        for dev in ("cuda", "cpu"):
            model = pt.TAGAN(cfg, device=dev,
                             generator=torch.Generator().manual_seed(0))
            if contractions is not None:
                model.precision = \
                    lambda: default_matmul_precision(contractions)
            tr = pt.TAGANTrainer(model, pt.ExperimentConfig(model=cfg))
            before = {k_.name: k_.launches for k_ in FG.KERNELS}
            loss, _ = tr._loss(batch, labels, smask, True)
            loss.backward()
            launched = {k_.name: k_.launches - before[k_.name]
                        for k_ in FG.KERNELS}
            got[dev] = (loss.item(), {n_: p.grad.detach().cpu().clone()
                                      for n_, p in model.named_parameters()})
            if dev == "cuda":
                assert launched == want
        assert abs(got["cuda"][0] - got["cpu"][0]) <= loss_tol
        for name in ("edge_embedding.w",
                     "geometric_layers.layer_0.edge_bias.w",
                     "geometric_layers.layer_1.edge_bias.w"):
            assert got["cuda"][1][name].abs().max() > 0, name
        for name, g in got["cpu"][1].items():
            if name in ("temporal_attention.k.b",
                        "temporal_attention.time_encoding.basis_proj.b",
                        "temporal_attention.time_q_proj.b"):
                continue    # zero in exact arithmetic: fp32 noise
            card = got["cuda"][1][name]
            assert torch.isfinite(card).all(), name
            assert (card - g).abs().max() <= grad_tol * g.abs().max(), name


# -- the compact edge-biased bf16 forms (B4c, B5c, B6c, B7a c, B7b c) ----------

# q and k at half the fp32 tests' N(0, 1) for the bf16 gates. At N(0, 1) and
# head dim 16 the raw dot product's and the squared distance's scores span
# tens: a 1e-7 relative change of q and k (what an fp32 sum in another
# order makes) flips bf16 roundings of chain weights that carry most of a
# row's dq or dk, and moves the plain bf16 version itself past the max
# gate; and rbf's scores saturate, so its bf16 dq and dk stand under the
# witness's floor from the fp32 ones. At half scale neither happens
BF16_QK_SCALE = 0.5
COMPACT_BIASED_BF16 = (FG.flash_lse1_compact_bf16_kernel,
                       FG.flash_biased_fwd_compact_bf16_kernel,
                       FG.flash_biased_bwd_row_compact_bf16_kernel,
                       FG.flash_biased_bwd_key_compact_bf16_kernel)


@contextlib.contextmanager
def nan_empty():
    """``torch.empty`` returning NaN-filled float tensors, so that an
    output entry a kernel leaves unset reads NaN (chip_smoke.py's 2k
    takes it too)."""
    real = torch.empty

    def empty(*a, **kw):
        t = real(*a, **kw)
        return t.fill_(float("nan")) if t.is_floating_point() else t
    torch.empty = empty
    try:
        yield
    finally:
        torch.empty = real


def _compact_biased_bf16_inputs(cuda, G, H, N, D, Dv, metric, pack, rate,
                                seed=0, band=False):
    return tuple(
        t.to(cuda) if torch.is_tensor(t) else tuple(p.to(cuda) for p in t)
        for t in _compact_biased_bwd_inputs(G, H, N, D, Dv, metric, pack,
                                            rate, seed, BF16_QK_SCALE,
                                            band=band))


def _compact_biased_bf16_vs_plain(cuda, G, H, N, D, Dv, metric, rate, pack,
                                  seed=0, band=False):
    """B4c and B5c in their bf16 forms through the public entries
    (``flash_lse1_compact``, ``flash_biased_fwd_compact`` with bf16=True),
    then the bf16 row walk (B6c and B7a c, the residual's delta1 added
    between its passes) and key walk (B7b c) (``_biased_backward_compact``
    with bf16, on `_compact_biased_bwd_inputs`' union-like statistics, at
    `band_mask`'s cases with ``band``), against the compact plain bf16
    versions under the bf16 gates, the plain fp32 versions the witness:
    lse1, out and lse2 (dead rows exactly), delta1, dB at the store's
    pairs, dq (0 on dead rows), dk and dv (0 on the key tile no row
    reaches) and dscale (the max gate alone); the backward's outputs
    allocated NaN-filled: every entry set but dB's off the store's pairs,
    which stay NaN (the walks write and read nothing there); each of the
    four entries launched once and nothing else."""
    (q, k, v, mask, store, bias_store, plan, plan_t, scale, seeds, do, lse1,
     lse2, delta2, d1_rest) = _compact_biased_bf16_inputs(
        cuda, G, H, N, D, Dv, metric, pack, rate, seed, band)
    need = metric in FG.SCALED_METRICS
    before = {k_.name: k_.launches for k_ in FG.KERNELS}
    l1 = FG.flash_lse1_compact(q, k, store, *plan, metric=metric,
                               scale=scale, bf16=True)
    out, l2 = FG.flash_biased_fwd_compact(
        q, k, v, store, bias_store, lse1, *plan, metric=metric, scale=scale,
        dropout_rate=rate, seeds=seeds, bf16=True)
    with nan_empty():
        got = FG._biased_backward_compact(
            q, k, v, store, bias_store, do, lse1, lse2, delta2, plan, plan_t,
            metric, scale, rate, seeds, need, d1_rest, True)
    torch.cuda.synchronize()
    launched = {k_.name: k_.launches - before[k_.name] for k_ in FG.KERNELS}
    expect = {k_.name: 0 for k_ in FG.KERNELS}
    expect.update({k_.name: 1 for k_ in COMPACT_BIASED_BF16})
    assert launched == expect
    plain = {}
    for bf16 in (True, False):
        p_l1 = FG.flash_lse1_compact_plain(q, k, store, *plan, metric, scale,
                                           bf16)
        p_out, p_l2 = FG.flash_biased_forward_compact_plain(
            q, k, v, store, bias_store, lse1, *plan, metric, scale, rate,
            seeds, bf16)
        common = (q, k, v, store, bias_store, do, lse1, lse2, delta2)
        p_d1, p_db = FG.flash_biased_bwd_pre_compact_plain(
            *common, *plan, metric, scale, rate, seeds, bf16)
        d1u = p_d1 + d1_rest
        p_dq, p_dsc = FG.flash_biased_bwd_dq_compact_plain(
            *common, d1u, *plan, metric, scale, rate, seeds, need, bf16)
        p_dk, p_dv = FG.flash_biased_bwd_dkv_compact_plain(
            *common, d1u, *plan, metric, scale, rate, seeds, bf16)
        plain[bf16] = (p_l1, p_out, p_l2, d1u, p_db, p_dq, p_dsc, p_dk, p_dv)
    (p_l1, p_out, p_l2, p_d1, p_db, p_dq, p_dsc, p_dk,
     p_dv), f32 = plain[True], plain[False]
    dead = (mask == 0).all(-1)[:, None, :].expand(G, H, N)
    assert torch.all(l1[dead] == FG.LSE_DEAD)
    assert torch.all(out[dead] == 0) and torch.all(l2[dead] == FG.LSE_DEAD)
    _bf16_gates(l1[~dead], p_l1[~dead], f32[0][~dead], witness=False)
    _bf16_gates(out[~dead], p_out[~dead], f32[1][~dead])
    _bf16_gates(l2[~dead], p_l2[~dead], f32[2][~dead], witness=False)
    dq, dk, dv, db, dsc, d1 = got
    on = FG.store_pairs(store)
    assert torch.isnan(db[~on]).all()
    for t in (d1, dq, dk, dv) + ((dsc,) if need else ()):
        assert torch.isfinite(t).all()
    _bf16_gates(d1, p_d1, f32[3])
    _bf16_gates(db[on], p_db[on], f32[4][on])
    for g, w, f in ((dq, p_dq, f32[5]), (dk, p_dk, f32[7]),
                    (dv, p_dv, f32[8])):
        _bf16_gates(g, w, f)
    if need:
        _bf16_gates(dsc, p_dsc, f32[6], witness=False, mean=False)
    else:
        assert dsc is None
    assert torch.all(dq[dead] == 0)
    empty = slice(3 * FG.BLOCK_N, 4 * FG.BLOCK_N) if band \
        else slice(FG.BLOCK_N, 2 * FG.BLOCK_N)
    assert torch.all(dk[0, :, empty] == 0)
    assert torch.all(dv[0, :, empty] == 0)


@pytest.mark.gpu
@pytest.mark.parametrize("pack", [True, False])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("metric", FG.MXU_METRICS)
def test_compact_biased_bf16_kernels_match_plain(metric, rate, pack, cuda):
    """The bf16 forms of B4c, B5c and the compact row and key walks, bit
    and int8 stores: N=150 (not a tile multiple), D != Dv, dead rows
    (lse2 the merge's NEG_INF), a row tile with jcount = 0, a key tile
    with icount = 0, unvisited slots, per-head scales with dscale, both
    dropouts from per-snapshot seed pairs."""
    _compact_biased_bf16_vs_plain(cuda, 2, 3, 150, 16, 8,
                                  metric, rate, pack)


@pytest.mark.gpu
@pytest.mark.parametrize("pack", [True, False])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("metric", FG.MXU_METRICS)
def test_compact_biased_bf16_walks_band(metric, rate, pack, cuda):
    """The bf16 walks at `band_mask`'s cases over `band_compact`'s walks:
    N=330, ~1 pair a row a walked tile, a whole tile, a one-pair tile, a
    walked slot with no bit, walk entries past the counts, a key tile no
    row reaches, rows past 128 keys (the row walk walks its slots again),
    dead rows (dO 0 there), both stores, both dropouts."""
    _compact_biased_bf16_vs_plain(cuda, 2, 4, 330, 16, 16,
                                  metric, rate, pack, seed=3, band=True)


@pytest.mark.gpu
@pytest.mark.parametrize("pack", [True, False])
@pytest.mark.parametrize("D,Dv", [(16, 16), (8, 8), (12, 12), (7, 3),
                                  (128, 128)])
def test_compact_biased_bf16_kernel_head_dims(D, Dv, pack, cuda):
    """Head dims whose sqrt is not a power of two, D != Dv, and the
    widest, (128, 128), where the walks' rounded q and do (row walk) and
    k and v (key walk) and their accumulators fill shared memory, at the
    band's cases."""
    _compact_biased_bf16_vs_plain(cuda, 1, 2, 330, D, Dv,
                                  "gaussian_kernel", 0.1, pack, seed=1,
                                  band=True)


@pytest.mark.gpu
@pytest.mark.parametrize("H", [1, 8, 40])
def test_compact_biased_bf16_fold(H, cuda):
    """Folds of 1, 8 and 40 heads at the band's cases (past 32 heads the
    bf16 row walk launches once per head group, each adding into dB)."""
    _compact_biased_bf16_vs_plain(cuda, 2, H, 330, 16, 16,
                                  "gaussian_kernel", 0.1, True, seed=5,
                                  band=True)


@pytest.mark.gpu
@pytest.mark.parametrize("pack", [True, False])
@pytest.mark.parametrize("metric,rate", [("euclidean", 0.0),
                                         ("gaussian_kernel", 0.1)])
def test_compact_biased_bf16_deterministic(metric, rate, pack, cuda):
    """dq, dk, dv, dB (at the store's pairs), delta1 and dscale of the two
    bf16 walks are bit-identical over 20 repeated calls: neither sums with
    atomics."""
    (q, k, v, mask, store, bias_store, plan, plan_t, scale, seeds, do, lse1,
     lse2, delta2, d1_rest) = _compact_biased_bf16_inputs(
        cuda, 2, 4, 1008, 16, 16, metric, pack, rate, 3, band=True)
    need = metric in FG.SCALED_METRICS
    on = FG.store_pairs(store)
    first = None
    for _ in range(20):
        got = FG._biased_backward_compact(
            q, k, v, store, bias_store, do, lse1, lse2, delta2, plan, plan_t,
            metric, scale, rate, seeds, need, d1_rest, True)
        got = [t.clone() for t in got[:3]] + [got[3][on]] + [
            t.clone() for t in got[4:] if t is not None]
        if first is None:
            first = got
        for a, b in zip(got, first):
            assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("fault", ["jslot", "jcount", "islot", "ilist"])
def test_compact_biased_bf16_bad_plan_raises_before_launch(fault, cuda):
    """The bf16 walks' wrappers check the walk's values: a jslot or islot
    past the store, a count past the walk's width or a tile past N raises
    ValueError on the host, and no kernel is launched."""
    (q, k, v, mask, store, bias_store, plan, plan_t, scale, seeds, do, lse1,
     lse2, delta2, _) = _compact_biased_bf16_inputs(
        cuda, 1, 2, 150, 16, 16, "dot_product", True, 0.0)
    jl, jc, js = (p.clone() for p in plan)
    il, ic, isl = (p.clone() for p in plan_t)
    S = store.shape[1]
    if fault == "jslot":
        js[0, 0, 0] = S
    elif fault == "jcount":
        jc[0, 0] = jl.shape[-1] + 1
    elif fault == "islot":
        isl[0, 0, 0] = -1
    else:
        il[0, 0, 0] = 3
    common = (q, k, v, store, bias_store, do, lse1, lse2, delta2)
    before = {k_.name: k_.launches for k_ in FG.KERNELS}
    calls = [lambda: FG.flash_biased_bwd_key_compact_bf16_kernel(
        *common, lse1, il, ic, isl, "dot_product", scale, seeds, 0.0)] \
        if fault in ("islot", "ilist") else [
        lambda: FG.flash_biased_bwd_row_compact_bf16_kernel(
            *common, None, jl, jc, js, "dot_product", scale, seeds, 0.0,
            False),
        lambda: FG._biased_backward_compact(
            *common, (jl, jc, js), plan_t, "dot_product", scale, 0.0, seeds,
            False, lse1, True)]
    for call in calls:
        with pytest.raises(ValueError):
            call()
    assert {k_.name: k_.launches for k_ in FG.KERNELS} == before


@pytest.mark.gpu
def test_hybrid_edge_bf16_trainer_step_on_gpu_matches_cpu(cuda):
    """One TAGANTrainer step of the 100-node edge-feature hybrid model
    (Fe = 4) with bf16_matmul=True over a ``plan="hybrid"`` loader, card
    against CPU: the bf16 forms of B4c, B5c, B6c, B7a c and B7b c
    launched once per layer, nothing else. With the plain contractions
    pinned to fp32 the loss within the max gate and each gradient within
    `BF16_EDGE_GRAD` (the edge parameters' gradients are sums of dB over
    every edge, as on flash); with every contraction at bf16 within
    bf16-class tolerances (the loss 2e-2, each gradient 1e-1 of its
    largest entry); the edge parameters' gradients non-zero."""
    from tagan_torch.core.module import default_matmul_precision
    seqs = _hybrid_seqs(np.random.default_rng(5), 100, 800, 3, 2, 4)
    cfg = _bf16_model_cfg(spatial_backend="hybrid", edge_feature_dim=4,
                          use_edge_features=True,
                          distance_metric="gaussian_kernel",
                          learnable_distance=True)
    batch, labels, smask = next(iter(pt.TemporalGraphDataLoader(
        pt.TemporalGraphDataset(seqs, [1.0, 0.0]), batch_size=2,
        dense_adj=False, plan="hybrid")))
    want = {k_.name: 0 for k_ in FG.KERNELS}
    want.update({k_.name: cfg.num_layers for k_ in COMPACT_BIASED_BF16})
    for contractions, loss_tol, grad_tol in (("highest", BF16_MAX_TOL,
                                              BF16_EDGE_GRAD),
                                             (None, 2e-2, 1e-1)):
        got = {}
        for dev in ("cuda", "cpu"):
            model = pt.TAGAN(cfg, device=dev,
                             generator=torch.Generator().manual_seed(0))
            if contractions is not None:
                model.precision = \
                    lambda: default_matmul_precision(contractions)
            tr = pt.TAGANTrainer(model, pt.ExperimentConfig(model=cfg))
            before = {k_.name: k_.launches for k_ in FG.KERNELS}
            loss, _ = tr._loss(batch, labels, smask, True)
            loss.backward()
            launched = {k_.name: k_.launches - before[k_.name]
                        for k_ in FG.KERNELS}
            got[dev] = (loss.item(), {n_: p.grad.detach().cpu().clone()
                                      for n_, p in model.named_parameters()})
            if dev == "cuda":
                assert launched == want
        assert abs(got["cuda"][0] - got["cpu"][0]) <= loss_tol
        for name in ("edge_embedding.w",
                     "geometric_layers.layer_0.edge_bias.w",
                     "geometric_layers.layer_1.edge_bias.w"):
            assert got["cuda"][1][name].abs().max() > 0, name
        for name, g in got["cpu"][1].items():
            if name in ("temporal_attention.k.b",
                        "temporal_attention.time_encoding.basis_proj.b",
                        "temporal_attention.time_q_proj.b"):
                continue    # zero in exact arithmetic: fp32 noise
            card = got["cuda"][1][name]
            assert torch.isfinite(card).all(), name
            assert (card - g).abs().max() <= grad_tol * g.abs().max(), name


# -- B5c's compact forward pair walk, fp32 and bf16 ---------------------------

def compact_fwd_walk_check(dev, bf16, G, H, N, D, Dv, metric, rate, pack,
                           seed=3, repeats=1):
    """B5c (``bf16``: its bf16 form), the compact forward pair walk, at
    `band_mask`'s cases over `band_compact`'s walks (a whole tile, a
    one-pair tile, rows past 128 keys, dead rows, a walked slot with no
    bit, walk entries past the counts; N = 330 has a ragged last tile),
    on `_compact_biased_bwd_inputs`' union-like lse1 (the band's raised
    by 0.25; q and k at ``BF16_QK_SCALE`` in bf16), against the compact
    plain version: out and lse2 within TOL of it over live rows in fp32,
    under the bf16 gates in bf16 (the plain fp32 version the witness).
    Its outputs are allocated NaN-filled (`nan_empty`) and come back set
    everywhere, dead rows exactly 0 and ``LSE_DEAD``; each call launches
    the walk once and nothing else; ``repeats`` calls are bit-identical.
    Shared by chip_smoke.py's phases 2e and 2k. Returns the max abs error
    over live rows (fp32) or the worst (max abs error, max error, mean
    error, witness) over the largest entry (bf16)."""
    (q, k, v, mask, store, bias_store, plan, _, scale, seeds, _, lse1, _,
     _, _) = (
        t.to(dev).contiguous() if torch.is_tensor(t)
        else tuple(p_.to(dev).contiguous() for p_ in t)
        for t in _compact_biased_bwd_inputs(
            G, H, N, D, Dv, metric, pack, rate, seed,
            BF16_QK_SCALE if bf16 else 1.0, band=True))
    kern = FG.flash_biased_fwd_compact_bf16_kernel if bf16 \
        else FG.flash_biased_fwd_compact_kernel
    got, live = _fwd_walk_run(kern, (
        q, k, v, store, bias_store, lse1, *plan, metric, scale, seeds, rate),
        mask, H, repeats)
    plain = {b: FG.flash_biased_forward_compact_plain(
        q, k, v, store, bias_store, lse1, *plan, metric, scale, rate, seeds,
        b) for b in {bf16, False}}
    return _fwd_walk_errors(got, plain[bf16], plain[False], live, bf16)


def _fwd_walk_run(kern, args, mask, H, repeats):
    """(out, lse) of the compact forward walk ``kern`` on ``args`` (the LSE
    mode: (lse1,)), its outputs allocated NaN-filled (`nan_empty`): each
    call launches ``kern`` once and nothing else, out and lse come back
    finite everywhere, dead rows exactly 0 and ``LSE_DEAD``, and
    ``repeats`` calls bit-identical. Returns them with the live rows
    [G, H, N]."""
    def call():
        with nan_empty():
            got = kern(*args)
        return got if isinstance(got, tuple) else (got,)
    before = {k_.name: k_.launches for k_ in FG.KERNELS}
    got = call()
    torch.cuda.synchronize()
    launched = {k_.name: k_.launches - before[k_.name] for k_ in FG.KERNELS}
    assert launched == {k_.name: int(k_ is kern) for k_ in FG.KERNELS}
    *out, lse = got
    assert all(torch.isfinite(t).all() for t in got)
    dead = (mask == 0).all(-1)[:, None, :].expand(-1, H, -1)
    assert dead.any() and (~dead).any()
    assert all(torch.all(o[dead] == 0) for o in out)
    assert torch.all(lse[dead] == FG.LSE_DEAD)
    for _ in range(repeats - 1):
        again = call()
        assert all(torch.equal(a, g) for a, g in zip(again, got))
    return got, ~dead


def _fwd_walk_errors(got, want, f32, live, bf16, witness=(True, False)):
    """The walk's (out, lse) against the plain version's ``want`` over
    live rows: within TOL in fp32, returning the max abs error; under the
    bf16 gates in bf16 (``f32``, the plain fp32 version, the witness of
    the outputs that ``witness`` flags: out), returning the worst (max abs
    error, max error, mean error, witness) over the largest entry."""
    if not bf16:
        err = max((g - w)[live].abs().max().item()
                  for g, w in zip(got, want))
        assert err <= TOL, err
        return err
    res = []
    for g, w, f, wit in zip(got, want, f32, witness):
        g, w, f = g[live], w[live], f[live]
        _bf16_gates(g, w, f, witness=wit)
        m = w.abs().max().clamp(min=1e-30)
        e = (g - w).abs()
        res.append(((e.max()).item(), (e.max() / m).item(),
                    (e.mean() / m).item(), ((f - w).abs().mean() / m).item()
                    if wit else float("inf")))
    return tuple(max(r[i] for r in res) if i < 3 else min(r[i] for r in res)
                 for i in range(4))


@pytest.mark.gpu
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("pack", [True, False])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("metric", FG.MXU_METRICS)
def test_compact_fwd_walk_band(metric, rate, pack, bf16, cuda):
    """B5c's walk in both precisions at the band's cases, bit and int8
    stores, every metric, both dropouts on and off (their hashes at the
    global (row, key), as the plain version's)
    (`compact_fwd_walk_check`)."""
    compact_fwd_walk_check(cuda, bf16, 2, 4, 330, 16, 16, metric, rate, pack)


@pytest.mark.gpu
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("pack", [True, False])
@pytest.mark.parametrize("D,Dv", [(16, 16), (8, 8), (12, 12), (7, 3),
                                  (128, 128)])
def test_compact_fwd_walk_head_dims(D, Dv, pack, bf16, cuda):
    """Head dims whose sqrt is not a power of two, D != Dv, odd widths (no
    16-byte gathers), and the widest, (128, 128), where q, the
    accumulators and the flush's values pass 48 KB a warp at one head."""
    compact_fwd_walk_check(cuda, bf16, 1, 2, 330, D, Dv, "gaussian_kernel",
                           0.1, pack, seed=1)


@pytest.mark.gpu
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("H", [1, 4, 33])
def test_compact_fwd_walk_fold(H, bf16, cuda):
    """Folds of 1, 4 and 33 heads (32 rows a warp at one head; two head
    groups, the second of one head, past 32)."""
    compact_fwd_walk_check(cuda, bf16, 2, H, 330, 16, 16, "gaussian_kernel",
                           0.1, True, seed=5)


@pytest.mark.gpu
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("pack", [True, False])
def test_compact_fwd_walk_deterministic(pack, bf16, cuda):
    """out and lse2 are bit-identical over 20 calls: the walk sums in the
    list's order and has no atomic."""
    compact_fwd_walk_check(cuda, bf16, 2, 4, 1008, 16, 16, "gaussian_kernel",
                           0.1, pack, repeats=20)


@pytest.mark.gpu
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("fault", ["jslot", "jcount", "jlist", "bias"])
def test_compact_fwd_walk_bad_plan_raises_before_launch(fault, bf16, cuda):
    """The public entry checks the walk's values and the wrapper the
    shapes: a jslot past the store, a count past the walk's width, a key
    tile past N, a bias store of another slot count raise ValueError on
    the host, and no kernel is launched."""
    (q, k, v, _, store, bias_store, plan, _, scale, seeds, _, lse1, _, _,
     _) = _compact_biased_bf16_inputs(cuda, 1, 2, 150, 16, 16,
                                      "dot_product", True, 0.0)
    jl, jc, js = (p.clone() for p in plan)
    if fault == "jslot":
        js[0, 0, 0] = store.shape[1]
    elif fault == "jcount":
        jc[0, 0] = jl.shape[-1] + 1
    elif fault == "jlist":
        jl[0, 0, 0] = 3
    else:
        bias_store = bias_store[:, 1:].contiguous()
    before = {k_.name: k_.launches for k_ in FG.KERNELS}
    with pytest.raises(ValueError):
        FG.flash_biased_fwd_compact(
            q, k, v, store, bias_store, lse1, jl, jc, js,
            metric="dot_product", scale=scale, seeds=seeds, bf16=bf16)
    assert {k_.name: k_.launches for k_ in FG.KERNELS} == before


# -- B1c: the compact forward pair walk's OUT mode, fp32 and bf16 ------------

def compact_out_walk_check(dev, bf16, G, H, N, D, Dv, metric, rate, pack,
                           seed=3, repeats=1):
    """B1c (``bf16``: its bf16 form), the compact forward pair walk's OUT
    mode, at `band_mask`'s cases over `band_compact`'s walks (a whole
    tile, a one-pair tile, rows past 128 keys, dead rows, a walked slot
    with no bit, walk entries past the counts; N = 330 has a ragged last
    tile), one hash seed a snapshot (q and k at ``BF16_QK_SCALE`` in
    bf16), against the compact plain version: out and lse within TOL of
    it over live rows in fp32, under the bf16 gates in bf16 (the plain
    fp32 version the witness). With dropout, the plain version at
    another seed, and without dropout, lies far from the walk's out: the
    walk dropped the pairs the snapshot's seed drops (a hash mix left at
    0 would not). Its outputs are allocated NaN-filled (`nan_empty`) and
    come back set everywhere, dead rows exactly 0 and ``LSE_DEAD``; each
    call launches the walk once and nothing else; ``repeats`` calls are
    bit-identical. Shared by chip_smoke.py's phases 2e and 2k. Returns
    the max abs error over live rows (fp32) or the worst (max abs error,
    max error, mean error, witness) over the largest entry (bf16)."""
    (q, k, v, mask, store, _, plan, _, scale, seeds, _, _, _, _, _) = (
        t.to(dev).contiguous() if torch.is_tensor(t)
        else tuple(p_.to(dev).contiguous() for p_ in t)
        for t in _compact_biased_bwd_inputs(
            G, H, N, D, Dv, metric, pack, rate, seed,
            BF16_QK_SCALE if bf16 else 1.0, band=True))
    seed1 = seeds[:, 0].contiguous()
    kern = FG.flash_geometric_fwd_compact_bf16_kernel if bf16 \
        else FG.flash_geometric_fwd_compact_kernel
    got, live = _fwd_walk_run(
        kern, (q, k, v, store, *plan, metric, scale, seed1, rate), mask, H,
        repeats)

    def plain(b, r=rate, sd=seed1):
        return FG.flash_geometric_forward_compact_plain(
            q, k, v, store, *plan, metric, scale, r, sd, b)
    if rate > 0:
        for other in (plain(bf16, sd=seed1 + 1)[0], plain(bf16, 0.0)[0]):
            assert (got[0] - other)[live].abs().max() > 100 * TOL
    return _fwd_walk_errors(got, plain(bf16), plain(False), live, bf16)


@pytest.mark.gpu
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("pack", [True, False])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("metric", FG.MXU_METRICS)
def test_compact_out_walk_band(metric, rate, pack, bf16, cuda):
    """B1c's walk in both precisions at the band's cases, bit and int8
    stores, every metric, dropout off and on (its hash at the global
    (row, key) with the snapshot's seed, as the plain version's)
    (`compact_out_walk_check`)."""
    compact_out_walk_check(cuda, bf16, 2, 4, 330, 16, 16, metric, rate, pack)


@pytest.mark.gpu
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("pack", [True, False])
@pytest.mark.parametrize("D,Dv", [(16, 16), (8, 8), (12, 12), (7, 3),
                                  (128, 128)])
def test_compact_out_walk_head_dims(D, Dv, pack, bf16, cuda):
    """Head dims whose sqrt is not a power of two, D != Dv, odd widths (no
    16-byte gathers), and the widest, (128, 128), where q, the
    accumulators and the flush's values pass 48 KB a warp at one head."""
    compact_out_walk_check(cuda, bf16, 1, 2, 330, D, Dv, "gaussian_kernel",
                           0.1, pack, seed=1)


@pytest.mark.gpu
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("H", [1, 4, 33])
def test_compact_out_walk_fold(H, bf16, cuda):
    """Folds of 1, 4 and 33 heads (32 rows a warp at one head; two head
    groups, the second of one head, past 32), each head's hash mix its
    own."""
    compact_out_walk_check(cuda, bf16, 2, H, 330, 16, 16, "gaussian_kernel",
                           0.1, True, seed=5)


@pytest.mark.gpu
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("pack", [True, False])
def test_compact_out_walk_deterministic(pack, bf16, cuda):
    """out and lse are bit-identical over 20 calls: the walk sums in the
    list's order and has no atomic."""
    compact_out_walk_check(cuda, bf16, 2, 4, 1008, 16, 16, "gaussian_kernel",
                           0.1, pack, repeats=20)


@pytest.mark.gpu
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("fault", ["jslot", "jcount", "jlist", "seed"])
def test_compact_out_walk_bad_plan_raises_before_launch(fault, bf16, cuda):
    """The public entry checks the walk's values and the wrapper the
    shapes: a jslot past the store, a count past the walk's width, a key
    tile past N, a seed of another length raise ValueError on the host,
    and no kernel is launched."""
    (q, k, v, _, store, _, plan, _, scale, seeds, _, _, _, _,
     _) = _compact_biased_bf16_inputs(cuda, 1, 2, 150, 16, 16,
                                      "dot_product", True, 0.0)
    seed = seeds[:, 0].contiguous()
    jl, jc, js = (p.clone() for p in plan)
    if fault == "jslot":
        js[0, 0, 0] = store.shape[1]
    elif fault == "jcount":
        jc[0, 0] = jl.shape[-1] + 1
    elif fault == "jlist":
        jl[0, 0, 0] = 3
    else:
        seed = torch.cat([seed, seed])
    before = {k_.name: k_.launches for k_ in FG.KERNELS}
    with pytest.raises(ValueError):
        FG.flash_geometric_fwd_compact(
            q, k, v, store, jl, jc, js, metric="dot_product", scale=scale,
            seed=seed, dropout_rate=0.1, bf16=bf16)
    assert {k_.name: k_.launches for k_ in FG.KERNELS} == before



# -- B4c: the compact forward pair walk's LSE mode, fp32 and bf16 ------------

def compact_lse_walk_check(dev, bf16, G, H, N, D, metric, pack, seed=3,
                           repeats=1):
    """B4c (``bf16``: its bf16 form), the compact forward pair walk's LSE
    mode, at `band_mask`'s cases over `band_compact`'s walks (a whole
    tile, a one-pair tile, rows past 128 keys, dead rows, a walked slot
    with no bit, walk entries past the counts; N = 330 has a ragged last
    tile), q and k at ``BF16_QK_SCALE`` in bf16, against the compact plain
    version: lse1 within TOL of it over live rows in fp32, under the bf16
    max and mean gates in bf16 (the plain fp32 version beside it). Its
    output is allocated NaN-filled (`nan_empty`) and comes back set
    everywhere, dead rows exactly ``LSE_DEAD``; each call launches the
    walk once and nothing else; ``repeats`` calls are bit-identical.
    Shared by chip_smoke.py's phases 2e and 2k. Returns the max abs error
    over live rows (fp32) or the worst (max abs error, max error, mean
    error, witness: inf, none is taken) over the largest entry (bf16)."""
    (q, k, _, mask, store, _, plan, _, scale, _, _, _, _, _, _) = (
        t.to(dev).contiguous() if torch.is_tensor(t)
        else tuple(p_.to(dev).contiguous() for p_ in t)
        for t in _compact_biased_bwd_inputs(
            G, H, N, D, D, metric, pack, 0.0, seed,
            BF16_QK_SCALE if bf16 else 1.0, band=True))
    kern = FG.flash_lse1_compact_bf16_kernel if bf16 \
        else FG.flash_lse1_compact_kernel
    got, live = _fwd_walk_run(kern, (q, k, store, *plan, metric, scale),
                              mask, H, repeats)
    plain = {b: (FG.flash_lse1_compact_plain(q, k, store, *plan, metric,
                                             scale, b),)
             for b in {bf16, False}}
    return _fwd_walk_errors(got, plain[bf16], plain[False], live, bf16,
                            witness=(False,))


@pytest.mark.gpu
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("pack", [True, False])
@pytest.mark.parametrize("metric", FG.MXU_METRICS)
def test_compact_lse_walk_band(metric, pack, bf16, cuda):
    """B4c's walk in both precisions at the band's cases, bit and int8
    stores, every metric (`compact_lse_walk_check`)."""
    compact_lse_walk_check(cuda, bf16, 2, 4, 330, 16, metric, pack)


@pytest.mark.gpu
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("pack", [True, False])
@pytest.mark.parametrize("D", [16, 8, 12, 7, 128])
def test_compact_lse_walk_head_dims(D, pack, bf16, cuda):
    """Head dims whose sqrt is not a power of two, odd widths (no 16-byte
    gathers), and the widest, 128."""
    compact_lse_walk_check(cuda, bf16, 1, 2, 330, D, "gaussian_kernel", pack,
                           seed=1)


@pytest.mark.gpu
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("H", [1, 4, 33])
def test_compact_lse_walk_fold(H, bf16, cuda):
    """Folds of 1, 4 and 33 heads (32 rows a warp at one head; two head
    groups, the second of one head, past 32), each head's scale its
    own."""
    compact_lse_walk_check(cuda, bf16, 2, H, 330, 16, "gaussian_kernel",
                           True, seed=5)


@pytest.mark.gpu
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("pack", [True, False])
def test_compact_lse_walk_deterministic(pack, bf16, cuda):
    """lse1 is bit-identical over 20 calls: the walk sums in the list's
    order and has no atomic."""
    compact_lse_walk_check(cuda, bf16, 2, 4, 1008, 16, "gaussian_kernel",
                           pack, repeats=20)


@pytest.mark.gpu
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("fault", ["jslot", "jcount", "jlist"])
def test_compact_lse_walk_bad_plan_raises_before_launch(fault, bf16, cuda):
    """The public entry checks the walk's values: a jslot past the store,
    a count past the walk's width, a key tile past N raise ValueError on
    the host, and no kernel is launched."""
    (q, k, _, _, store, _, plan, _, scale, _, _, _, _, _,
     _) = _compact_biased_bf16_inputs(cuda, 1, 2, 150, 16, 16,
                                      "dot_product", True, 0.0)
    jl, jc, js = (p.clone() for p in plan)
    if fault == "jslot":
        js[0, 0, 0] = store.shape[1]
    elif fault == "jcount":
        jc[0, 0] = jl.shape[-1] + 1
    else:
        jl[0, 0, 0] = 3
    before = {k_.name: k_.launches for k_ in FG.KERNELS}
    with pytest.raises(ValueError):
        FG.flash_lse1_compact(q, k, store, jl, jc, js, metric="dot_product",
                              scale=scale, bf16=bf16)
    assert {k_.name: k_.launches for k_ in FG.KERNELS} == before


# -- B3b c's compact key pair walk, fp32 and bf16 ---------------------------

def compact_bwd_walk_check(dev, bf16, G, H, N, D, Dv, metric, rate, pack,
                           seed=3, repeats=1):
    """B3b c (``bf16``: its bf16 form), the compact key pair walk, at
    `band_mask`'s cases over `band_compact`'s walks (a whole tile, whose
    keys' lists pass CAPR so that the walk flushes more than once; a
    one-pair tile; a key tile no row reaches, icount = 0; rows past 128
    keys; dead rows; a walked slot with no bit; walk entries past the
    counts; N = 330 has a ragged last tile), q and k at ``BF16_QK_SCALE``
    in bf16, on the compact plain forward's (out, lse) with an lse
    cotangent, and one live row's lse set to ``LSE_DEAD`` though the store
    lists its pairs (p = 0 there, not NaN), against the compact plain
    backward's dk and dv: within TOL of the largest entry in fp32, under
    the bf16 gates in bf16 (the plain fp32 backward the witness). Its
    outputs are allocated NaN-filled (`nan_empty`) and come back set
    everywhere, the keys no row reaches exactly 0; each call launches the
    walk once and nothing else; ``repeats`` calls are bit-identical.
    Shared by chip_smoke.py's phases 2f and 2j. Returns the max abs
    error (fp32) or the worst (max abs error, max error, mean error,
    witness) over the largest entry (bf16)."""
    (q, k, v, mask, store, _, plan, plan_t, scale, seeds, do, _, _, _,
     _) = (t.to(dev).contiguous() if torch.is_tensor(t)
           else tuple(p_.to(dev).contiguous() for p_ in t)
           for t in _compact_biased_bwd_inputs(
               G, H, N, D, Dv, metric, pack, rate, seed,
               BF16_QK_SCALE if bf16 else 1.0, band=True))
    seed1 = seeds[:, 0].contiguous()
    out, lse = (t.contiguous() for t in
                FG.flash_geometric_forward_compact_plain(
                    q, k, v, store, *plan, metric, scale, rate, seed1,
                    bf16=bf16))
    live = (mask != 0).any(-1)
    assert live[:, 7].all()
    lse[:, :, 7] = FG.LSE_DEAD
    gen = torch.Generator().manual_seed(seed + 500)
    dlse = (0.25 * torch.randn(lse.shape, generator=gen)).to(dev) \
        * live[:, None]
    delta = FG._delta(do, out, dlse).contiguous()
    kern = FG.flash_geometric_bwd_dkv_compact_bf16_kernel if bf16 \
        else FG.flash_geometric_bwd_dkv_compact_kernel

    def call():
        with nan_empty():
            return kern(q, k, v, store, do, lse, delta, *plan_t, metric,
                        scale, seed1, rate)
    before = {k_.name: k_.launches for k_ in FG.KERNELS}
    dk, dv = call()
    torch.cuda.synchronize()
    launched = {k_.name: k_.launches - before[k_.name] for k_ in FG.KERNELS}
    assert launched == {k_.name: int(k_ is kern) for k_ in FG.KERNELS}
    assert torch.isfinite(dk).all() and torch.isfinite(dv).all()
    unreached = slice(192, 256) if N >= 256 else slice(N, N)
    assert N < 256 or not mask[:, :, unreached].any()
    assert torch.all(dk[:, :, unreached] == 0)
    assert torch.all(dv[:, :, unreached] == 0)
    for _ in range(repeats - 1):
        again = call()
        assert torch.equal(again[0], dk) and torch.equal(again[1], dv)
    rest = (q, k, v, store, out, lse, do, *plan, metric, scale, rate, seed1,
            False, dlse)
    want = FG.flash_geometric_backward_compact_plain(*rest, bf16=bf16)[1:3]
    if not bf16:
        err = max((g - w).abs().max().item() for g, w in zip((dk, dv), want))
        for g, w in zip((dk, dv), want):
            assert ((g - w).abs().max() / w.abs().max().clamp(min=1.0)
                    ).item() <= TOL
        return err
    f32 = FG.flash_geometric_backward_compact_plain(*rest)[1:3]
    res = []
    for got, w, f in zip((dk, dv), want, f32):
        _bf16_gates(got, w, f)
        m = w.abs().max().clamp(min=1e-30)
        e = (got - w).abs()
        res.append((e.max().item(), (e.max() / m).item(),
                    (e.mean() / m).item(), ((f - w).abs().mean() / m).item()))
    return tuple(max(r[i] for r in res) if i < 3 else min(r[i] for r in res)
                 for i in range(4))


@pytest.mark.gpu
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("pack", [True, False])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("metric", FG.MXU_METRICS)
def test_compact_bwd_walk_band(metric, rate, pack, bf16, cuda):
    """B3b c's walk in both precisions at the band's cases, bit and int8
    stores, every metric, dropout on and off (the hash at the global
    (row, key), as the plain version's) (`compact_bwd_walk_check`)."""
    compact_bwd_walk_check(cuda, bf16, 2, 4, 330, 16, 16, metric, rate, pack)


@pytest.mark.gpu
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("pack", [True, False])
@pytest.mark.parametrize("D,Dv", [(16, 16), (8, 8), (12, 12), (7, 3),
                                  (128, 128)])
def test_compact_bwd_walk_head_dims(D, Dv, pack, bf16, cuda):
    """Head dims whose sqrt is not a power of two, D != Dv, odd widths (no
    16-byte gathers), and the widest, (128, 128), where the block's items
    pass 227 KB at 64 keys and the block is halved until they fit."""
    compact_bwd_walk_check(cuda, bf16, 1, 2, 330, D, Dv, "gaussian_kernel",
                           0.1, pack, seed=1)


@pytest.mark.gpu
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("H,D", [(1, 16), (4, 16), (12, 16), (12, 128)])
def test_compact_bwd_walk_fold(H, D, bf16, cuda):
    """Folds of 1, 4 and 12 heads: 12 is more than a block's 8, so two head
    groups, the second of 4 heads; and 12 heads at head dim 128, where
    the block is halved to 8 keys."""
    compact_bwd_walk_check(cuda, bf16, 2, H, 330, D, D, "gaussian_kernel",
                           0.1, True, seed=5)


@pytest.mark.gpu
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("pack", [True, False])
def test_compact_bwd_walk_deterministic(pack, bf16, cuda):
    """dk and dv are bit-identical over 20 calls: the walk sums in the
    list's order and has no atomic."""
    compact_bwd_walk_check(cuda, bf16, 2, 4, 1008, 16, 16, "gaussian_kernel",
                           0.1, pack, repeats=20)


@pytest.mark.gpu
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("fault", ["islot", "icount", "ilist"])
def test_compact_bwd_walk_bad_plan_raises_before_launch(fault, bf16, cuda):
    """The walk's wrapper checks the transposed walk's values: an islot
    past the store, a count past the walk's width or a row tile past N
    raise ValueError on the host, and no kernel is launched."""
    (q, k, v, _, store, _, _, plan_t, scale, seeds, do, lse, _, delta, _) = (
        t.to(cuda) if torch.is_tensor(t) else tuple(p_.to(cuda) for p_ in t)
        for t in _compact_biased_bwd_inputs(1, 2, 330, 16, 16, "dot_product",
                                            True, 0.0, band=True))
    il, ic, isl = (p_.clone() for p_ in plan_t)
    if fault == "islot":
        isl[0, 0, 0] = store.shape[1]
    elif fault == "icount":
        ic[0, 0] = il.shape[-1] + 1
    else:
        il[0, 0, 0] = 6
    kern = FG.flash_geometric_bwd_dkv_compact_bf16_kernel if bf16 \
        else FG.flash_geometric_bwd_dkv_compact_kernel
    before = {k_.name: k_.launches for k_ in FG.KERNELS}
    with pytest.raises(ValueError):
        kern(q, k, v, store, do, lse, delta.contiguous(), il, ic, isl,
             "dot_product", scale, seeds[:, 0].contiguous(), 0.0)
    assert {k_.name: k_.launches for k_ in FG.KERNELS} == before


def compact_dq_walk_check(dev, bf16, G, H, N, D, Dv, metric, rate, pack,
                          seed=3, repeats=1):
    """B3a c (``bf16``: its bf16 form), the compact row pair walk, at
    `band_mask`'s cases over `band_compact`'s walks (a whole tile, whose
    rows' lists pass CAPR so that the walk flushes more than once; rows
    past 128 keys, whose walks list more than 2 CAPR pairs; a one-pair
    tile; dead rows; a walked slot with no bit; walk entries past the
    counts; N = 330 has a ragged last tile), q and k at ``BF16_QK_SCALE``
    in bf16, on the compact plain forward's (out, lse) with an lse
    cotangent, and one live row's lse set to ``LSE_DEAD`` though the store
    lists its pairs (p = 0 there, not NaN), against the compact plain
    backward's dq and, where the metric has a scale, dscale: within TOL
    of the largest entry in fp32, under the bf16 gates in bf16 (the plain
    fp32 backward the witness; dscale, a sum of terms that cancel, under
    the max gate alone). Its outputs are allocated NaN-filled
    (`nan_empty`) and come back set everywhere, dead rows' dq exactly 0;
    each call launches the walk once and nothing else; ``repeats`` calls
    are bit-identical. Shared by chip_smoke.py's phases 2f and 2j.
    Returns the max abs error (fp32) or the worst (max abs error, max
    error, mean error, witness) over the largest entry of dq (bf16)."""
    (q, k, v, mask, store, _, plan, _, scale, seeds, do, _, _, _,
     _) = (t.to(dev).contiguous() if torch.is_tensor(t)
           else tuple(p_.to(dev).contiguous() for p_ in t)
           for t in _compact_biased_bwd_inputs(
               G, H, N, D, Dv, metric, pack, rate, seed,
               BF16_QK_SCALE if bf16 else 1.0, band=True))
    seed1 = seeds[:, 0].contiguous()
    out, lse = (t.contiguous() for t in
                FG.flash_geometric_forward_compact_plain(
                    q, k, v, store, *plan, metric, scale, rate, seed1,
                    bf16=bf16))
    live = (mask != 0).any(-1)
    assert live[:, 7].all()
    lse[:, :, 7] = FG.LSE_DEAD
    gen = torch.Generator().manual_seed(seed + 500)
    dlse = (0.25 * torch.randn(lse.shape, generator=gen)).to(dev) \
        * live[:, None]
    delta = FG._delta(do, out, dlse).contiguous()
    need = metric in FG.SCALED_METRICS
    kern = FG.flash_geometric_bwd_dq_compact_bf16_kernel if bf16 \
        else FG.flash_geometric_bwd_dq_compact_kernel

    def call():
        with nan_empty():
            return kern(q, k, v, store, do, lse, delta, *plan, metric, scale,
                        seed1, rate, need)
    before = {k_.name: k_.launches for k_ in FG.KERNELS}
    dq, dsc = call()
    torch.cuda.synchronize()
    launched = {k_.name: k_.launches - before[k_.name] for k_ in FG.KERNELS}
    assert launched == {k_.name: int(k_ is kern) for k_ in FG.KERNELS}
    assert torch.isfinite(dq).all()
    assert (dsc is not None) == need
    assert not need or torch.isfinite(dsc).all()
    dead = ~live[:, None, :].expand(G, H, N)
    assert dead.any() and torch.all(dq[dead] == 0)
    for _ in range(repeats - 1):
        again = call()
        assert torch.equal(again[0], dq)
        assert not need or torch.equal(again[1], dsc)
    rest = (q, k, v, store, out, lse, do, *plan, metric, scale, rate, seed1,
            need, dlse)
    want = FG.flash_geometric_backward_compact_plain(*rest, bf16=bf16)
    if not bf16:
        pairs = ((dq, want[0]),) + (((dsc, want[3]),) if need else ())
        for g, w in pairs:
            assert ((g - w).abs().max() / w.abs().max().clamp(min=1.0)
                    ).item() <= TOL
        return max((g - w).abs().max().item() for g, w in pairs)
    f32 = FG.flash_geometric_backward_compact_plain(*rest)
    _bf16_gates(dq, want[0], f32[0])
    if need:
        _bf16_gates(dsc, want[3], f32[3], witness=False, mean=False)
    m = want[0].abs().max().clamp(min=1e-30)
    e = (dq - want[0]).abs()
    return (e.max().item(), (e.max() / m).item(), (e.mean() / m).item(),
            ((f32[0] - want[0]).abs().mean() / m).item())


@pytest.mark.gpu
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("pack", [True, False])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("metric", FG.MXU_METRICS)
def test_compact_dq_walk_band(metric, rate, pack, bf16, cuda):
    """B3a c's walk in both precisions at the band's cases, bit and int8
    stores, every metric, dropout on and off (the hash at the global
    (row, key), as the plain version's), dscale at gaussian and rbf
    (`compact_dq_walk_check`)."""
    compact_dq_walk_check(cuda, bf16, 2, 4, 330, 16, 16, metric, rate, pack)


@pytest.mark.gpu
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("pack", [True, False])
@pytest.mark.parametrize("D,Dv", [(16, 16), (8, 8), (12, 12), (7, 3),
                                  (128, 128)])
def test_compact_dq_walk_head_dims(D, Dv, pack, bf16, cuda):
    """Head dims whose sqrt is not a power of two, D != Dv, odd widths (no
    16-byte gathers), and the widest, (128, 128), whose items take 48 KB
    of a warp's shared memory."""
    compact_dq_walk_check(cuda, bf16, 1, 2, 330, D, Dv, "gaussian_kernel",
                          0.1, pack, seed=1)


@pytest.mark.gpu
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("H,D", [(1, 16), (4, 16), (33, 16), (33, 128)])
def test_compact_dq_walk_fold(H, D, bf16, cuda):
    """Folds of 1, 4 and 33 heads: 33 is more than a warp's 32 items, so
    two head groups as grid blocks, the second of one head; and 33 heads
    at head dim 128."""
    compact_dq_walk_check(cuda, bf16, 2, H, 330, D, D, "gaussian_kernel",
                          0.1, True, seed=5)


@pytest.mark.gpu
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("pack", [True, False])
def test_compact_dq_walk_deterministic(pack, bf16, cuda):
    """dq and dscale are bit-identical over 20 calls: the walk sums in the
    list's order and has no atomic. Seed 4: at seed 3 one dq term of this
    case lies on a bf16 rounding midpoint, where the plain bf16 version
    itself moves by 3.2e-3 of the largest entry under a 1e-7 relative
    nudge of q and k, past the 2e-3 max gate that no sum in another order
    can then meet (seed 4: 2.9e-4)."""
    compact_dq_walk_check(cuda, bf16, 2, 4, 1008, 16, 16, "gaussian_kernel",
                          0.1, pack, seed=4, repeats=20)


@pytest.mark.gpu
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("fault", ["jslot", "jcount", "jlist"])
def test_compact_dq_walk_bad_plan_raises_before_launch(fault, bf16, cuda):
    """The walk's wrapper checks the forward walk's values: a jslot past
    the store, a count past the walk's width or a key tile past N raise
    ValueError on the host, and no kernel is launched."""
    (q, k, v, _, store, _, plan, _, scale, seeds, do, lse, _, delta, _) = (
        t.to(cuda) if torch.is_tensor(t) else tuple(p_.to(cuda) for p_ in t)
        for t in _compact_biased_bwd_inputs(1, 2, 330, 16, 16, "dot_product",
                                            True, 0.0, band=True))
    jl, jc, js = (p_.clone() for p_ in plan)
    if fault == "jslot":
        js[0, 0, 0] = store.shape[1]
    elif fault == "jcount":
        jc[0, 0] = jl.shape[-1] + 1
    else:
        jl[0, 0, 0] = 6
    kern = FG.flash_geometric_bwd_dq_compact_bf16_kernel if bf16 \
        else FG.flash_geometric_bwd_dq_compact_kernel
    before = {k_.name: k_.launches for k_ in FG.KERNELS}
    with pytest.raises(ValueError):
        kern(q, k, v, store, do, lse, delta.contiguous(), jl, jc, js,
             "dot_product", scale, seeds[:, 0].contiguous(), 0.0, False)
    assert {k_.name: k_.launches for k_ in FG.KERNELS} == before

# -- the ring: B8 (all-gather) and B9 (ring flash) over virtual ranks ---------

# each ring is run this many times in a row: rows sent on before they
# arrived, or a slot reused before its reader finished, would give wrong
# rows only sometimes
RING_REPEATS = 20


def _virtual_mesh(cuda, g):
    """g virtual ranks of the one card, each with its own streams."""
    return TM.make_mesh(graph=g, devices=[cuda] * g)


@pytest.mark.gpu
@pytest.mark.parametrize("chunk", ["odd", 20_001])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [7, 64])
@pytest.mark.parametrize("g", [1, 2, 3, 4, 8])
def test_ring_all_gather_matches_plain(g, D, dtype, chunk, cuda):
    """B8 on g virtual ranks against the rank-order concatenation, bit for
    bit on every rank, over RING_REPEATS rings in a row; odd chunk lengths
    (at D = 7 the rank blocks of out start off the 16-byte grid); one
    launch of the ring kernel a ring, the card's only one, and no copy
    launch."""
    chunk = 37 + 2 * g if chunk == "odd" else chunk
    x = torch.randn(g * chunk, D, generator=torch.Generator().manual_seed(g))
    mesh = _virtual_mesh(cuda, g)
    shards = TM.shard_rows(mesh, x.to(dtype).to(cuda))
    want = TG.ring_all_gather_plain(shards)
    before = _ring_launches()
    runs = [TG.ring_all_gather(shards, mesh) for _ in range(RING_REPEATS)]
    torch.cuda.synchronize()
    assert _ring_launches(before) == (RING_REPEATS, 0)
    for outs in runs:
        assert len(outs) == g
        for out, w in zip(outs, want):
            assert out.dtype == dtype and torch.equal(out, w)


def _ring_launches(before=(0, 0)):
    """(ring all-gather launches, ring copy launches) since ``before``."""
    return (TG.ring_gather_kernel.launches - before[0],
            TG.ring_copy_kernel.launches - before[1])


def _distinct_shards(cuda, mesh, n, rows, D, dtype=torch.float32):
    """``n`` sets of shards with different values, and each set's plain
    gather."""
    gen = torch.Generator(device=cuda).manual_seed(rows + D)
    sets = [TM.shard_rows(mesh, torch.randn(
        mesh.shape["graph"] * rows, D, device=cuda, generator=gen).to(dtype))
        for _ in range(n)]
    return sets, [TG.ring_all_gather_plain(s) for s in sets]


@pytest.mark.gpu
def test_ring_all_gather_back_to_back(cuda):
    """200 rings at g = 8 with no synchronise between them, on two sets of
    shards in turn (a ring that read a flag of an earlier epoch as its own
    would read rows not yet written, or the other set's), each checked on
    the card as it goes while its outs are freed for the next rings."""
    g, rings = 8, 200
    mesh = _virtual_mesh(cuda, g)
    sets, wants = _distinct_shards(cuda, mesh, 2, 1001, 64)
    wrong = torch.zeros((), dtype=torch.int64, device=cuda)
    before = _ring_launches()
    for i in range(rings):
        outs = TG.ring_all_gather(sets[i % 2], mesh)
        for out, w in zip(outs, wants[i % 2]):
            wrong += (out != w).sum()
        del outs
    torch.cuda.synchronize()
    assert _ring_launches(before) == (rings, 0)
    assert int(wrong) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ring_all_gather_after_a_long_kernel(dtype, cuda):
    """A ring issued right after the current stream spins ~10 ms and then
    writes the shards: it gathers the new values, not the old."""
    g = 4
    mesh = _virtual_mesh(cuda, g)
    (old, new), (_, want) = _distinct_shards(cuda, mesh, 2, 5003, 7, dtype)
    torch.cuda.synchronize()
    for _ in range(3):
        torch.cuda._sleep(20_000_000)
        for o, n_ in zip(old, new):
            o.copy_(n_)
        outs = TG.ring_all_gather(old, mesh)
        torch.cuda.synchronize()
        for out, w in zip(outs, want):
            assert torch.equal(out, w)
        old = [o - 1 for o in old]


@pytest.mark.gpu
def test_ring_all_gather_two_meshes_interleaved(cuda):
    """Rings of two meshes of the card (4 and 3 ranks, each with its own
    flags and epochs) issued in turn, 40 each, without a synchronise."""
    meshes = [_virtual_mesh(cuda, 4), _virtual_mesh(cuda, 3)]
    data = [_distinct_shards(cuda, m, 2, 20_001, 64) for m in meshes]
    runs = []
    before = _ring_launches()
    for i in range(80):
        m = i % 2
        runs.append((m, i // 2 % 2, TG.ring_all_gather(
            data[m][0][i // 2 % 2], meshes[m])))
    torch.cuda.synchronize()
    assert _ring_launches(before) == (80, 0)
    for m, k, outs in runs:
        for out, w in zip(outs, data[m][1][k]):
            assert torch.equal(out, w)


@pytest.mark.gpu
def test_ring_all_gather_on_two_streams(cuda):
    """Rings of one mesh issued in turn on a side stream, each held back by
    a ~10 ms spin, and on the current stream, without a synchronise: a
    ring waits for the mesh's last one whatever stream that went on, so
    none takes a later ring's flag for its own."""
    mesh = _virtual_mesh(cuda, 4)
    sets, wants = _distinct_shards(cuda, mesh, 2, 20_001, 64)
    main, side = torch.cuda.current_stream(cuda), torch.cuda.Stream(cuda)
    side.wait_stream(main)
    runs = []
    before = _ring_launches()
    for i in range(20):
        with torch.cuda.stream(side if i % 2 == 0 else main):
            if i % 2 == 0:
                torch.cuda._sleep(20_000_000)
            runs.append((i // 2 % 2, TG.ring_all_gather(sets[i // 2 % 2],
                                                         mesh)))
    torch.cuda.synchronize()
    assert _ring_launches(before) == (20, 0)
    for k, outs in runs:
        for out, w in zip(outs, wants[k]):
            assert torch.equal(out, w)


@pytest.mark.gpu
@pytest.mark.parametrize("rows,D", [(41, 7), (20_001, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cards", [(0, 1), (0, 1, 2, 3),
                                   (0, 0, 1, 1, 2, 2, 3, 3),
                                   (0, 1, 2, 3, 0, 1, 2, 3)])
def test_ring_all_gather_several_cards(cards, dtype, rows, D):
    """Ranks on several cards (skipped with fewer): one launch a card a
    ring, the left rank's rows and flags read through peer pointers;
    RING_REPEATS rings in a row, bit for bit on every rank, then 20 more
    alternating with `torch.cat`s that write each card's memory."""
    if torch.cuda.device_count() <= max(cards):
        pytest.skip(f"needs {max(cards) + 1} cards")
    mesh = TM.make_mesh(graph=len(cards),
                        devices=[torch.device("cuda", c) for c in cards])
    x = torch.randn(len(cards) * rows, D,
                    generator=torch.Generator().manual_seed(rows + D))
    shards = TM.shard_rows(mesh, x.to(dtype))
    want = TG.ring_all_gather_plain(shards)
    before = _ring_launches()
    runs = [TG.ring_all_gather(shards, mesh) for _ in range(RING_REPEATS)]
    for _ in range(20):
        runs.append(TG.ring_all_gather(shards, mesh))
        TG.ring_all_gather_plain(shards)
    torch.cuda.synchronize()
    assert _ring_launches(before) == ((RING_REPEATS + 20)
                                      * len(set(cards)), 0)
    for outs in runs:
        for out, w in zip(outs, want):
            assert out.device == w.device and torch.equal(out, w)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ring_all_gather_wide(dtype, cuda):
    """[131,072, 64] rows over 4 virtual ranks (256 tiles a chunk in fp32),
    bit for bit, RING_REPEATS rings, one launch each."""
    mesh = _virtual_mesh(cuda, 4)
    x = torch.randn(131_072, 64, device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(4))
    shards = TM.shard_rows(mesh, x.to(dtype))
    want = TG.ring_all_gather_plain(shards)
    before = _ring_launches()
    for _ in range(RING_REPEATS):
        outs = TG.ring_all_gather(shards, mesh)
        assert all(torch.equal(o, w) for o, w in zip(outs, want))
    assert _ring_launches(before) == (RING_REPEATS, 0)


@pytest.mark.gpu
def test_ring_all_gather_one_card_issues_only_its_launch(cuda, monkeypatch):
    """With every rank on one card the ring records no event and makes no
    stream wait: it is its launch alone."""
    def refuse(*args, **kwargs):
        raise AssertionError("the ring touched an event or a stream wait")
    for cls, attr in ((torch.cuda.Event, "record"),
                      (torch.cuda.Stream, "wait_event"),
                      (torch.cuda.Stream, "wait_stream")):
        monkeypatch.setattr(cls, attr, refuse)
    mesh = _virtual_mesh(cuda, 4)
    shards = TM.shard_rows(mesh, torch.arange(4 * 999 * 7, device=cuda,
                                              dtype=torch.float32)
                           .reshape(-1, 7))
    outs = TG.ring_all_gather(shards, mesh)
    monkeypatch.undo()
    for out, w in zip(outs, TG.ring_all_gather_plain(shards)):
        assert torch.equal(out, w)


@pytest.mark.gpu
def test_ring_all_gather_raises(cuda):
    """A shard that is not contiguous raises before any launch."""
    mesh = _virtual_mesh(cuda, 2)
    shards = [torch.zeros(8, 6, device=cuda)[:, ::2] for _ in range(2)]
    before = _ring_launches()
    with pytest.raises(ValueError):
        TG.ring_all_gather(shards, mesh)
    assert _ring_launches(before) == (0, 0)


def _ring_inputs(cuda, g, H, per, D, seed, qk_scale):
    """q, k, v [H, N, D] (q, k times qk_scale) and an int8 mask with self
    loops, dead rows (among them rank 0's first row and the last row) and,
    for per > 128, a dead query tile of rank 0."""
    N = g * per
    rng = np.random.default_rng(seed)
    q, k = (rng.standard_normal((H, N, D)) * qk_scale for _ in range(2))
    v = rng.standard_normal((H, N, D))
    mask = rng.random((N, N)) < 0.1
    mask[np.arange(N), np.arange(N)] = True
    mask[[0, N - 1]] = False
    if per > 128:
        mask[64:128] = False
    return tuple(torch.from_numpy(a.astype(np.float32)).to(cuda)
                 for a in (q, k, v)) + (
        torch.from_numpy(mask.astype(np.int8)).to(cuda),)


def ring_walk_mask(g, per, seed=0, deg=8):
    """bool [N, N], N = g * per, for B9's pair walk over each hop's column
    block: ~``deg`` uniform random keys a row and self loops, and on every
    rank r (its rows r * per + i, per >= 8): row 0 dead; rows 1-2 90% dense
    in the chunk of rank (r + 1) mod g, the one that arrives last (hop
    g - 1), and rows 3-4 in their own chunk (hop 0), past 2 CAPR = 128
    keys in one hop where per >= 143, so that a hop spans several flushes;
    row 5 whose only keys (3) lie in the chunk that arrives last, and row
    6 whose only keys (3) lie in its own chunk."""
    N = g * per
    rng = np.random.default_rng(seed)
    mask = rng.random((N, N)) < deg / N
    mask[np.arange(N), np.arange(N)] = True
    for r in range(g):
        base, own, last = r * per, r * per, (r + 1) % g * per
        mask[base] = False
        for i, c0 in ((1, last), (2, last), (3, own), (4, own)):
            mask[base + i, c0:c0 + per] |= rng.random(per) < 0.9
        for i, c0 in ((5, last), (6, own)):
            mask[base + i] = False
            mask[base + i, c0 + rng.choice(per, 3, replace=False)] = True
    return mask


def _ring_flash_vs_plain(cuda, g, metric, D, bf16, per=75, H=3, walk=False,
                         repeats=3):
    """B9 on g virtual ranks against the plain version of each rank, run
    ``repeats`` times in a row: identical results, one fold per rank and
    hop, two copies (k and v) per rank and hop but the last, dead rows 0.
    ``walk`` takes `ring_walk_mask`'s mask."""
    q, k, v, mask = _ring_inputs(cuda, g, H, per, D, seed=g * 100 + D,
                                 qk_scale=BF16_QK_SCALE if bf16 else 1.0)
    if walk:
        mask = torch.from_numpy(ring_walk_mask(g, per, seed=g * 10 + per)
                                .astype(np.int8)).to(cuda)
    mesh = _virtual_mesh(cuda, g)
    qs, ks, vs = (TM.shard_rows(mesh, t, dim=1) for t in (q, k, v))
    masks = TM.shard_rows(mesh, mask)
    scale = torch.linspace(0.7, 2.0, H, device=cuda)
    fold = TF.ring_flash_fold_bf16_kernel if bf16 else TF.ring_flash_fold_kernel
    before = (fold.launches, TG.ring_copy_kernel.launches)
    runs = [torch.cat(TF.ring_flash_attention_local(
        mesh, qs, ks, vs, masks, metric=metric, scale_param=scale,
        bf16=bf16), 1) for _ in range(repeats)]
    torch.cuda.synchronize()
    assert (fold.launches - before[0], TG.ring_copy_kernel.launches
            - before[1]) == (repeats * g * g, repeats * 2 * g * (g - 1))
    for run in runs[1:]:
        assert torch.equal(run, runs[0])
    if metric in FG._COSINE:
        qs, ks = [FG._l2_normalize(x) for x in qs], \
            [FG._l2_normalize(x) for x in ks]

    def plain(b16):
        return torch.cat([TF.ring_flash_attention_local_plain(
            qs[r], ks, vs, masks[r], r, metric, scale, b16)
            for r in range(g)], 1)
    got, want = runs[0], plain(bf16)
    dead = (mask == 0).all(-1)
    assert bool(dead[0]) and torch.all(got[:, dead] == 0)
    if bf16:
        _bf16_gates(got, want, plain(False))
    else:
        assert (got - want).abs().max().item() <= TOL


@pytest.mark.gpu
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("g", [1, 2, 4, 8])
@pytest.mark.parametrize("metric", FG.MXU_METRICS)
def test_ring_flash_matches_plain(metric, g, bf16, cuda):
    """Every metric, per-head scales, per = 75 rows a rank (two key tiles
    a chunk, the second ragged); bf16 under the bf16 gates, q and k at
    BF16_QK_SCALE."""
    _ring_flash_vs_plain(cuda, g, metric, 16, bf16)


@pytest.mark.gpu
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("D", [16, 8, 12, 7, 128])
def test_ring_flash_head_dims(D, bf16, cuda):
    """Head dims up to the kernels' 128, at 4 ranks of 150 rows (a dead
    query tile on rank 0)."""
    _ring_flash_vs_plain(cuda, 4, "euclidean", D, bf16, per=150)


@pytest.mark.gpu
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("per", [150, 75, 200])
@pytest.mark.parametrize("g", [1, 2, 4, 8])
def test_ring_flash_walk_cases(g, per, bf16, cuda):
    """The pair walk's own cases (`ring_walk_mask`): rows past 2 CAPR keys
    in the first and in the last hop (several flushes in one hop, where the
    bf16 form must round p against the hop's max), rows valid only in the
    last or only in their own chunk, dead rows; per = 75 (N = 75 g, never
    a multiple of 16: the mask walk's byte loads), 150 (N = 1200 at g = 8)
    and 200 (N a multiple of 16 from g = 2: its 16-byte loads, hop column
    blocks off the 16-byte grid); 20 rings bit for bit, the gaussian metric
    with per-head scales."""
    _ring_flash_vs_plain(cuda, g, "gaussian_kernel", 16, bf16, per=per,
                         walk=True, repeats=RING_REPEATS)


@pytest.mark.gpu
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("H", [1, 4, 40])
def test_ring_flash_walk_heads(H, bf16, cuda):
    """One head (32 rows a warp), four (8 rows) and 40 (two head groups a
    row, the second of 8 heads) at the walk's cases over 4 ranks."""
    _ring_flash_vs_plain(cuda, 4, "euclidean", 16, bf16, per=150, H=H,
                         walk=True)


@pytest.mark.gpu
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("bad", ["col0", "negative col0", "mask rows",
                                 "mask dtype", "q dtype", "k shape", "D",
                                 "state", "state shape", "metric", "device"])
def test_ring_flash_walk_refused_before_launch(bad, bf16, cuda):
    """Each bad argument of one hop raises ValueError before any launch,
    in both precisions."""
    H, per, D, N = 3, 70, 16, 140
    fold = TF.ring_flash_fold_bf16_kernel if bf16 else TF.ring_flash_fold_kernel
    q = torch.zeros(H, per, D, device=cuda)
    k = torch.zeros_like(q)
    mask = torch.ones(per, N, dtype=torch.int8, device=cuda)
    scale = torch.ones(H, device=cuda)
    state = (torch.zeros(H, per, device=cuda),
             torch.zeros(H, per, device=cuda), torch.zeros_like(q))
    col0, metric = per, "euclidean"
    if bad == "col0":
        col0 = N - per + 1
    elif bad == "negative col0":
        col0 = -1
    elif bad == "mask rows":
        mask = mask[:-1]
    elif bad == "mask dtype":
        mask = mask.float()
    elif bad == "q dtype":
        q = q.double()
    elif bad == "k shape":
        k = k[:, :-1]
    elif bad == "D":
        q = k = torch.zeros(H, per, 129, device=cuda)
        state = state[:2] + (torch.zeros_like(q),)
    elif bad == "state":
        state = None
    elif bad == "state shape":
        state = (state[0][:, :-1],) + state[1:]
    elif bad == "metric":
        metric = "manhattan"
    elif bad == "device":
        scale = scale.cpu()
    stream = torch.cuda.current_stream(cuda)
    before = fold.launches
    with pytest.raises(ValueError):
        fold(q, k, q, mask, scale, state, q, col0, metric, False, False,
             stream)
    assert fold.launches == before


@pytest.mark.gpu
def test_ring_flash_refused_before_launch(cuda):
    """A mask column block past N and a missing state raise before any
    launch."""
    H, per, D = 2, 70, 16
    q = torch.zeros(H, per, D, device=cuda)
    mask = torch.ones(per, 2 * per, dtype=torch.int8, device=cuda)
    scale = torch.ones(H, device=cuda)
    state = (torch.zeros(H, per, device=cuda),
             torch.zeros(H, per, device=cuda), torch.zeros_like(q))
    stream = torch.cuda.current_stream(cuda)
    before = TF.ring_flash_fold_kernel.launches
    with pytest.raises(ValueError):
        TF.ring_flash_fold_kernel(q, q, q, mask, scale, state, q, per + 1,
                                  "euclidean", True, False, stream)
    with pytest.raises(ValueError):
        TF.ring_flash_fold_kernel(q, q, q, mask, scale, None, q, 0,
                                  "euclidean", True, False, stream)
    assert TF.ring_flash_fold_kernel.launches == before


# -- the bf16 pair walks (B1, B2, B4, B5) at the densities they are built for

def sparse_mask(G, N, seed=0, deg=4):
    """int8 [G, N, N]: ~``deg`` uniform random keys a row (the model's
    graphs at ~deg / N density), and in every snapshot where N allows:
    a whole 64 x 64 tile (rows 0-63, keys 64-127), a tile holding one pair
    (rows 128-191, keys 0-63), an empty one between walked tiles (rows
    64-127, keys 192-255), rows 200-207 whose only keys lie in the
    last key tile (their row tile's last walked tile), rows past CAPR's
    128 list entries (rows 260-263, 150 keys each: the walk flushes
    before its end), dead rows (300-304 and the last row) and, in
    snapshot 0, a dead query tile (rows 384-447). Shared by the CPU
    test of the plain bf16 forms against JAX (test_torch_bf16_sparse.py)."""
    rng = np.random.default_rng(seed)
    mask = np.zeros((G, N, N), np.int8)
    for g in range(G):
        rows = np.repeat(np.arange(N), deg)
        mask[g, rows, rng.integers(0, N, rows.size)] = 1
        if N >= 128:
            mask[g, :64, 64:128] = 1
        if N >= 192:
            mask[g, 128:192, :64] = 0
            mask[g, 130, 17] = 1
        if N >= 256:
            mask[g, 64:128, 192:256] = 0
        last = (N - 1) // 64 * 64
        if N >= 208:
            mask[g, 200:208] = 0
            for r in range(200, 208):
                mask[g, r, rng.integers(last, N, 2)] = 1
        if N >= 264:
            for r in range(260, 264):
                mask[g, r, rng.choice(N, 150, replace=False)] = 1
        if N >= 305:
            mask[g, 300:305] = 0
        mask[g, N - 1] = 0
    if N >= 448:
        mask[0, 384:448] = 0
    return mask


def _sparse_inputs(G, H, N, D, Dv, metric, seed=0):
    """q and k (at BF16_QK_SCALE), v, `sparse_mask`, a bias on the mask's
    pairs, per-head scales and seeds."""
    rng = np.random.default_rng(seed + 400)
    q, k = (BF16_QK_SCALE * rng.standard_normal((G, H, N, D)).astype(
        np.float32) for _ in range(2))
    v = rng.standard_normal((G, H, N, Dv)).astype(np.float32)
    mask = sparse_mask(G, N, seed)
    bias = np.where(mask != 0, rng.standard_normal((G, N, N)),
                    0.0).astype(np.float32)
    q, k, v, mask, bias = (torch.from_numpy(a) for a in (q, k, v, mask, bias))
    if metric in FG._COSINE:
        q, k = FG._l2_normalize(q), FG._l2_normalize(k)
    scale = torch.linspace(0.7, 2.0, H)
    seeds = FG.biased_seeds(torch.tensor(
        [-7, 12345, 3, 99] * (G // 4 + 1), dtype=torch.int32)[:G], G, "cpu")
    return q, k, v, mask, bias, scale, seeds


def _pairwalk_vs_plain(cuda, G, H, N, D, Dv, metric, rate, seed=0):
    """B1's, B4's and B5's bf16 forms (the pair walks) through the public
    entries (``flash_geometric_fwd``, ``flash_biased_fwd`` with bf16=True)
    against the plain bf16 versions walking the same plan, under the bf16
    gates, the plain fp32 versions the witness; dead rows exactly 0 and
    LSE_DEAD; B1 bf16 launched once, then B4 bf16 and B5 bf16 once each,
    nothing else."""
    q, k, v, mask, bias, scale, seeds = (
        t.to(cuda) for t in _sparse_inputs(G, H, N, D, Dv, metric, seed))
    seed1 = seeds[:, 0].contiguous()
    plan = FG.make_block_plan(mask)
    dead = (mask == 0).all(-1)[:, None, :].expand(G, H, N)
    before = {k_.name: k_.launches for k_ in FG.KERNELS}
    out, lse = FG.flash_geometric_fwd(q, k, v, mask, *plan, metric=metric,
                                      scale=scale, seed=seed1,
                                      dropout_rate=rate, bf16=True)
    torch.cuda.synchronize()
    assert torch.all(out[dead] == 0) and torch.all(lse[dead] == FG.LSE_DEAD)
    p_out, p_lse = FG.flash_geometric_forward_plain(
        q, k, v, mask, metric, scale, rate, seed1, True, plan)
    f_out, _ = FG.flash_geometric_forward_plain(q, k, v, mask, metric, scale,
                                                rate, seed1)
    _bf16_gates(out[~dead], p_out[~dead], f_out[~dead])
    _bf16_gates(lse[~dead], p_lse[~dead], p_lse[~dead], witness=False)
    out, lse1, lse2 = FG.flash_biased_fwd(
        q, k, v, mask, bias, *plan, metric=metric, scale=scale,
        dropout_rate=rate, seeds=seeds, bf16=True)
    torch.cuda.synchronize()
    assert torch.all(out[dead] == 0) and torch.all(lse2[dead] == FG.LSE_DEAD)
    assert torch.all(lse1[dead] == FG.LSE_DEAD)
    p_lse1 = FG.flash_lse1_plain(q, k, mask, metric, scale, True)
    _bf16_gates(lse1[~dead], p_lse1[~dead], p_lse1[~dead], witness=False)
    fwd = (q, k, v, mask, bias, lse1, metric, scale, rate, seeds)
    p_out, p_lse2 = FG.flash_biased_forward_plain(*fwd, True, plan)
    f_out, _ = FG.flash_biased_forward_plain(*fwd)
    _bf16_gates(out[~dead], p_out[~dead], f_out[~dead])
    _bf16_gates(lse2[~dead], p_lse2[~dead], p_lse2[~dead], witness=False)
    launched = {k_.name: k_.launches - before[k_.name] for k_ in FG.KERNELS}
    expect = {k_.name: 0 for k_ in FG.KERNELS}
    expect.update({k_.name: 1 for k_ in (FG.flash_geometric_fwd_bf16_kernel,
                                         FG.flash_lse1_bf16_kernel,
                                         FG.flash_biased_fwd_bf16_kernel)})
    assert launched == expect


@pytest.mark.gpu
@pytest.mark.parametrize("N", [1000, 1536])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("metric", FG.MXU_METRICS)
def test_pairwalk_bf16_sparse(metric, rate, N, cuda):
    """The pair walks at sparse masks (`sparse_mask`): every metric,
    dropout off and on, N = 1000 (not a multiple of 16: the walk's byte
    loads) and 1536 (16-byte cp.async), H = 4 (8 rows a warp)."""
    _pairwalk_vs_plain(cuda, 2, 4, N, 16, 16, metric, rate)


@pytest.mark.gpu
@pytest.mark.parametrize("metric", ["scaled_dot_product", "gaussian_kernel"])
@pytest.mark.parametrize("D,Dv", [(8, 8), (12, 12), (7, 3), (128, 128)])
def test_pairwalk_bf16_sparse_head_dims(D, Dv, metric, cuda):
    """Head dims of the dense bf16 tests, dropout on; H = 3 (24 of a
    warp's lanes hold items), N = 1008 (16-byte loads, the last key tile
    ragged)."""
    _pairwalk_vs_plain(cuda, 1, 3, 1008, D, Dv, metric, 0.1, seed=1)


@pytest.mark.gpu
@pytest.mark.parametrize("H", [1, 4, 40])
def test_pairwalk_bf16_fold(H, cuda):
    """A 16-snapshot fold, as the model launches one layer over 2
    sequences of 8 snapshots, with dropout (each snapshot its seeds);
    H = 1 (32 rows a warp), 4, and 40 (two head groups: the mask is read
    once per group of 32 heads)."""
    _pairwalk_vs_plain(cuda, 16, H, 600, 16, 16, "euclidean", 0.1, seed=2)


def _pairwalk_bwd_vs_plain(cuda, G, H, N, D, Dv, metric, rate, seed=0):
    """B2's bf16 form (the backward pair walk) through
    ``flash_geometric_attention_bwd(..., fused=True, bf16=True)`` with the
    forward plan alone, on the plain bf16 forward's out and lse, against
    the plain bf16 backward under the bf16 gates (dscale, for gaussian
    and rbf, under the max gate alone), the plain fp32 backward the
    witness; an lse cotangent; dq exactly 0 on dead rows, dk and dv
    exactly 0 at keys no row reaches; B2 bf16 launched once, nothing
    else."""
    q, k, v, mask, _, scale, seeds = (
        t.to(cuda) for t in _sparse_inputs(G, H, N, D, Dv, metric, seed))
    seed1 = seeds[:, 0].contiguous()
    rng = np.random.default_rng(seed + 500)
    do, dl = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(cuda) for shape in ((G, H, N, Dv), (G, H, N)))
    plan = FG.make_block_plan(mask)
    need = metric in FG.SCALED_METRICS
    out, lse = FG.flash_geometric_forward_plain(
        q, k, v, mask, metric, scale, rate, seed1, True, plan)
    args = (q, k, v, mask, out, lse, do)
    before = {k_.name: k_.launches for k_ in FG.KERNELS}
    got = FG.flash_geometric_attention_bwd(
        *args, metric=metric, scale=scale, plan=plan, seed=seed1,
        dropout_rate=rate, need_dscale=need, fused=True, dlse=dl, bf16=True)
    torch.cuda.synchronize()
    launched = {k_.name: k_.launches - before[k_.name] for k_ in FG.KERNELS}
    expect = {k_.name: 0 for k_ in FG.KERNELS}
    expect[FG.flash_geometric_bwd_fused_bf16_kernel.name] = 1
    assert launched == expect
    dead = (mask == 0).all(-1)[:, None, :].expand(G, H, N)
    unreached = (mask == 0).all(-2)[:, None, :].expand(G, H, N)
    assert dead.any() and unreached.any()
    assert torch.all(got[0][dead] == 0)
    assert torch.all(got[1][unreached] == 0)
    assert torch.all(got[2][unreached] == 0)
    want = FG.flash_geometric_backward_plain(*args, metric, scale, rate,
                                             seed1, need, dl, True)
    f32 = FG.flash_geometric_backward_plain(*args, metric, scale, rate,
                                            seed1, need, dl)
    assert len(got) == (4 if need else 3)
    for i, (g, w, f) in enumerate(zip(got, want, f32)):
        _bf16_gates(g, w, f, witness=i < 3, mean=i < 3)


@pytest.mark.gpu
@pytest.mark.parametrize("N", [1000, 1536])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("metric", FG.MXU_METRICS)
def test_pairwalk_bf16_bwd_sparse(metric, rate, N, cuda):
    """The backward pair walk at sparse masks (`sparse_mask`), as
    `test_pairwalk_bf16_sparse`: every metric, dropout off and on, N =
    1000 (byte loads of the mask) and 1536, H = 4."""
    _pairwalk_bwd_vs_plain(cuda, 2, 4, N, 16, 16, metric, rate)


@pytest.mark.gpu
@pytest.mark.parametrize("metric", ["scaled_dot_product", "gaussian_kernel"])
@pytest.mark.parametrize("D,Dv", [(8, 8), (12, 12), (7, 3), (128, 128)])
def test_pairwalk_bf16_bwd_sparse_head_dims(D, Dv, metric, cuda):
    """Head dims of the dense bf16 tests, dropout on, H = 3, N = 1008:
    widths not a multiple of 4 take scalar gathers and atomics, and (128,
    128) sets the warp's shared memory past 48 KB."""
    _pairwalk_bwd_vs_plain(cuda, 1, 3, 1008, D, Dv, metric, 0.1, seed=1)


@pytest.mark.gpu
@pytest.mark.parametrize("H", [1, 4, 40])
def test_pairwalk_bf16_bwd_fold(H, cuda):
    """A 16-snapshot fold with dropout (each snapshot its seed), H = 1,
    4 and 40 (two head groups)."""
    _pairwalk_bwd_vs_plain(cuda, 16, H, 600, 16, 16, "euclidean", 0.1,
                           seed=2)


# -- the fp32 pair walks (B1, B2) at the same masks ---------------------------

def _pairwalk_fp32_vs_plain(cuda, G, H, N, D, Dv, metric, rate, seed=0):
    """B1 (the fp32 forward pair walk) through ``flash_geometric_fwd``
    against the plain fp32 forward at `sparse_mask`, within TOL of each
    output's largest entry (at least 1): fp32 on both sides, the walk's
    sums in another order (64-key online-softmax steps against one dense
    row); dead rows exactly 0 and LSE_DEAD; B1 launched once, nothing
    else."""
    q, k, v, mask, _, scale, seeds = (
        t.to(cuda) for t in _sparse_inputs(G, H, N, D, Dv, metric, seed))
    seed1 = seeds[:, 0].contiguous()
    plan = FG.make_block_plan(mask)
    dead = (mask == 0).all(-1)[:, None, :].expand(G, H, N)
    before = {k_.name: k_.launches for k_ in FG.KERNELS}
    out, lse = FG.flash_geometric_fwd(q, k, v, mask, *plan, metric=metric,
                                      scale=scale, seed=seed1,
                                      dropout_rate=rate)
    torch.cuda.synchronize()
    launched = {k_.name: k_.launches - before[k_.name] for k_ in FG.KERNELS}
    expect = {k_.name: 0 for k_ in FG.KERNELS}
    expect[FG.flash_geometric_fwd_kernel.name] = 1
    assert launched == expect
    assert dead.any()
    assert torch.all(out[dead] == 0) and torch.all(lse[dead] == FG.LSE_DEAD)
    p_out, p_lse = FG.flash_geometric_forward_plain(q, k, v, mask, metric,
                                                    scale, rate, seed1)
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()
    assert _close(out, p_out) <= TOL
    assert _close(lse[~dead], p_lse[~dead]) <= TOL


@pytest.mark.gpu
@pytest.mark.parametrize("N", [1000, 1536])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("metric", FG.MXU_METRICS)
def test_pairwalk_fp32_sparse(metric, rate, N, cuda):
    """The fp32 forward pair walk at sparse masks (`sparse_mask`): every
    metric, dropout off and on, N = 1000 (byte loads of the mask) and 1536
    (16-byte cp.async), H = 4 (8 rows a warp)."""
    _pairwalk_fp32_vs_plain(cuda, 2, 4, N, 16, 16, metric, rate)


@pytest.mark.gpu
@pytest.mark.parametrize("metric", ["scaled_dot_product", "gaussian_kernel"])
@pytest.mark.parametrize("D,Dv", [(16, 16), (8, 8), (12, 12), (7, 3),
                                  (128, 128)])
def test_pairwalk_fp32_sparse_head_dims(D, Dv, metric, cuda):
    """Head dims, dropout on, H = 3 (24 of a warp's lanes hold items), N =
    1008 (16-byte loads, the last key tile ragged): widths not a multiple
    of 4 take scalar gathers, and (128, 128) sets the warp's shared memory
    past 48 KB."""
    _pairwalk_fp32_vs_plain(cuda, 1, 3, 1008, D, Dv, metric, 0.1, seed=1)


@pytest.mark.gpu
@pytest.mark.parametrize("H", [1, 4, 40])
def test_pairwalk_fp32_fold(H, cuda):
    """A 16-snapshot fold with dropout (each snapshot its seed), H = 1 (32
    rows a warp), 4, and 40 (two head groups: the mask is read once per
    group of 32 heads)."""
    _pairwalk_fp32_vs_plain(cuda, 16, H, 600, 16, 16, "euclidean", 0.1,
                            seed=2)


@pytest.mark.gpu
@pytest.mark.parametrize("metric,rate", [("euclidean", 0.0),
                                         ("gaussian_kernel", 0.1)])
def test_pairwalk_fp32_deterministic(metric, rate, cuda):
    """The fp32 forward walk's out and lse are bit-identical over 20
    repeated calls: each row's sums run in its list's order, with no
    atomics."""
    G, H, N = 2, 4, 1008
    q, k, v, mask, _, scale, seeds = (
        t.to(cuda) for t in _sparse_inputs(G, H, N, 16, 16, metric, 3))
    seed1 = seeds[:, 0].contiguous()
    plan = FG.make_block_plan(mask)
    first = None
    for _ in range(20):
        got = FG.flash_geometric_fwd(q, k, v, mask, *plan, metric=metric,
                                     scale=scale, seed=seed1,
                                     dropout_rate=rate)
        if first is None:
            first = got
        for a, b in zip(got, first):
            assert torch.equal(a, b)


def _pairwalk_fp32_bwd_vs_plain(cuda, G, H, N, D, Dv, metric, rate, seed=0):
    """B2 (the fp32 backward pair walk) through
    ``flash_geometric_attention_bwd(..., fused=True)`` with the forward
    plan alone, on the plain fp32 forward's out and lse, against the plain
    fp32 backward within TOL of each output's largest entry (at least 1):
    fp32 on both sides, sums in another order (dk, dv and dscale by
    atomics); an lse cotangent; dq exactly 0 on dead rows, dk and dv
    exactly 0 at keys no row reaches; B2 launched once, nothing else."""
    q, k, v, mask, _, scale, seeds = (
        t.to(cuda) for t in _sparse_inputs(G, H, N, D, Dv, metric, seed))
    seed1 = seeds[:, 0].contiguous()
    rng = np.random.default_rng(seed + 500)
    do, dl = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(cuda) for shape in ((G, H, N, Dv), (G, H, N)))
    plan = FG.make_block_plan(mask)
    need = metric in FG.SCALED_METRICS
    out, lse = FG.flash_geometric_forward_plain(q, k, v, mask, metric, scale,
                                                rate, seed1)
    args = (q, k, v, mask, out, lse, do)
    before = {k_.name: k_.launches for k_ in FG.KERNELS}
    got = FG.flash_geometric_attention_bwd(
        *args, metric=metric, scale=scale, plan=plan, seed=seed1,
        dropout_rate=rate, need_dscale=need, fused=True, dlse=dl)
    torch.cuda.synchronize()
    launched = {k_.name: k_.launches - before[k_.name] for k_ in FG.KERNELS}
    expect = {k_.name: 0 for k_ in FG.KERNELS}
    expect[FG.flash_geometric_bwd_fused_kernel.name] = 1
    assert launched == expect
    dead = (mask == 0).all(-1)[:, None, :].expand(G, H, N)
    unreached = (mask == 0).all(-2)[:, None, :].expand(G, H, N)
    assert dead.any() and unreached.any()
    assert torch.all(got[0][dead] == 0)
    assert torch.all(got[1][unreached] == 0)
    assert torch.all(got[2][unreached] == 0)
    want = FG.flash_geometric_backward_plain(*args, metric, scale, rate,
                                             seed1, need, dl)
    assert len(got) == (4 if need else 3)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        assert _close(g, w) <= TOL


@pytest.mark.gpu
@pytest.mark.parametrize("N", [1000, 1536])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("metric", FG.MXU_METRICS)
def test_pairwalk_fp32_bwd_sparse(metric, rate, N, cuda):
    """The fp32 backward pair walk at sparse masks (`sparse_mask`), as
    `test_pairwalk_fp32_sparse`: every metric, dropout off and on, N =
    1000 and 1536, H = 4, dscale for gaussian and rbf."""
    _pairwalk_fp32_bwd_vs_plain(cuda, 2, 4, N, 16, 16, metric, rate)


@pytest.mark.gpu
@pytest.mark.parametrize("metric", ["scaled_dot_product", "gaussian_kernel"])
@pytest.mark.parametrize("D,Dv", [(16, 16), (8, 8), (12, 12), (7, 3),
                                  (128, 128)])
def test_pairwalk_fp32_bwd_sparse_head_dims(D, Dv, metric, cuda):
    """Head dims, dropout on, H = 3, N = 1008: widths not a multiple of 4
    take scalar gathers and atomics, and (128, 128) sets the warp's
    shared memory past 48 KB (53 KB at H = 3)."""
    _pairwalk_fp32_bwd_vs_plain(cuda, 1, 3, 1008, D, Dv, metric, 0.1,
                                seed=1)


@pytest.mark.gpu
@pytest.mark.parametrize("H", [1, 4, 40])
def test_pairwalk_fp32_bwd_fold(H, cuda):
    """A 16-snapshot fold with dropout (each snapshot its seed), H = 1,
    4 and 40 (two head groups)."""
    _pairwalk_fp32_bwd_vs_plain(cuda, 16, H, 600, 16, 16, "euclidean", 0.1,
                                seed=2)


# -- the fp32 edge-biased forward's pair walks (B4, B5) at the same masks -----

def _biased_fwd_fp32(q, k, v, mask, bias, plan, metric, scale, rate, seeds):
    """(out, lse1, lse2) of the fp32 B4 and B5 walks through the public
    entry ``flash_biased_fwd``."""
    return FG.flash_biased_fwd(q, k, v, mask, bias, *plan, metric=metric,
                               scale=scale, dropout_rate=rate, seeds=seeds)


def _pairwalk_fp32_biased_vs_plain(cuda, G, H, N, D, Dv, metric, rate,
                                   seed=0):
    """B4 and B5 (the fp32 forward pair walks) through
    ``flash_biased_fwd`` at `sparse_mask` with a N(0, 1) bias at the
    mask's pairs: lse1 against the plain fp32 lse1, out and lse2 against
    the plain fp32 second walk on the walk's lse1, each within TOL of its
    largest entry (at least 1): fp32 on both sides, the walks' sums in
    another order; dead rows exactly 0 and LSE_DEAD; B4 and B5 launched
    once each, nothing else."""
    q, k, v, mask, bias, scale, seeds = (
        t.to(cuda) for t in _sparse_inputs(G, H, N, D, Dv, metric, seed))
    plan = FG.make_block_plan(mask)
    dead = (mask == 0).all(-1)[:, None, :].expand(G, H, N)
    before = {k_.name: k_.launches for k_ in FG.KERNELS}
    out, lse1, lse2 = _biased_fwd_fp32(q, k, v, mask, bias, plan, metric,
                                       scale, rate, seeds)
    torch.cuda.synchronize()
    launched = {k_.name: k_.launches - before[k_.name] for k_ in FG.KERNELS}
    expect = {k_.name: 0 for k_ in FG.KERNELS}
    expect.update({k_.name: 1 for k_ in (FG.flash_lse1_kernel,
                                         FG.flash_biased_fwd_kernel)})
    assert launched == expect
    assert dead.any()
    assert torch.all(out[dead] == 0)
    assert torch.all(lse1[dead] == FG.LSE_DEAD)
    assert torch.all(lse2[dead] == FG.LSE_DEAD)
    p_lse1 = FG.flash_lse1_plain(q, k, mask, metric, scale)
    p_out, p_lse2 = FG.flash_biased_forward_plain(q, k, v, mask, bias, lse1,
                                                  metric, scale, rate, seeds)
    for t in (out, lse1, lse2):
        assert torch.isfinite(t).all()
    assert _close(lse1[~dead], p_lse1[~dead]) <= TOL
    assert _close(out, p_out) <= TOL
    assert _close(lse2[~dead], p_lse2[~dead]) <= TOL


@pytest.mark.gpu
@pytest.mark.parametrize("N", [1000, 1536])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("metric", FG.MXU_METRICS)
def test_pairwalk_fp32_biased_fwd_sparse(metric, rate, N, cuda):
    """The fp32 B4 and B5 walks at sparse masks (`sparse_mask`): every
    metric, both dropouts off and on, N = 1000 (byte loads of the mask)
    and 1536 (16-byte cp.async), H = 4 (8 rows a warp); rows past a
    list's 64 entries flush before their end, so B5's running max moves
    across flushes."""
    _pairwalk_fp32_biased_vs_plain(cuda, 2, 4, N, 16, 16, metric, rate)


@pytest.mark.gpu
@pytest.mark.parametrize("metric", ["scaled_dot_product", "gaussian_kernel"])
@pytest.mark.parametrize("D,Dv,H", [(8, 8, 3), (12, 12, 3), (7, 3, 3),
                                    (128, 128, 3), (128, 128, 1)])
def test_pairwalk_fp32_biased_fwd_head_dims(D, Dv, H, metric, cuda):
    """Head dims, dropout on, N = 1008 (16-byte loads, the last key tile
    ragged): widths not a multiple of 4 take scalar gathers, and (128,
    128) sets the warp's shared memory past 48 KB (57 KB at H = 1, the
    largest)."""
    _pairwalk_fp32_biased_vs_plain(cuda, 1, H, 1008, D, Dv, metric, 0.1,
                                   seed=1)


@pytest.mark.gpu
@pytest.mark.parametrize("H", [1, 4, 40])
def test_pairwalk_fp32_biased_fwd_fold(H, cuda):
    """A 16-snapshot fold with dropout (each snapshot its two seeds), H =
    1 (32 rows a warp), 4, and 40 (two head groups: the mask is read once
    per group of 32 heads)."""
    _pairwalk_fp32_biased_vs_plain(cuda, 16, H, 600, 16, 16, "euclidean",
                                   0.1, seed=2)


@pytest.mark.gpu
@pytest.mark.parametrize("metric,rate", [("euclidean", 0.0),
                                         ("gaussian_kernel", 0.1)])
def test_pairwalk_fp32_biased_fwd_deterministic(metric, rate, cuda):
    """The fp32 B4 and B5 walks' out, lse1 and lse2 are bit-identical over
    20 repeated calls: each row's sums run in its list's order, with no
    atomics."""
    G, H, N = 2, 4, 1008
    q, k, v, mask, bias, scale, seeds = (
        t.to(cuda) for t in _sparse_inputs(G, H, N, 16, 16, metric, 3))
    plan = FG.make_block_plan(mask)
    first = None
    for _ in range(20):
        got = _biased_fwd_fp32(q, k, v, mask, bias, plan, metric, scale,
                               rate, seeds)
        if first is None:
            first = got
        for a, b in zip(got, first):
            assert torch.equal(a, b)


# -- the biased backward's pair walks (the row walk, the key walk), in bf16
# and fp32 --------------------------------------------------------------------

# the fp32 row walk (B6 and B7a) and key walk (B7b)
BIASED_WALKS_FP32 = (FG.flash_biased_bwd_row_kernel,
                     FG.flash_biased_bwd_key_kernel)


def _pairwalk_biased_vs_plain(cuda, G, H, N, D, Dv, metric, rate, seed=0,
                              bf16=True):
    """The row walk (B6 and B7a) and the key walk (B7b) through
    ``flash_biased_attention_bwd(..., bf16=bf16)`` on the plain forward's
    out, lse1 and lse2 (walking the plan) at `sparse_mask`: with ``bf16``
    against the plain bf16 biased backward under the bf16 gates (dscale,
    for gaussian and rbf, under the max gate alone), the plain fp32
    backward the witness; in fp32 against the plain fp32 backward within
    TOL of each output's largest entry (at least 1). dq, dk, dv, dB at the
    mask's pairs; dq exactly 0 on dead rows and dk, dv exactly 0 at keys
    no row reaches; each walk launched once, nothing else."""
    q, k, v, mask, bias, scale, seeds = (
        t.to(cuda) for t in _sparse_inputs(G, H, N, D, Dv, metric, seed))
    # keys no row reaches, in a middle key tile and the ragged last one
    mask[:, :, [150, 151, N - 5]] = 0
    bias[:, :, [150, 151, N - 5]] = 0
    do = torch.from_numpy(np.random.default_rng(seed + 600).standard_normal(
        (G, H, N, Dv)).astype(np.float32)).to(cuda)
    plan, plan_t = FG.make_block_plans_from_mask(mask)
    need = metric in FG.SCALED_METRICS
    lse1 = FG.flash_lse1_plain(q, k, mask, metric, scale, bf16)
    out, lse2 = FG.flash_biased_forward_plain(q, k, v, mask, bias, lse1,
                                              metric, scale, rate, seeds,
                                              bf16, plan)
    before = {k_.name: k_.launches for k_ in FG.KERNELS}
    got = FG.flash_biased_attention_bwd(
        q, k, v, bias, mask, out, lse1, lse2, do, metric=metric, scale=scale,
        plan=plan, plan_t=plan_t, seeds=seeds, dropout_rate=rate,
        need_dscale=need, bf16=bf16)
    torch.cuda.synchronize()
    launched = {k_.name: k_.launches - before[k_.name] for k_ in FG.KERNELS}
    expect = {k_.name: 0 for k_ in FG.KERNELS}
    expect.update({k_.name: 1 for k_ in (BIASED_BF16[2:] if bf16
                                         else BIASED_WALKS_FP32)})
    assert launched == expect
    dead = (mask == 0).all(-1)[:, None, :].expand(G, H, N)
    unreached = (mask == 0).all(-2)[:, None, :].expand(G, H, N)
    assert dead.any() and unreached.any()
    assert torch.all(got[0][dead] == 0)
    assert torch.all(got[1][unreached] == 0)
    assert torch.all(got[2][unreached] == 0)
    stats = (q, k, v, mask, bias, out, lse1, lse2, do, metric, scale, rate,
             seeds, need)
    want = FG.flash_biased_backward_plain(*stats, bf16=bf16)
    on = mask != 0
    assert len(got) == (5 if need else 4)
    if not bf16:
        for g, w in zip(got[:3] + (got[3][on],) + got[4:],
                        want[:3] + (want[3][on],) + want[4:]):
            assert torch.isfinite(g).all()
            assert _close(g, w) <= TOL
        return
    f32 = FG.flash_biased_backward_plain(*stats)
    for g, w, f in zip(got[:3], want[:3], f32[:3]):
        _bf16_gates(g, w, f)
    _bf16_gates(got[3][on], want[3][on], f32[3][on])
    if need:
        _bf16_gates(got[4], want[4], f32[4], witness=False, mean=False)


@pytest.mark.gpu
@pytest.mark.parametrize("N", [330, 1008, 1536])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("metric", FG.MXU_METRICS)
def test_pairwalk_biased_bf16_sparse(metric, rate, N, cuda):
    """The two bf16 walks at sparse masks (`sparse_mask`): every metric,
    dropout off and on, N = 330 (the mask's rows past 128 keys reach most
    keys; byte loads), 1008 (16-byte loads, the last tile ragged) and
    1536 (a multiple of 64), H = 4."""
    _pairwalk_biased_vs_plain(cuda, 2, 4, N, 16, 16, metric, rate)


@pytest.mark.gpu
@pytest.mark.parametrize("N", [330, 1008, 1536])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("metric", FG.MXU_METRICS)
def test_pairwalk_fp32_biased_bwd_sparse(metric, rate, N, cuda):
    """The two fp32 walks at `test_pairwalk_biased_bf16_sparse`'s masks,
    held to the plain fp32 biased backward within TOL."""
    _pairwalk_biased_vs_plain(cuda, 2, 4, N, 16, 16, metric, rate,
                              bf16=False)


@pytest.mark.gpu
@pytest.mark.parametrize("metric", ["scaled_dot_product", "gaussian_kernel"])
@pytest.mark.parametrize("D,Dv", [(16, 16), (8, 8), (12, 12), (7, 3),
                                  (128, 128)])
def test_pairwalk_biased_bf16_head_dims(D, Dv, metric, cuda):
    """Head dims of the dense bf16 tests, dropout on, H = 3 (24 of a
    warp's lanes hold items), N = 1008: widths not a multiple of 4 take
    scalar gathers, and (128, 128) splits the key walk's 64-key tile over
    blocks to fit its shared memory."""
    _pairwalk_biased_vs_plain(cuda, 1, 3, 1008, D, Dv, metric, 0.1, seed=1)


@pytest.mark.gpu
@pytest.mark.parametrize("metric", ["scaled_dot_product", "gaussian_kernel"])
@pytest.mark.parametrize("D,Dv", [(16, 16), (8, 8), (12, 12), (7, 3),
                                  (128, 128)])
def test_pairwalk_fp32_biased_bwd_head_dims(D, Dv, metric, cuda):
    """`test_pairwalk_biased_bf16_head_dims` for the fp32 walks."""
    _pairwalk_biased_vs_plain(cuda, 1, 3, 1008, D, Dv, metric, 0.1, seed=1,
                              bf16=False)


@pytest.mark.gpu
@pytest.mark.parametrize("H", [1, 4, 8, 40])
def test_pairwalk_biased_bf16_fold(H, cuda):
    """A 16-snapshot fold with dropout (each snapshot its seeds), H = 1
    (32 rows a row walk warp, 2 warps a key walk block), 4, 8 (16 warps a
    key walk block) and 40 (two row walk launches adding into dB, five key
    walk head groups)."""
    _pairwalk_biased_vs_plain(cuda, 16, H, 600, 16, 16, "gaussian_kernel",
                              0.1, seed=2)


@pytest.mark.gpu
@pytest.mark.parametrize("H", [1, 4, 8, 40])
def test_pairwalk_fp32_biased_bwd_fold(H, cuda):
    """`test_pairwalk_biased_bf16_fold` for the fp32 walks: at H = 40 two
    row walk launches add into dB."""
    _pairwalk_biased_vs_plain(cuda, 16, H, 600, 16, 16, "gaussian_kernel",
                              0.1, seed=2, bf16=False)


def _pairwalk_biased_repeats(cuda, metric, rate, bf16):
    """dq, dk, dv, dB (at the mask's pairs) and dscale of the two walks
    are bit-identical over 20 repeated calls: neither sums with
    atomics."""
    G, H, N = 2, 4, 1008
    q, k, v, mask, bias, scale, seeds = (
        t.to(cuda) for t in _sparse_inputs(G, H, N, 16, 16, metric, 3))
    do = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (G, H, N, 16)).astype(np.float32)).to(cuda)
    plan, plan_t = FG.make_block_plans_from_mask(mask)
    need = metric in FG.SCALED_METRICS
    lse1 = FG.flash_lse1_plain(q, k, mask, metric, scale, bf16)
    out, lse2 = FG.flash_biased_forward_plain(q, k, v, mask, bias, lse1,
                                              metric, scale, rate, seeds,
                                              bf16, plan)
    on = mask != 0
    first = None
    for _ in range(20):
        got = FG.flash_biased_attention_bwd(
            q, k, v, bias, mask, out, lse1, lse2, do, metric=metric,
            scale=scale, plan=plan, plan_t=plan_t, seeds=seeds,
            dropout_rate=rate, need_dscale=need, bf16=bf16)
        got = [t.clone() for t in got[:3]] + [got[3][on]] + list(got[4:])
        if first is None:
            first = got
        for a, b in zip(got, first):
            assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("metric,rate", [("euclidean", 0.0),
                                         ("gaussian_kernel", 0.1)])
def test_pairwalk_biased_bf16_deterministic(metric, rate, cuda):
    """The bf16 walks, 20 calls bit for bit (`_pairwalk_biased_repeats`)."""
    _pairwalk_biased_repeats(cuda, metric, rate, True)


@pytest.mark.gpu
@pytest.mark.parametrize("metric,rate", [("euclidean", 0.0),
                                         ("gaussian_kernel", 0.1)])
def test_pairwalk_fp32_biased_bwd_deterministic(metric, rate, cuda):
    """The fp32 walks, 20 calls bit for bit (`_pairwalk_biased_repeats`)."""
    _pairwalk_biased_repeats(cuda, metric, rate, False)


def _unset_db_step(cuda, cfg, row):
    """The row walk leaves dB unset off the mask's pairs, and the model
    reads it only at its valid edges (through `edge_bias_matrix`'s
    select): with the allocator's memory filled with NaN first, one
    TAGANTrainer step of the edge-feature model ``cfg`` on a batch with
    padded edges (at (0, 0)) and a padded snapshot launches ``row`` once
    a layer; returns the card's and the CPU's gradients, the plain
    contractions pinned to fp32 on both sides."""
    from tagan_torch.core.module import default_matmul_precision
    seqs = _edge_seqs(np.random.default_rng(6), 100, 800, 3, 2, short=True)
    batch, labels, smask = next(iter(pt.TemporalGraphDataLoader(
        pt.TemporalGraphDataset(seqs, [1.0, 0.0]), batch_size=2,
        dense_adj=False)))
    assert not bool(batch.edge_mask[1, -1].any())
    N = batch.max_nodes
    nan = torch.full((4 * batch.x.shape[0] * batch.x.shape[1] * N * N,),
                     float("nan"), device=cuda)
    del nan
    got = {}
    for dev in ("cuda", "cpu"):
        model = pt.TAGAN(cfg, device=dev,
                         generator=torch.Generator().manual_seed(0))
        model.precision = lambda: default_matmul_precision("highest")
        tr = pt.TAGANTrainer(model, pt.ExperimentConfig(model=cfg))
        before = row.launches
        loss, _ = tr._loss(batch, labels, smask, True)
        loss.backward()
        assert row.launches - before == (cfg.num_layers if dev == "cuda"
                                         else 0)
        got[dev] = {n_: p.grad.detach().cpu().clone()
                    for n_, p in model.named_parameters()}
    return got["cuda"], got["cpu"]


@pytest.mark.gpu
def test_pairwalk_biased_bf16_unset_db_never_read(cuda):
    """`_unset_db_step` for the bf16 edge-feature model: finite gradients
    within `BF16_EDGE_GRAD` of the CPU's, each over its largest entry, as
    in `test_edge_bf16_trainer_step_on_gpu_matches_cpu`."""
    card, cpu = _unset_db_step(cuda, _bf16_model_cfg(
        edge_feature_dim=4, use_edge_features=True),
        FG.flash_biased_bwd_row_bf16_kernel)
    for name, g in cpu.items():
        if name in ("temporal_attention.k.b",
                    "temporal_attention.time_encoding.basis_proj.b",
                    "temporal_attention.time_q_proj.b"):
            continue    # zero in exact arithmetic: fp32 noise
        assert torch.isfinite(card[name]).all(), name
        err = (card[name] - g).abs().max()
        assert err <= BF16_EDGE_GRAD * g.abs().max(), name


@pytest.mark.gpu
def test_pairwalk_fp32_biased_bwd_unset_db_never_read(cuda):
    """`_unset_db_step` for the fp32 edge-feature model: finite gradients
    within TOL of the CPU's (`_grads_close`)."""
    card, cpu = _unset_db_step(cuda, _bf16_model_cfg(
        edge_feature_dim=4, use_edge_features=True, bf16_matmul=False),
        FG.flash_biased_bwd_row_kernel)
    _grads_close(card, cpu)


# -- the dense two-walk backward (B3a, B3b): a row walk and a key walk --------

def two_walk_mask(G, N, seed=0):
    """`sparse_mask` with the key walk's cases besides the row walk's: an
    empty key strip (keys 128-191, for N >= 320; rows 260-263 then draw
    their 150 keys outside it, so that their lists still pass 2 CAPR) and
    keys past 128 rows (the 4 keys after the first of the last key tile,
    each in 150 live rows, so that the key walk flushes before its end).
    Shared by the CPU test of the plain two-walk backward against JAX
    (test_torch_dense_two_walk.py) and chip_smoke.py's phases 2b and 2h."""
    mask = sparse_mask(G, N, seed)
    rng = np.random.default_rng(seed + 900)
    last = (N - 1) // 64 * 64
    assert N >= 320 and N - last >= 5
    for g in range(G):
        mask[g, :, 128:192] = 0
        outside = np.r_[0:128, 192:N]
        for r in range(260, 264):
            mask[g, r] = 0
            mask[g, r, rng.choice(outside, 150, replace=False)] = 1
        live = np.flatnonzero(mask[g].any(-1))
        for c in range(last + 1, last + 5):
            mask[g, rng.choice(live, 150, replace=False), c] = 1
    return mask


def _two_walk_inputs(G, H, N, D, Dv, metric, rand, seed, qk_scale):
    """q and k (times ``qk_scale``), v, dO, the mask (`two_walk_mask`,
    or with ``rand`` `_bwd_inputs`'s: ~10% density, dead rows, an empty
    query tile and key strip), per-head scales, one seed a snapshot, and
    an lse cotangent (0.25 N(0, 1)), CPU tensors."""
    rng = np.random.default_rng(seed + 400)
    q, k = (qk_scale * rng.standard_normal((G, H, N, D)).astype(np.float32)
            for _ in range(2))
    v, do = (rng.standard_normal((G, H, N, Dv)).astype(np.float32)
             for _ in range(2))
    dlse = 0.25 * rng.standard_normal((G, H, N)).astype(np.float32)
    mask = (_bwd_inputs(G, H, N, D, Dv, seed)[3].numpy() if rand
            else two_walk_mask(G, N, seed))
    q, k, v, do, dlse, mask = (torch.from_numpy(a)
                               for a in (q, k, v, do, dlse, mask))
    if metric in FG._COSINE:
        q, k = FG._l2_normalize(q), FG._l2_normalize(k)
    scale = torch.linspace(0.7, 2.0, H)
    seeds = torch.tensor([-7, 12345, 3, 99] * (G // 4 + 1),
                         dtype=torch.int32)[:G]
    return q, k, v, do, dlse, mask, scale, seeds


def dense_two_walk_check(dev, bf16, G, H, N, D, Dv, metric, rate, seed=3,
                         repeats=1, rand=False):
    """B3a then B3b (``bf16``: their bf16 forms), the row and key pair
    walks, on `_two_walk_inputs` (q and k at ``BF16_QK_SCALE`` in bf16),
    the plain forward's (out, lse) with an lse cotangent on live rows and
    one live row's lse set to ``LSE_DEAD`` (p = 0 there, not NaN), the
    forward plan and the transposed plan from the mask, against the plain
    backward's dq, dk, dv and, where the metric has a scale, dscale:
    within TOL of each output's largest entry (at least 1) in fp32, under
    the bf16 gates in bf16 (the plain fp32 backward the witness; dscale,
    a sum of terms that cancel, under the max gate alone). Their outputs
    are allocated NaN-filled (`nan_empty`) and come back set everywhere:
    dq exactly 0 on dead rows, dk and dv exactly 0 at keys no row
    reaches; the call launches each walk once and nothing else;
    ``repeats`` calls are bit-identical. Shared by chip_smoke.py's phases
    2b and 2h. Returns {output: max abs error} (fp32) or {output: (max
    abs error, max error, mean error, witness)} (bf16)."""
    q, k, v, do, dlse, mask, scale, seeds = (
        t.to(dev) for t in _two_walk_inputs(
            G, H, N, D, Dv, metric, rand, seed,
            BF16_QK_SCALE if bf16 else 1.0))
    plan, plan_t = FG.make_block_plans_from_mask(mask)
    out, lse = (t.contiguous() for t in FG.flash_geometric_forward_plain(
        q, k, v, mask, metric, scale, rate, seeds, bf16, plan))
    live = (mask != 0).any(-1)
    dead_listed = int(live[0].nonzero()[0])
    lse[:, :, dead_listed] = FG.LSE_DEAD
    dlse = dlse * live[:, None]
    delta = FG._delta(do, out, dlse).contiguous()
    need = metric in FG.SCALED_METRICS
    dq_k, dkv_k = (
        (FG.flash_geometric_bwd_dq_bf16_kernel,
         FG.flash_geometric_bwd_dkv_bf16_kernel) if bf16 else
        (FG.flash_geometric_bwd_dq_kernel, FG.flash_geometric_bwd_dkv_kernel))

    def call():
        common = (q, k, v, mask, do, lse, delta)
        with nan_empty():
            dq, dsc = dq_k(*common, *plan, metric, scale, seeds, rate, need)
            dk, dv = dkv_k(*common, *plan_t, metric, scale, seeds, rate)
        return dq, dk, dv, dsc
    before = {k_.name: k_.launches for k_ in FG.KERNELS}
    got = call()
    torch.cuda.synchronize()
    launched = {k_.name: k_.launches - before[k_.name] for k_ in FG.KERNELS}
    assert launched == {k_.name: int(k_ in (dq_k, dkv_k))
                        for k_ in FG.KERNELS}
    assert all(bool(torch.isfinite(t).all()) for t in got[:3])
    assert (got[3] is not None) == need
    assert not need or torch.isfinite(got[3]).all()
    dead = ~live[:, None, :].expand(G, H, N)
    unreached = ~(mask != 0).any(-2)[:, None, :].expand(G, H, N)
    assert dead.any() and unreached.any()
    assert torch.all(got[0][dead] == 0)
    assert torch.all(got[1][unreached] == 0)
    assert torch.all(got[2][unreached] == 0)
    for _ in range(repeats - 1):
        again = call()
        for a, b in zip(again, got):
            assert (a is None and b is None) or torch.equal(a, b)
    rest = (q, k, v, mask, out, lse, do, metric, scale, rate, seeds, need,
            dlse)
    want = FG.flash_geometric_backward_plain(*rest, bf16)
    names = ("dq", "dk", "dv", "dscale")[:4 if need else 3]
    if not bf16:
        for g, w in zip(got, want[:len(names)]):
            assert _close(g, w) <= TOL
        return {n: (g - w).abs().max().item()
                for n, g, w in zip(names, got, want)}
    f32 = FG.flash_geometric_backward_plain(*rest)
    res = {}
    for i, n in enumerate(names):
        _bf16_gates(got[i], want[i], f32[i], witness=i < 3, mean=i < 3)
        m = want[i].abs().max().clamp(min=1e-30)
        e = (got[i] - want[i]).abs()
        res[n] = (e.max().item(), (e.max() / m).item(),
                  (e.mean() / m).item(),
                  ((f32[i] - want[i]).abs().mean() / m).item())
    return res


@pytest.mark.gpu
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("N", [1000, 1536])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("metric", FG.MXU_METRICS)
def test_two_walk_sparse(metric, rate, N, bf16, cuda):
    """B3a and B3b in both precisions at `two_walk_mask`'s cases: every
    metric, dropout off and on, N = 1000 (byte loads of the mask) and 1536
    (16-byte copies), H = 4, dscale at gaussian and rbf
    (`dense_two_walk_check`)."""
    dense_two_walk_check(cuda, bf16, 2, 4, N, 16, 16, metric, rate)


@pytest.mark.gpu
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("metric", FG.MXU_METRICS)
def test_two_walk_random_mask(metric, rate, bf16, cuda):
    """The same at `_backward_vs_plain`'s inputs' mask (~10% density:
    every tile walked, rows past 2 CAPR keys; dead rows, an empty query
    tile and key strip), N = 150 (a ragged last tile), D != Dv."""
    dense_two_walk_check(cuda, bf16, 2, 3, 150, 16, 8, metric, rate,
                         rand=True)


@pytest.mark.gpu
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("D,Dv", [(7, 3), (8, 8), (12, 12), (40, 72),
                                  (128, 128)])
def test_two_walk_head_dims(D, Dv, bf16, cuda):
    """Head dims whose sqrt is not a power of two, D != Dv, odd widths (no
    16-byte gathers), and the widest, (128, 128), whose items take a
    row warp's shared memory past 48 KB and halve the key walk's block."""
    dense_two_walk_check(cuda, bf16, 1, 3, 1008, D, Dv, "gaussian_kernel",
                         0.1, seed=1)


@pytest.mark.gpu
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("D,metric", [(16, "gaussian_kernel"),
                                      (128, "scaled_dot_product")])
def test_two_walk_fold(D, metric, bf16, cuda):
    """A fold of 33 heads: two head groups of the row walk (a warp's 32
    items, the second group of one head, grid blocks) and five of the key
    walk (KEY_HG = 8 heads a block), at head dim 16 with dscale, and at
    128 at the scaled dot: there the gaussian's scores exp(-|q - k|^2 /
    2 sigma^2) vanish (|q - k|^2 ~ 64 at q and k of 0.5 N(0, 1)), so
    over 33 heads its bf16 and fp32 gradients lie closer than the bf16
    witness's floor (a mean 7.8e-6 of the largest entry, against 1e-5),
    while the scaled dot's scores stay of order 1."""
    dense_two_walk_check(cuda, bf16, 2, 33, 1008, D, D, metric, 0.1,
                         seed=5)


@pytest.mark.gpu
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("metric,rate", [("euclidean", 0.0),
                                         ("gaussian_kernel", 0.1)])
def test_two_walk_deterministic(metric, rate, bf16, cuda):
    """dq, dk, dv and dscale are bit-identical over 20 calls: the walks
    sum in their lists' order and have no atomic."""
    dense_two_walk_check(cuda, bf16, 2, 4, 1008, 16, 16, metric, rate,
                         seed=4, repeats=20)


@pytest.mark.gpu
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("fault", ["jlist", "jcount", "ilist", "icount"])
def test_two_walk_bad_plan_raises_before_launch(fault, bf16, cuda):
    """N = 330 gives 6 tiles: a forward or transposed plan naming a tile
    past them, or a count past its width, is refused by
    ``flash_geometric_attention_bwd(..., fused=False)`` on the host, and
    no kernel is launched."""
    q, k, v, do, dlse, mask, scale, seeds = (
        t.to(cuda) for t in _two_walk_inputs(1, 2, 330, 16, 16,
                                             "dot_product", False, 0, 1.0))
    plan, plan_t = (tuple(p.clone() for p in pl)
                    for pl in FG.make_block_plans_from_mask(mask))
    lst, cnt = plan if fault[0] == "j" else plan_t
    if fault.endswith("list"):
        lst[0, 0, 0] = 6
    else:
        cnt[0, 0] = lst.shape[-1] + 1
    out, lse = FG.flash_geometric_forward_plain(q, k, v, mask, "dot_product",
                                                scale, 0.0, seeds)
    before = {k_.name: k_.launches for k_ in FG.KERNELS}
    with pytest.raises(ValueError, match="plan"):
        FG.flash_geometric_attention_bwd(
            q, k, v, mask, out, lse, do, metric="dot_product", scale=scale,
            plan=plan, plan_t=plan_t, seed=seeds, fused=False, dlse=dlse,
            bf16=bf16)
    assert {k_.name: k_.launches for k_ in FG.KERNELS} == before


# ---------------------------------------------------------------------------
# The reverse Cuthill-McKee slot order, the loss families and the
# attention weights on the card
# ---------------------------------------------------------------------------

def _banded_shuffled(n, band, T, seed):
    """A banded graph whose IDs are a seeded permutation of its rows: the
    sorted-ID slots scatter the band, RCM slots restore it."""
    rng = np.random.default_rng(seed)
    ids = rng.permutation(n)
    rows = np.arange(n)
    src = np.concatenate([rows[:-d] for d in range(1, band + 1)])
    dst = np.concatenate([rows[d:] for d in range(1, band + 1)])
    return [{"x": rng.standard_normal((n, 8)).astype(np.float32),
             "edge_index": np.stack([src, dst]), "node_ids": ids,
             "timestep": float(t)} for t in range(T)]


@pytest.mark.gpu
@pytest.mark.parametrize("backend", ["flash", "hybrid"])
def test_reordered_predictor_on_gpu_matches_cpu(backend, cuda):
    """``Predictor(reorder="rcm")``, card (kernels) vs CPU (plain
    versions), and against the sorted-ID slots on the card; B1 (B1c on
    the hybrid backend) once per layer per batch."""
    seqs = [_banded_shuffled(300, 4, 3, s) for s in range(3)]
    cfg = pt.TAGANConfig(hidden_dim=32, num_heads=2, num_layers=2,
                         node_feature_dim=8, output_dim=1, loss_type="bce",
                         dropout=0.0, spatial_backend=backend)
    kern = FG.flash_geometric_fwd_kernel if backend == "flash" \
        else FG.flash_geometric_fwd_compact_kernel
    got = {}
    for dev, reorder in (("cuda", "rcm"), ("cpu", "rcm"), ("cuda", None)):
        model = pt.TAGAN(cfg, device=dev,
                         generator=torch.Generator().manual_seed(0))
        before = {k.name: k.launches for k in FG.KERNELS}
        got[dev, reorder] = pt.Predictor(
            model, batch_size=2, reorder=reorder).predict_proba(seqs)
        launched = {k.name: k.launches - before[k.name] for k in FG.KERNELS}
        want = {k.name: 0 for k in FG.KERNELS}
        if dev == "cuda":
            want[kern.name] = 2 * cfg.num_layers
        assert launched == want
    card = got["cuda", "rcm"]
    assert np.isfinite(card).all() and card.shape == (3, 1)
    np.testing.assert_allclose(card, got["cpu", "rcm"], rtol=0, atol=TOL)
    np.testing.assert_allclose(card, got["cuda", None], rtol=0, atol=TOL)


def _loss_labels(loss_type, od, rng, n):
    if loss_type == "multi_label" or (loss_type == "focal" and od > 1):
        return [(rng.random(od) < 0.5).astype(np.float32) if loss_type ==
                "multi_label" else np.eye(od, dtype=np.float32)[i % od]
                for i in range(n)]
    if loss_type in ("bce", "classification", "focal"):
        return [float(i % 2) for i in range(n)]
    if od > 1:
        return [rng.standard_normal(od).astype(np.float32) for _ in range(n)]
    return [float(v) for v in rng.standard_normal(n)]


@pytest.mark.gpu
@pytest.mark.parametrize("loss_type,od", [
    ("focal", 1), ("focal", 3), ("mse", 1), ("regression", 2),
    ("multi_label", 3), ("sequence", 1), ("huber", 2), ("quantile", 1)])
def test_loss_family_trainer_step_on_gpu_matches_cpu(loss_type, od, cuda):
    """One TAGANTrainer step of the flash model with each loss family that
    ``compute_loss`` routes, card (kernels) vs CPU (plain versions): the
    loss and every gradient; B1 and the backward once per layer."""
    rng = np.random.default_rng(5)
    n, e, T = 100, 800, 3
    seqs = [[{"x": rng.standard_normal((n, 8)).astype(np.float32),
              "edge_index": rng.integers(0, n, (2, e)),
              "node_ids": np.arange(n), "timestep": float(t)}
             for t in range(T)] for _ in range(2)]
    cfg = pt.TAGANConfig(hidden_dim=32, num_heads=2, num_layers=2,
                         node_feature_dim=8, output_dim=od,
                         loss_type=loss_type, dropout=0.0,
                         spatial_backend="flash", focal_alpha=0.3)
    ds = pt.TemporalGraphDataset(seqs, _loss_labels(loss_type, od, rng, 2))
    batch, labels, smask = next(iter(pt.TemporalGraphDataLoader(
        ds, batch_size=2, dense_adj=False)))
    got = {}
    for dev in ("cuda", "cpu"):
        model = pt.TAGAN(cfg, device=dev,
                         generator=torch.Generator().manual_seed(0))
        tr = pt.TAGANTrainer(model, pt.ExperimentConfig(model=cfg))
        before = {k.name: k.launches for k in FG.KERNELS}
        loss, _ = tr._loss(batch, labels, smask, True)
        loss.backward()
        launched = {k.name: k.launches - before[k.name] for k in FG.KERNELS}
        got[dev] = (loss.item(), {name: p.grad.detach().cpu().clone()
                                  for name, p in model.named_parameters()})
        want = {k.name: 0 for k in FG.KERNELS}
        if dev == "cuda":
            for kern in ((FG.flash_geometric_fwd_kernel,
                          FG.flash_geometric_bwd_fused_kernel)
                         if FG.FUSED_BWD else
                         (FG.flash_geometric_fwd_kernel,
                          FG.flash_geometric_bwd_dq_kernel,
                          FG.flash_geometric_bwd_dkv_kernel)):
                want[kern.name] = cfg.num_layers
        assert launched == want
    assert np.isfinite(got["cuda"][0])
    assert abs(got["cuda"][0] - got["cpu"][0]) <= TOL
    _grads_close(got["cuda"][1], got["cpu"][1])


@pytest.mark.gpu
def test_infer_with_attention_on_gpu_matches_cpu(cuda):
    """``infer_with_attention`` of the flash model on a sequence packed
    with its dense adjacency (the dense path on both sides, no kernel),
    card vs CPU; without the adjacency it raises ValueError."""
    rng = np.random.default_rng(6)
    n, e, T = 120, 900, 3
    seq = [{"x": rng.standard_normal((n, 8)).astype(np.float32),
            "edge_index": rng.integers(0, n, (2, e)),
            "node_ids": np.arange(n), "timestep": float(t)}
           for t in range(T)]
    cfg = pt.TAGANConfig(hidden_dim=32, num_heads=2, num_layers=2,
                         node_feature_dim=8, output_dim=1, loss_type="bce",
                         dropout=0.0, spatial_backend="flash")
    packed = pt.build_sequence(seq)
    got = {}
    for dev in ("cuda", "cpu"):
        model = pt.TAGAN(cfg, device=dev,
                         generator=torch.Generator().manual_seed(0))
        before = {k.name: k.launches for k in FG.KERNELS}
        got[dev] = {k: v.cpu() for k, v in
                    model.infer_with_attention(packed).items()}
        assert {k.name: k.launches for k in FG.KERNELS} == before
        with pytest.raises(ValueError, match="dense_adj=False"):
            model.infer_with_attention(pt.build_sequence(seq,
                                                         dense_adj=False))
    assert got["cuda"]["geometric_attention_weights"].shape == (T, 2, n, n)
    assert got["cuda"]["temporal_attention_weights"].shape == (n, 2, T, T)
    for k, want in got["cpu"].items():
        assert (got["cuda"][k] - want).abs().max().item() <= TOL, k
