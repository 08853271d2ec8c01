"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs an NVIDIA GPU (marked ``gpu``) and skips
without one.

This file imports only torch, numpy and tagan_torch, so it also runs on a
machine without JAX, skipping the JAX-side conftest:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

import tagan_torch as pt
from tagan_torch.ops import flash_geometric as FG

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
    # each gradient against its own largest entry; one that is zero in
    # exact arithmetic (below 1e-6 of the largest gradient) is fp32 noise
    # on both sides
    noise = 1e-6 * max(g.abs().max() for g in got["cpu"][1].values())
    for name, g in got["cpu"][1].items():
        card = got["cuda"][1][name]
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
