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
    with pytest.raises(NotImplementedError, match="backward"):
        kern(q.requires_grad_(), k, v, mask, jlist, jcount, "dot_product",
             ones, seed, 0.0)


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
