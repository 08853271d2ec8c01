"""The plain bf16 backward (``flash_geometric_backward_plain(...,
bf16=True)``) against the Pallas fused backward with ``bf16=True``
(``flash_geometric_attention_bwd(..., fused=True)``, in interpret mode at
the port's 64 x 64 tile) at sparse masks: the function that B2's bf16
form, the backward pair walk of ``csrc/flash_pairwalk_bwd.cu``, is held
to on the card, in the cases it handles differently from a dense tile
walk. The mask comes from `tests.test_torch_gpu.sparse_mask`, which the
card's tests of the pair walks share: a few keys a row over several
tiles, a whole 64 x 64 tile, a tile holding one pair, an empty tile
between walked ones, rows past 128 keys (the walk flushes before its
end), dead rows, keys that no row reaches (their dk and dv are the
walk's zeroed outputs), N not a multiple of 16. Both sides take the same
out and lse (the port's plain bf16 forward), an lse cotangent and, for
gaussian and rbf, the scale's gradient. The gates are
`test_torch_bf16.py`'s."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tagan_tpu.ops.pallas import flash_geometric as JFG
from tagan_torch.ops import flash_geometric as TFG
from tests.test_torch_bf16 import MAX_TOL, _check, _gates
from tests.test_torch_gpu import sparse_mask

# torch's CPU operations on one thread: the tier-1 command runs six
# pytest workers on 8 cores, and torch's default of a thread per core
# oversubscribes them
torch.set_num_threads(1)

SEED = -987
# 330 rows: six row tiles, the last ragged, N % 16 == 10
N = 330


@pytest.fixture(scope="module")
def interpret():
    import jax.experimental.pallas as pl
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JFG.pl, "pallas_call",
                   functools.partial(pl.pallas_call, interpret=True))
        yield


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def sparse_bwd_inputs():
    """One snapshot of `sparse_mask`, 2 heads, q and k at half scale (as
    the card's bf16 gates take them), v, the cotangents of out and lse.
    At N = 330 the mask's rows past 128 keys reach every key, so three
    keys (two in the third key tile, one in the ragged last) are taken
    off every row."""
    rng = np.random.default_rng(12)
    H, D, Dv = 2, 16, 8
    q, k = (0.5 * rng.standard_normal((H, N, D)).astype(np.float32)
            for _ in range(2))
    v, do = (rng.standard_normal((H, N, Dv)).astype(np.float32)
             for _ in range(2))
    dlse = 0.25 * rng.standard_normal((H, N)).astype(np.float32)
    adj = sparse_mask(1, N, seed=3)[0] != 0
    adj[:, [150, 151, N - 5]] = False
    return q, k, v, do, dlse, adj


@functools.lru_cache(maxsize=None)
def _jax_bwd(metric, rate, scaled):
    """JAX's fused bf16 backward at 64 x 64 blocks, jitted once per
    case."""
    @jax.jit
    def ref(q, k, v, adj, out, lse, do, dlse, scale):
        return JFG.flash_geometric_attention_bwd(
            q, k, v, adj, out, lse, do, metric=metric,
            scale=scale if scaled else None, block_m=64, block_n=64,
            bf16=True, seed=jnp.asarray([SEED], jnp.int32),
            dropout_rate=rate, need_dscale=scaled, fused=True, dlse=dlse)
    return ref


def test_sparse_bwd_mask_cases(sparse_bwd_inputs):
    """The mask holds the backward's own cases besides the forward's:
    dead rows and keys that no row reaches, at 64 x 64 tiles a key strip
    with few pairs."""
    adj = sparse_bwd_inputs[-1]
    assert (~adj.any(-1)).sum() >= 6
    assert (~adj.any(0)).sum() >= 3
    assert (adj.sum(-1) > 128).sum() >= 4
    tiles = adj[:320, :320].reshape(5, 64, 5, 64).sum((1, 3))
    assert tiles[0, 1] == 64 * 64 and tiles[2, 0] == 1 and tiles[1, 3] == 0


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("metric", TFG.MXU_METRICS)
def test_plain_bf16_bwd_sparse_matches_jax(metric, rate, sparse_bwd_inputs,
                                           interpret):
    """dq, dk, dv (and dscale for gaussian and rbf) of the plain bf16
    backward against JAX's fused bf16 backward on the same out and lse:
    every metric, dropout off and on, an lse cotangent. The witness is the
    port's float32 plain backward; dq exactly 0 on dead rows and dk, dv
    exactly 0 at keys that no row reaches, on both sides."""
    q, k, v, do, dlse, adj = sparse_bwd_inputs
    if metric in TFG._COSINE:
        q = q / np.linalg.norm(q, axis=-1, keepdims=True)
        k = k / np.linalg.norm(k, axis=-1, keepdims=True)
    scaled = metric in TFG.SCALED_METRICS
    sc = np.asarray([0.7, 1.6], np.float32)
    args = tuple(_t(a)[None] for a in (q, k, v, adj))
    scale = _t(sc) if scaled else None
    seed_t = torch.tensor([SEED], dtype=torch.int32)
    out, lse = TFG.flash_geometric_forward_plain(
        *args, metric, scale, rate, seed_t, bf16=True)
    bwd = (out, lse, _t(do)[None])
    got = TFG.flash_geometric_backward_plain(
        *args, *bwd, metric, scale, rate, seed_t, scaled, _t(dlse)[None],
        bf16=True)
    f32 = TFG.flash_geometric_backward_plain(
        *args, *bwd, metric, scale, rate, seed_t, scaled, _t(dlse)[None])
    want = [np.asarray(a) for a in _jax_bwd(metric, rate, scaled)(
        *(jnp.asarray(a) for a in (q, k, v, adj, out[0].numpy(),
                                   lse[0].numpy(), do, dlse, sc)))]
    for name, g, w, f in zip(("dq", "dk", "dv"), got, want, f32):
        _check(name, g[0], w, f[0])
    if scaled:
        # two sums of many terms that cancel: the max gate alone, as in
        # test_torch_bf16.py
        assert _gates(got[3], want[3], f32[3])[0] <= MAX_TOL
    dead, unreached = ~adj.any(-1), ~adj.any(0)
    assert torch.all(got[0][0][:, dead] == 0)
    assert np.all(want[0][:, dead] == 0)
    for g, w in zip(got[1:3], want[1:3]):
        assert torch.all(g[0][:, unreached] == 0)
        assert np.all(w[:, unreached] == 0)
