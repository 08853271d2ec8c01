"""The plain fp32 forms of B1, B2, B4 and B5 against the Pallas kernels
with ``bf16=False`` (in interpret mode, at the port's 64 x 64 tile) at
sparse masks: the functions that the fp32 pair walks of
``csrc/flash_pairwalk_fwd.cu`` (B1, B4, B5) and
``csrc/flash_pairwalk_bwd.cu`` (B2) are held to on the card, in the
cases they handle differently from a dense tile walk. The masks come from `tests.test_torch_gpu.sparse_mask`,
which the card's tests of the pair walks share: a few keys a row over
several tiles, a whole 64 x 64 tile, a tile holding one pair, an empty
tile between walked ones, rows whose only keys lie in their row tile's
last walked tile, rows past 128 keys (the walk flushes before its end),
dead rows, keys that no row reaches, N not a multiple of 16.

fp32 on both sides, sums in another order: each output's max abs error
over its largest entry (at least 1) is held to ``TOL``, the tolerance of
`test_torch_backward.py`."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tagan_tpu.ops.pallas import flash_geometric as JFG
from tagan_torch.ops import flash_geometric as TFG
from tests.test_torch_gpu import sparse_mask

# torch's CPU operations on one thread: the tier-1 command runs six
# pytest workers on 8 cores, and torch's default of a thread per core
# oversubscribes them
torch.set_num_threads(1)

# fp32 on both sides, sums in another order; errors over each tensor's
# largest entry (at least 1), since gradients span many scales
TOL = 1e-4
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


def _err(got, want):
    want = np.asarray(want, np.float64)
    got = got.detach().numpy().astype(np.float64)
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


@pytest.fixture(scope="module")
def sparse_inputs():
    """One snapshot of `sparse_mask`, 2 heads, N(0, 1) q, k, v and do, an
    lse cotangent. At N = 330 the mask's rows past 128 keys reach every
    key, so three keys (two in the third key tile, one in the ragged
    last) are taken off every row."""
    rng = np.random.default_rng(16)
    H, D, Dv = 2, 16, 8
    q, k = (rng.standard_normal((H, N, D)).astype(np.float32)
            for _ in range(2))
    v, do = (rng.standard_normal((H, N, Dv)).astype(np.float32)
             for _ in range(2))
    dlse = 0.25 * rng.standard_normal((H, N)).astype(np.float32)
    adj = sparse_mask(1, N, seed=3)[0] != 0
    adj[:, [150, 151, N - 5]] = False
    return q, k, v, do, dlse, adj


def _case(metric, sparse_inputs):
    """The inputs of one metric (cosine: q and k L2-normalised) and its
    per-head scale (None where the metric takes none)."""
    q, k, v, do, dlse, adj = sparse_inputs
    if metric in TFG._COSINE:
        q = q / np.linalg.norm(q, axis=-1, keepdims=True)
        k = k / np.linalg.norm(k, axis=-1, keepdims=True)
    sc = np.asarray([0.7, 1.6], np.float32) \
        if metric in TFG.SCALED_METRICS else None
    return q, k, v, do, dlse, adj, sc


@functools.lru_cache(maxsize=None)
def _jax_fwd(metric, rate, scaled):
    @jax.jit
    def ref(q, k, v, adj, scale):
        return JFG._flash_forward(
            q, k, v, adj, metric=metric, block_m=64, block_n=64, bf16=False,
            dropout_rate=rate, return_lse=True,
            scale_param=scale if scaled else None,
            seed=jnp.asarray([SEED], jnp.int32))
    return ref


@functools.lru_cache(maxsize=None)
def _jax_bwd(metric, rate, scaled):
    @jax.jit
    def ref(q, k, v, adj, out, lse, do, dlse, scale):
        return JFG.flash_geometric_attention_bwd(
            q, k, v, adj, out, lse, do, metric=metric,
            scale=scale if scaled else None, block_m=64, block_n=64,
            bf16=False, seed=jnp.asarray([SEED], jnp.int32),
            dropout_rate=rate, need_dscale=scaled, fused=True, dlse=dlse)
    return ref


@functools.lru_cache(maxsize=None)
def _jax_biased_fwd(metric, rate, scaled):
    @jax.jit
    def ref(q, k, v, adj, bias, scale):
        return JFG._flash_biased_forward(
            q, k, v, adj, bias, metric=metric, block_m=64, block_n=64,
            bf16=False, dropout_rate=rate, return_lse=True,
            scale_param=scale if scaled else None,
            seeds=jnp.asarray([SEED, SEED ^ 0x5BD1E995], jnp.int32))
    return ref


@pytest.fixture(scope="module")
def sparse_bias(sparse_inputs):
    """A N(0, 1) bias at the mask's pairs (0 elsewhere), f32 [N, N]."""
    adj = sparse_inputs[-1]
    rng = np.random.default_rng(17)
    return np.where(adj, rng.standard_normal((N, N)), 0.0).astype(np.float32)


def test_sparse_fp32_mask_cases(sparse_inputs):
    """The mask holds the cases it is named for, at 64 x 64 tiles: a whole
    tile, a tile of one pair, an empty tile, rows past 128 keys, dead rows
    and keys that no row reaches."""
    adj = sparse_inputs[-1]
    tiles = adj[:320, :320].reshape(5, 64, 5, 64).sum((1, 3))
    assert tiles[0, 1] == 64 * 64 and tiles[2, 0] == 1 and tiles[1, 3] == 0
    assert (adj.sum(-1) > 128).sum() >= 4
    assert (~adj.any(-1)).sum() >= 6 and (~adj.any(0)).sum() >= 3
    assert np.median(adj.sum(-1)) <= 8


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("metric", TFG.MXU_METRICS)
def test_plain_fp32_sparse_matches_jax(metric, rate, sparse_inputs,
                                       interpret):
    """B1's out and lse of the plain fp32 forward against the Pallas
    kernel with bf16=False at 64 x 64 blocks: every metric, dropout off
    and on, per-head scales for gaussian and rbf; dead rows exactly 0 and
    LSE_DEAD on both sides."""
    q, k, v, _, _, adj, sc = _case(metric, sparse_inputs)
    jout, jlse = (np.asarray(a) for a in _jax_fwd(metric, rate,
                                                  sc is not None)(
        *(jnp.asarray(a) for a in (q, k, v, adj)),
        None if sc is None else jnp.asarray(sc)))
    out, lse = TFG.flash_geometric_forward_plain(
        *(_t(a)[None] for a in (q, k, v, adj)), metric,
        None if sc is None else _t(sc), rate,
        torch.tensor([SEED], dtype=torch.int32))
    live = adj.any(-1)
    assert _err(out[0], jout) <= TOL
    assert _err(lse[0][:, live], jlse[:, live]) <= TOL
    assert torch.all(out[0][:, ~live] == 0)
    assert torch.all(lse[0][:, ~live] == TFG.LSE_DEAD)
    assert np.all(jout[:, ~live] == 0)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("metric", TFG.MXU_METRICS)
def test_plain_fp32_bwd_sparse_matches_jax(metric, rate, sparse_inputs,
                                           interpret):
    """dq, dk, dv (and dscale for gaussian and rbf) of the plain fp32
    backward against JAX's fused backward with bf16=False on the same out
    and lse (the port's plain fp32 forward): every metric, dropout off
    and on, an lse cotangent; dq exactly 0 on dead rows and dk, dv
    exactly 0 at keys that no row reaches, on both sides."""
    q, k, v, do, dlse, adj, sc = _case(metric, sparse_inputs)
    scaled = sc is not None
    args = tuple(_t(a)[None] for a in (q, k, v, adj))
    scale = _t(sc) if scaled else None
    seed_t = torch.tensor([SEED], dtype=torch.int32)
    out, lse = TFG.flash_geometric_forward_plain(*args, metric, scale, rate,
                                                 seed_t)
    got = TFG.flash_geometric_backward_plain(
        *args, out, lse, _t(do)[None], metric, scale, rate, seed_t, scaled,
        _t(dlse)[None])
    want = [np.asarray(a) for a in _jax_bwd(metric, rate, scaled)(
        *(jnp.asarray(a) for a in (q, k, v, adj, out[0].numpy(),
                                   lse[0].numpy(), do, dlse)),
        jnp.asarray(sc) if scaled else None)]
    assert len(want) == (4 if scaled else 3)
    for g, w in zip(got[:3], want[:3]):
        assert _err(g[0], w) <= TOL
    if scaled:
        assert _err(got[3], want[3]) <= TOL
    dead, unreached = ~adj.any(-1), ~adj.any(0)
    assert torch.all(got[0][0][:, dead] == 0)
    assert np.all(want[0][:, dead] == 0)
    for g, w in zip(got[1:3], want[1:3]):
        assert torch.all(g[0][:, unreached] == 0)
        assert np.all(w[:, unreached] == 0)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("metric", TFG.MXU_METRICS)
def test_plain_fp32_biased_sparse_matches_jax(metric, rate, sparse_inputs,
                                              sparse_bias, interpret):
    """B4's lse1 of the plain fp32 version, and B5's out and lse2 of the
    plain fp32 second walk on JAX's lse1, against
    ``_flash_biased_forward(..., bf16=False, return_lse=True)`` at 64 x 64
    blocks: every metric, both dropouts off and on (the snapshot's two
    seeds), per-head scales for gaussian and rbf, a N(0, 1) bias at the
    mask's pairs; dead rows exactly 0 and LSE_DEAD on the port's side,
    out exactly 0 there on both."""
    q, k, v, _, _, adj, sc = _case(metric, sparse_inputs)
    scaled = sc is not None
    jout, jlse1, jlse2 = (np.asarray(a) for a in _jax_biased_fwd(
        metric, rate, scaled)(
        *(jnp.asarray(a) for a in (q, k, v, adj, sparse_bias)),
        jnp.asarray(sc) if scaled else None))
    q1, k1, v1, m1, b1 = (_t(a)[None] for a in (q, k, v, adj, sparse_bias))
    scale = _t(sc) if scaled else None
    lse1 = TFG.flash_lse1_plain(q1, k1, m1, metric, scale)
    out, lse2 = TFG.flash_biased_forward_plain(
        q1, k1, v1, m1, b1, _t(jlse1)[None], metric, scale, rate,
        TFG.biased_seeds(SEED, 1, "cpu"))
    live = adj.any(-1)
    assert _err(lse1[0][:, live], jlse1[:, live]) <= TOL
    assert _err(out[0], jout) <= TOL
    assert _err(lse2[0][:, live], jlse2[:, live]) <= TOL
    assert torch.all(out[0][:, ~live] == 0)
    assert torch.all(lse1[0][:, ~live] == TFG.LSE_DEAD)
    assert torch.all(lse2[0][:, ~live] == TFG.LSE_DEAD)
    assert np.all(jout[:, ~live] == 0)
