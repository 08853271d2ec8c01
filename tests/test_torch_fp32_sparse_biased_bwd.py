"""The plain fp32 biased backward (``flash_biased_backward_plain``)
against the Pallas biased backward with ``bf16=False``
(``flash_biased_attention_bwd``, in interpret mode at the port's 64 x 64
tile) at sparse masks: the function that the fp32 biased backward's two
pair walks of ``csrc/flash_pairwalk_biased_bwd.cu`` (the row walk: B6
and B7a; the key walk: B7b) are held to on the card, in the cases they
handle differently from a dense tile walk. The mask comes from
`tests.test_torch_gpu.sparse_mask`, which the card's tests of the walks
share: a few keys a row over several tiles, a whole 64 x 64 tile, a tile
holding one pair, an empty tile between walked ones, rows past 128 keys
(the row walk's lists overflow and it walks its tiles again), dead rows,
keys that no row reaches (their dk and dv are 0), N not a multiple of
16. The bias is N(0, 1) at the mask's pairs. Both sides take the same
out, lse1 and lse2 (the port's plain fp32 forward), a cotangent that is
0 on rows with no edge (ROADMAP C10) and, for gaussian and rbf, the
scale's gradient. dB is compared at the mask's pairs.

fp32 on both sides, sums in another order: each output's max abs error
over its largest entry (at least 1) is held to ``TOL``, the tolerance of
`test_torch_fp32_sparse.py`."""

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
def sparse_biased_inputs():
    """One snapshot of `sparse_mask`, 2 heads, N(0, 1) q, k, v and the
    cotangent of out (0 on rows with no edge), a N(0, 1) bias at the
    mask's pairs. At N = 330 the mask's rows past 128 keys reach every
    key, so three keys (two in the third key tile, one in the ragged
    last) are taken off every row."""
    rng = np.random.default_rng(22)
    H, D, Dv = 2, 16, 8
    q, k = (rng.standard_normal((H, N, D)).astype(np.float32)
            for _ in range(2))
    v, do = (rng.standard_normal((H, N, Dv)).astype(np.float32)
             for _ in range(2))
    adj = sparse_mask(1, N, seed=3)[0] != 0
    adj[:, [150, 151, N - 5]] = False
    do[:, ~adj.any(-1)] = 0.0
    bias = np.where(adj, rng.standard_normal((N, N)), 0.0).astype(np.float32)
    return q, k, v, do, adj, bias


@functools.lru_cache(maxsize=None)
def _jax_bwd(metric, rate, scaled):
    """JAX's biased fp32 backward at 64 x 64 blocks, jitted once per
    case."""
    @jax.jit
    def ref(q, k, v, bias, adj, out, lse1, lse2, do, scale):
        return JFG.flash_biased_attention_bwd(
            q, k, v, bias, adj, out, lse1, lse2, do, metric=metric,
            scale=scale if scaled else None, block_m=64, block_n=64,
            bf16=False, seeds=jnp.asarray([SEED, SEED ^ 0x5BD1E995],
                                          jnp.int32),
            dropout_rate=rate, need_dscale=scaled)
    return ref


def test_sparse_fp32_biased_bwd_mask_cases(sparse_biased_inputs):
    """The mask holds the walks' cases: dead rows, keys that no row
    reaches, rows past 128 keys, and at 64 x 64 tiles a whole tile, a
    one-pair tile and an empty tile between walked ones; the cotangent is
    0 on the dead rows and the bias lies on the mask's pairs only."""
    _, _, _, do, adj, bias = sparse_biased_inputs
    dead = ~adj.any(-1)
    assert dead.sum() >= 6 and (~adj.any(0)).sum() >= 3
    assert (adj.sum(-1) > 128).sum() >= 4
    tiles = adj[:320, :320].reshape(5, 64, 5, 64).sum((1, 3))
    assert tiles[0, 1] == 64 * 64 and tiles[2, 0] == 1 and tiles[1, 3] == 0
    assert np.all(do[:, dead] == 0) and np.all(bias[~adj] == 0)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("metric", TFG.MXU_METRICS)
def test_plain_fp32_biased_bwd_sparse_matches_jax(metric, rate,
                                                  sparse_biased_inputs,
                                                  interpret):
    """dq, dk, dv, dB at the mask's pairs (and dscale for gaussian and
    rbf) of the plain fp32 biased backward against the Pallas biased
    backward with bf16=False on the same out, lse1 and lse2: every
    metric, both dropouts off and on, within TOL of each output's largest
    entry; dq exactly 0 on dead rows and dk, dv exactly 0 at keys that no
    row reaches, on both sides."""
    q, k, v, do, adj, bias = sparse_biased_inputs
    if metric in TFG._COSINE:
        q = q / np.linalg.norm(q, axis=-1, keepdims=True)
        k = k / np.linalg.norm(k, axis=-1, keepdims=True)
    scaled = metric in TFG.SCALED_METRICS
    sc = np.asarray([0.7, 1.6], np.float32)
    q1, k1, v1, m1, b1, do1 = (_t(a)[None] for a in (q, k, v, adj, bias, do))
    scale = _t(sc) if scaled else None
    seeds = TFG.biased_seeds(SEED, 1, "cpu")
    lse1 = TFG.flash_lse1_plain(q1, k1, m1, metric, scale)
    out, lse2 = TFG.flash_biased_forward_plain(q1, k1, v1, m1, b1, lse1,
                                               metric, scale, rate, seeds)
    got = TFG.flash_biased_backward_plain(q1, k1, v1, m1, b1, out, lse1,
                                          lse2, do1, metric, scale, rate,
                                          seeds, scaled)
    want = [np.asarray(a) for a in _jax_bwd(metric, rate, scaled)(
        *(jnp.asarray(a) for a in (q, k, v, bias, adj, out[0].numpy(),
                                   lse1[0].numpy(), lse2[0].numpy(), do,
                                   sc)))]
    errs = {name: _err(g[0], w)
            for name, g, w in zip(("dq", "dk", "dv"), got, want)}
    on = m1[0] != 0
    errs["dB"] = _err(got[3][0][on], want[3][adj])
    if scaled:
        errs["dscale"] = _err(got[4], want[4])
    assert max(errs.values()) <= TOL, errs
    dead, unreached = ~adj.any(-1), ~adj.any(0)
    assert torch.all(got[0][0][:, dead] == 0)
    assert np.all(want[0][:, dead] == 0)
    for g, w in zip(got[1:3], want[1:3]):
        assert torch.all(g[0][:, unreached] == 0)
        assert np.all(w[:, unreached] == 0)
