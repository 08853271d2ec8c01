"""The plain bf16 forms of B1, B4 and B5 against the Pallas kernels with
``bf16=True`` (in interpret mode, at the port's 64 x 64 tile so that the
walks coincide) at sparse masks: the function that the pair walks of
``csrc/flash_pairwalk_fwd.cu`` are held to on the card, in the cases
they handle differently from a dense tile walk. The masks come from
`tests.test_torch_gpu.sparse_mask`, which the card's tests of the pair
walks share: a few keys a row over several tiles, a whole 64 x 64 tile,
a tile holding one pair, an empty tile between walked ones, rows whose
only keys lie in their row tile's last walked tile (their running max
starts there), rows past 128 list entries, dead rows, N not a multiple
of 16. The gates are `test_torch_bf16.py`'s."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tagan_tpu.ops.pallas import flash_geometric as JFG
from tagan_torch.ops import flash_geometric as TFG
from tests.test_torch_bf16 import _check
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
def sparse_inputs():
    """One snapshot of `sparse_mask`, 2 heads, q and k at half scale (as
    the card's bf16 gates take them), a bias on the mask's pairs."""
    rng = np.random.default_rng(11)
    H, D, Dv = 2, 16, 8
    q, k = (0.5 * rng.standard_normal((H, N, D)).astype(np.float32)
            for _ in range(2))
    v = rng.standard_normal((H, N, Dv)).astype(np.float32)
    adj = sparse_mask(1, N, seed=3)[0] != 0
    bias = np.where(adj, rng.standard_normal((N, N)), 0.0).astype(np.float32)
    return q, k, v, adj, bias


def test_sparse_mask_cases(sparse_inputs):
    """The mask holds the cases it is named for, at 64 x 64 tiles."""
    adj = sparse_inputs[3]
    tiles = adj[:320, :320].reshape(5, 64, 5, 64).sum((1, 3))
    assert tiles[0, 1] == 64 * 64 and tiles[2, 0] == 1 and tiles[1, 3] == 0
    last = (N - 1) // 64 * 64
    late = adj[200:208]
    assert late.any(-1).all() and not late[:, :last].any()
    assert (adj.sum(-1) > 128).sum() >= 4
    assert not adj[300:305].any() and not adj[N - 1].any()
    deg = adj.sum(-1)
    assert np.median(deg) <= 8


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("metric", TFG.MXU_METRICS)
def test_plain_bf16_sparse_matches_jax(metric, rate, sparse_inputs,
                                       interpret):
    """B1's out and lse, B4's lse1, and B5's out and lse2 (on JAX's lse1)
    of the plain bf16 forms, walking the plan, against the Pallas
    kernels with bf16=True at 64 x 64 blocks: every metric, dropout off
    and on (B5 with both seeds). The witness is the port's float32 plain
    version; dead rows exactly 0 and LSE_DEAD."""
    q, k, v, adj, bias = sparse_inputs
    if metric in TFG._COSINE:
        q = q / np.linalg.norm(q, axis=-1, keepdims=True)
        k = k / np.linalg.norm(k, axis=-1, keepdims=True)
    scaled = metric in TFG.SCALED_METRICS
    sc = np.asarray([0.7, 1.6], np.float32) if scaled else None

    @jax.jit
    def ref(q, k, v, adj, bias):
        kw = dict(metric=metric, block_m=64, block_n=64, bf16=True,
                  dropout_rate=rate, return_lse=True,
                  scale_param=None if sc is None else jnp.asarray(sc))
        out, lse = JFG._flash_forward(
            q, k, v, adj, seed=jnp.asarray([SEED], jnp.int32), **kw)
        return (out, lse) + JFG._flash_biased_forward(
            q, k, v, adj, bias,
            seeds=jnp.asarray([SEED, SEED ^ 0x5BD1E995], jnp.int32), **kw)
    jout, jlse, jbout, jlse1, jlse2 = (np.asarray(a) for a in ref(
        *(jnp.asarray(a) for a in (q, k, v, adj, bias))))

    q1, k1, v1, m1, b1 = (_t(a)[None] for a in (q, k, v, adj, bias))
    scale = None if sc is None else _t(sc)
    live = adj.any(-1)
    seed = torch.tensor([SEED], dtype=torch.int32)
    out, lse = TFG.flash_geometric_forward_plain(q1, k1, v1, m1, metric,
                                                 scale, rate, seed, bf16=True)
    out32, _ = TFG.flash_geometric_forward_plain(q1, k1, v1, m1, metric,
                                                 scale, rate, seed)
    _check("out", out[0], jout, out32[0])
    _check("lse", lse[0][:, live], jlse[:, live], lse[0][:, live],
           witness=False)
    lse1 = TFG.flash_lse1_plain(q1, k1, m1, metric, scale, bf16=True)
    _check("lse1", lse1[0][:, live], jlse1[:, live], lse1[0][:, live],
           witness=False)
    seeds = TFG.biased_seeds(SEED, 1, "cpu")
    jl1 = _t(jlse1)[None]
    bout, lse2 = TFG.flash_biased_forward_plain(q1, k1, v1, m1, b1, jl1,
                                                metric, scale, rate, seeds,
                                                bf16=True)
    bout32, _ = TFG.flash_biased_forward_plain(q1, k1, v1, m1, b1, jl1,
                                               metric, scale, rate, seeds)
    _check("biased out", bout[0], jbout, bout32[0])
    _check("lse2", lse2[0][:, live], jlse2[:, live], lse2[0][:, live],
           witness=False)
    for o, l in ((out, lse), (bout, lse2), (None, lse1)):
        if o is not None:
            assert torch.all(o[0][:, ~live] == 0)
        assert torch.all(l[0][:, ~live] == TFG.LSE_DEAD)
