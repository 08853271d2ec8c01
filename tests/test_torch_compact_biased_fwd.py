"""The plain compact biased forward, B5c's function
(`flash_biased_forward_compact_plain`, fp32 and ``bf16=True``), against the
Pallas band pass ``_band_biased_main`` (in interpret mode at the port's
64 x 64 tile, on the same store, walks and union lse1): the function that
B5c's compact forward pair walk (``csrc/flash_pairwalk_fwd_compact.cu``)
is held to on the card, in the cases a pair walk over the store handles
differently from a tile walk. The mask comes from
`tests.test_torch_gpu.band_mask`: ~1 valid pair a row a walked tile over
several tiles, a whole 64 x 64 tile, a tile holding one pair, rows past
128 keys (the walk's row lists overflow and it flushes more than once),
dead rows, N = 330 (a ragged last tile). The walks come from
`band_compact`: a walked slot whose bits are all 0, and entries past the
counts naming other tiles and slots. lse1 is the band's raised by a
constant on live rows, as a union's stands above the band's own. Both
stores (JAX takes the int8 one), every metric, the dropouts on and off
in turn; the two dropout hashes are the JAX package's bit for bit.

Tolerances: fp32 as in test_torch_hybrid.py (``rtol = atol = 1e-4``:
sums in another order). bf16 under `test_torch_bf16.py`'s three gates
(max error <= 2e-3 and mean error <= 1e-5 of the largest entry, the
port's fp32 plain version at least 100 times the mean error away), q and
k at ``BF16_QK_SCALE`` as the card's bf16 tests take them, JAX planned
at the same 64 x 64 walk: the bf16 form rounds p2 relative to the
running max after each walk step (ROADMAP C11(b))."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tagan_tpu.ops.pallas import flash_geometric as JFG
from tagan_tpu.ops.pallas import hybrid_biased as JHB
from tagan_torch.ops import flash_geometric as TFG
from tests.test_torch_bf16 import _check
from tests.test_torch_gpu import (BF16_QK_SCALE, _compact_biased_bwd_inputs,
                                  band_mask)

# torch's CPU operations on one thread: the tier-1 command runs six
# pytest workers on 8 cores, and torch's default of a thread per core
# oversubscribes them
torch.set_num_threads(1)

# fp32 on both sides, sums in another order (test_torch_hybrid.py's)
TOL = 1e-4
# 330 rows: six row tiles, the last ragged, N % 16 == 10
N, H, D, DV = 330, 2, 16, 8
SEED = 3
# every metric, the dropouts on and off in turn
CASES = [(m, 0.1 if i % 2 else 0.0) for i, m in enumerate(TFG.MXU_METRICS)]


@pytest.fixture(scope="module")
def interpret():
    import jax.experimental.pallas as pl
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JFG.pl, "pallas_call",
                   functools.partial(pl.pallas_call, interpret=True))
        yield


@functools.lru_cache(maxsize=None)
def _inputs(metric, rate, pack, bf16):
    """One snapshot of `_compact_biased_bwd_inputs` at `band_mask`'s
    cases (CPU tensors), q and k at half scale for ``bf16``: the store,
    walks, bias store, union lse1, scale and seeds."""
    return _compact_biased_bwd_inputs(1, H, N, D, DV, metric, pack, rate,
                                      SEED, BF16_QK_SCALE if bf16 else 1.0,
                                      band=True)


@functools.lru_cache(maxsize=None)
def _port(metric, rate, pack, bf16, plain_bf16):
    """(out, lse2) of the port's plain compact forward on `_inputs`
    (``plain_bf16``: its bf16 form), snapshot 0."""
    (q, k, v, _, store, bias_store, plan, _, scale, seeds, _, lse1, _, _,
     _) = _inputs(metric, rate, pack, bf16)
    out, lse2 = TFG.flash_biased_forward_compact_plain(
        q, k, v, store, bias_store, lse1, *plan, metric, scale, rate, seeds,
        plain_bf16)
    return out[0], lse2[0]


@functools.lru_cache(maxsize=None)
def _jax_band(metric, rate, bf16):
    """JAX's band pass at 64 x 64 on the int8 form of the store, the
    port's walk, union lse1 and seeds: (out, lse2), numpy."""
    (q, k, v, _, store, bias_store, plan, _, scale, seeds, _, lse1, _, _,
     _) = _inputs(metric, rate, True, bf16)
    mb = TFG.store_pairs(store)[0].numpy().astype(np.int8)
    cplan = tuple(p[0].numpy() for p in plan)

    @jax.jit
    def ref(q, k, v, bias, l1u, sc, sd):
        return JHB._band_biased_main(
            q, k, v, mb, bias, l1u, cplan, sc, sd, metric=metric,
            block_m=64, block_n=64, bf16=bf16, dropout_rate=rate)
    out = ref(*(jnp.asarray(t[0].numpy()) for t in (
        q, k, v, bias_store, lse1)), jnp.asarray(scale.numpy()),
        jnp.asarray(seeds[0].numpy()))
    return tuple(np.asarray(a) for a in out)


def test_band_mask_cases():
    """The inputs hold the walk's cases: `band_mask`'s mask, dead rows,
    rows past 128 keys, a whole tile and a one-pair tile, a walked slot
    with no bit, entries past the counts that name other tiles; lse1
    stands above the band's own logsumexp on every live row."""
    (q, k, _, mask, store, _, plan, _, scale, _, _, lse1, _, _,
     _) = _inputs("euclidean", 0.1, True, False)
    adj = mask[0].numpy() != 0
    assert np.array_equal(adj, band_mask(1, N, SEED)[0] != 0)
    dead = ~adj.any(-1)
    assert dead.sum() >= 6 and (adj.sum(-1) > 128).sum() >= 4
    tiles = adj[:320, :320].reshape(5, 64, 5, 64).sum((1, 3))
    assert tiles[0, 1] == 64 * 64 and tiles[2, 0] == 1
    on = TFG.store_pairs(store)[0]
    jl, jc, js = (p[0] for p in plan)
    walked = torch.arange(jl.shape[-1]) < jc[:, None]
    per_tile = on[js[walked].long()].sum((-1, -2))
    assert int((per_tile == 0).sum()) == 1
    past = ~walked
    assert past.any() and (jl[past] != jl.gather(
        1, (jc - 1).clamp(min=0)[:, None].long()).expand_as(jl)[past]).any()
    band = TFG.flash_lse1_compact_plain(q, k, store, *plan, "euclidean",
                                        scale)[0]
    assert torch.all(lse1[0][:, ~dead] > band[:, ~dead])
    assert torch.all(lse1[0][:, dead] == TFG.LSE_DEAD)


@pytest.mark.parametrize("seed_of", [0, 1])
def test_dropout_hashes_match_jax(seed_of):
    """drop1's (seed 0) and drop2's (seed 1) keep masks of the port's hash
    equal the JAX package's ``_keep_mask`` bit for bit at every pair of
    the padded grid and each head, and each drops some of the band's
    pairs: the same pairs are dropped on both sides."""
    seeds = _inputs("euclidean", 0.1, True, False)[9]
    mask = _inputs("euclidean", 0.1, True, False)[3][0]
    thresh = TFG._keep_thresh(0.1)
    side = 6 * 64
    for h in range(H):
        seed = int(seeds[0, seed_of])
        port = TFG._keep_mask(seed, h, 0, 0, side, side, thresh)
        jaxm = np.asarray(JFG._keep_mask(jnp.int32(seed), jnp.int32(h), 0, 0,
                                         side, side, thresh))
        assert np.array_equal(port.numpy(), jaxm)
        assert (~port[:N, :N] & (mask != 0)).any()


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("pack", [True, False])
@pytest.mark.parametrize("metric,rate", CASES)
def test_plain_compact_biased_fwd_matches_jax(metric, rate, pack, bf16,
                                              interpret):
    """out and lse2 of the compact plain forward (fp32, or its bf16 form)
    against ``_band_biased_main`` on the same store, walks, union lse1 and
    seeds: fp32 within TOL, bf16 under the three gates with the port's
    fp32 plain version the witness (lse2: the max and mean gates); dead
    rows exactly 0 and ``LSE_DEAD`` on both sides."""
    mask = _inputs(metric, rate, pack, bf16)[3][0]
    out, lse2 = _port(metric, rate, pack, bf16, bf16)
    j_out, j_l2 = _jax_band(metric, rate, bf16)
    dead = (mask == 0).all(-1).numpy()
    assert dead.any()
    assert torch.all(out[:, dead] == 0) and np.all(j_out[:, dead] == 0)
    assert torch.all(lse2[:, dead] == TFG.LSE_DEAD)
    assert np.all(j_l2[:, dead] == JFG.LSE_DEAD)
    live = ~dead
    if not bf16:
        np.testing.assert_allclose(out[:, live].numpy(), j_out[:, live],
                                   rtol=TOL, atol=TOL)
        np.testing.assert_allclose(lse2[:, live].numpy(), j_l2[:, live],
                                   rtol=TOL, atol=TOL)
        return
    f_out, f_l2 = _port(metric, rate, pack, bf16, False)
    _check("out", out[:, live], j_out[:, live], f_out[:, live])
    _check("lse2", lse2[:, live], j_l2[:, live], f_l2[:, live],
           witness=False)
