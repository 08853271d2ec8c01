"""The plain compact lse1, B4c's function (`flash_lse1_compact_plain`,
fp32 and ``bf16=True``), against the Pallas band pass ``_band_lse1`` (in
interpret mode at the port's 64 x 64 tile, on the same store and walk):
the function that B4c's compact forward pair walk (the LSE mode of
``csrc/flash_pairwalk_fwd_compact.cu``) is held to on the card, in the
cases a pair walk over the store handles differently from a tile walk.
The inputs are `tests.test_torch_compact_fwd`'s: the mask of
`tests.test_torch_gpu.band_mask` (~1 valid pair a row a walked tile over
several tiles, a whole 64 x 64 tile, a tile holding one pair, rows whose
walks list more than twice a row list's 64 entries, dead rows, N = 330:
a ragged last tile) and the walk of `band_compact` (a walked slot whose
bits are all 0, entries past the counts naming other tiles and slots).
Both stores (JAX takes the int8 one), every metric.

Tolerances: fp32 as in test_torch_hybrid.py (``rtol = atol = 1e-4``:
sums in another order). bf16 under `test_torch_bf16.py`'s max and mean
gates (max error <= 2e-3 and mean error <= 1e-5 of the largest entry; no
witness, as for lse), q and k at ``BF16_QK_SCALE`` as the card's bf16
tests take them."""

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
from tests.test_torch_compact_fwd import CAPR, N, _inputs, _mask

# torch's CPU operations on one thread: the tier-1 command runs six
# pytest workers on 8 cores, and torch's default of a thread per core
# oversubscribes them
torch.set_num_threads(1)

# fp32 on both sides, sums in another order (test_torch_hybrid.py's)
TOL = 1e-4


@pytest.fixture(scope="module")
def interpret():
    import jax.experimental.pallas as pl
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JFG.pl, "pallas_call",
                   functools.partial(pl.pallas_call, interpret=True))
        yield


@functools.lru_cache(maxsize=None)
def _port(metric, pack, bf16, plain_bf16):
    """lse1 [H, N] of the port's plain compact lse1 on `_inputs`
    (``plain_bf16``: its bf16 form)."""
    q, k, _, store, plan, scale, _ = _inputs(metric, pack, bf16)
    return TFG.flash_lse1_compact_plain(q, k, store, *plan, metric, scale,
                                        plain_bf16)[0]


@functools.lru_cache(maxsize=None)
def _jax(metric, bf16):
    """JAX's band lse1 at 64 x 64 on the int8 form of the store and the
    port's walk: [H, N], numpy."""
    q, k, _, store, plan, scale, _ = _inputs(metric, True, bf16)
    mb = TFG.store_pairs(store)[0].numpy().astype(np.int8)
    cplan = tuple(p[0].numpy() for p in plan)

    @jax.jit
    def ref(q, k, sc):
        return JHB._band_lse1(q, k, mb, cplan, sc, metric=metric,
                              block_m=64, block_n=64, bf16=bf16)
    return np.asarray(ref(*(jnp.asarray(t[0].numpy()) for t in (q, k)),
                          jnp.asarray(scale.numpy())))


def test_band_walk_cases():
    """The inputs hold the walk's cases: dead rows, rows whose walks list
    more than 2 CAPR valid pairs, a whole tile and a one-pair tile, a
    walked slot with no bit, entries past the counts that name other
    tiles, a ragged last tile; both stores hold the same pairs."""
    adj = _mask()[0].numpy() != 0
    assert N % 64 and (~adj.any(-1)).sum() >= 6
    assert (adj.sum(-1) > 2 * CAPR).sum() >= 4
    tiles = adj[:320, :320].reshape(5, 64, 5, 64).sum((1, 3))
    assert tiles[0, 1] == 64 * 64 and tiles[2, 0] == 1
    bits, plan = _inputs("euclidean", True, False)[3:5]
    i8 = _inputs("euclidean", False, False)[3]
    on = TFG.store_pairs(bits)[0]
    assert torch.equal(on, TFG.store_pairs(i8)[0])
    jl, jc, js = (p[0] for p in plan)
    walked = torch.arange(jl.shape[-1]) < jc[:, None]
    assert int((on[js[walked].long()].sum((-1, -2)) == 0).sum()) == 1
    past = ~walked
    assert past.any() and (jl[past] != jl.gather(
        1, (jc - 1).clamp(min=0)[:, None].long()).expand_as(jl)[past]).any()


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("pack", [True, False])
@pytest.mark.parametrize("metric", TFG.MXU_METRICS)
def test_plain_compact_lse1_matches_jax(metric, pack, bf16, interpret):
    """lse1 of the compact plain version (fp32, or its bf16 form) against
    ``_band_lse1`` on the same store and walk: fp32 within TOL, bf16 under
    the max and mean gates; dead rows exactly ``LSE_DEAD`` on both sides,
    and the rows past 2 CAPR pairs live on both sides."""
    adj = _mask()[0] != 0
    lse1 = _port(metric, pack, bf16, bf16)
    j_lse1 = _jax(metric, bf16)
    dead = (~adj.any(-1)).numpy()
    long_rows = adj.sum(-1).numpy() > 2 * CAPR
    assert dead.any() and long_rows.any()
    assert torch.all(lse1[:, dead] == TFG.LSE_DEAD)
    assert np.all(j_lse1[:, dead] == JFG.LSE_DEAD)
    assert torch.all(lse1[:, long_rows] < 1e29)
    assert np.all(j_lse1[:, long_rows] < 1e29)
    live = ~dead
    if not bf16:
        np.testing.assert_allclose(lse1[:, live].numpy(), j_lse1[:, live],
                                   rtol=TOL, atol=TOL)
        return
    f32 = _port(metric, pack, bf16, False)
    _check("lse1", lse1[:, live], j_lse1[:, live], f32[:, live],
           witness=False)
