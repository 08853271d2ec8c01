"""The plain compact forward, B1c's function
(`flash_geometric_forward_compact_plain`, fp32 and ``bf16=True``), against
JAX's ``flash_geometric_attention_lse`` with 3-tuple plans (the Pallas
``_flash_kernel`` in interpret mode at the port's 64 x 64 tile, on the
same store and walk): the function that B1c's compact forward pair walk
(the OUT mode of ``csrc/flash_pairwalk_fwd_compact.cu``) is held to on the
card, in the cases a pair walk over the store handles differently from a
tile walk. The mask comes from `tests.test_torch_gpu.band_mask`: ~1 valid
pair a row a walked tile over several tiles, a whole 64 x 64 tile, a tile
holding one pair, rows whose walks list more than twice a row list's 64
entries (the walk flushes three times or more), dead rows, N = 330 (a
ragged last tile). The walk comes from `band_compact`: a walked slot whose
bits are all 0, and entries past the counts naming other tiles and slots.
Both stores (JAX takes the int8 one), every metric, dropout on and off in
turn; the one-seed dropout hash is the JAX package's bit for bit.

Tolerances: fp32 as in test_torch_hybrid.py (``rtol = atol = 1e-4``:
sums in another order). bf16 under `test_torch_bf16.py`'s three gates
(max error <= 2e-3 and mean error <= 1e-5 of the largest entry, the
port's fp32 plain version at least 100 times the mean error away; lse:
the max and mean gates), q and k at ``BF16_QK_SCALE`` as the card's bf16
tests take them, JAX planned at the same 64 x 64 walk: the bf16 form
rounds p relative to the running max after each walk step (ROADMAP
C11(b))."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tagan_tpu.ops.pallas import flash_geometric as JFG
from tagan_torch.ops import flash_geometric as TFG
from tests.test_torch_bf16 import _check
from tests.test_torch_gpu import BF16_QK_SCALE, band_compact, band_mask

# torch's CPU operations on one thread: the tier-1 command runs six
# pytest workers on 8 cores, and torch's default of a thread per core
# oversubscribes them
torch.set_num_threads(1)

# fp32 on both sides, sums in another order (test_torch_hybrid.py's)
TOL = 1e-4
# 330 rows: six row tiles, the last ragged, N % 16 == 10
N, H, D, DV = 330, 4, 16, 8
SEED = 3
# the snapshot's dropout seed (negative: the hash takes it as uint32)
DROP_SEED = -77
# a row list's entries between flushes (csrc/flash_pairwalk.cuh: CAPR)
CAPR = 64
# every metric, dropout on and off in turn
CASES = [(m, 0.1 if i % 2 else 0.0) for i, m in enumerate(TFG.MXU_METRICS)]


@pytest.fixture(scope="module")
def interpret():
    import jax.experimental.pallas as pl
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JFG.pl, "pallas_call",
                   functools.partial(pl.pallas_call, interpret=True))
        yield


@functools.lru_cache(maxsize=None)
def _mask():
    """`band_mask`'s one snapshot, int8 [1, N, N]."""
    return torch.from_numpy(band_mask(1, N, SEED))


@functools.lru_cache(maxsize=None)
def _inputs(metric, pack, bf16):
    """q, k [1, H, N, D] (cosine metrics' rows unit, the others at half
    scale for ``bf16``), v [1, H, N, DV], the per-head scale and the
    snapshot's seed, with `band_compact`'s store and walk."""
    rng = np.random.default_rng(SEED)
    q, k = (rng.standard_normal((1, H, N, D)).astype(np.float32)
            for _ in range(2))
    v = rng.standard_normal((1, H, N, DV)).astype(np.float32)
    if metric in TFG._COSINE:
        q = q / np.linalg.norm(q, axis=-1, keepdims=True)
        k = k / np.linalg.norm(k, axis=-1, keepdims=True)
    elif bf16:
        q, k = BF16_QK_SCALE * q, BF16_QK_SCALE * k
    store, plan, _ = band_compact(_mask(), pack, SEED)
    scale = torch.linspace(0.7, 2.0, H)
    seed = torch.tensor([DROP_SEED], dtype=torch.int32)
    return (*(torch.from_numpy(a) for a in (q, k, v)), store, plan, scale,
            seed)


@functools.lru_cache(maxsize=None)
def _port(metric, rate, pack, bf16, plain_bf16):
    """(out [H, N, DV], lse [H, N]) of the port's plain compact forward on
    `_inputs` (``plain_bf16``: its bf16 form)."""
    q, k, v, store, plan, scale, seed = _inputs(metric, pack, bf16)
    out, lse = TFG.flash_geometric_forward_compact_plain(
        q, k, v, store, *plan, metric, scale, rate, seed, plain_bf16)
    return out[0], lse[0]


@functools.lru_cache(maxsize=None)
def _jax(metric, rate, bf16):
    """JAX's compact forward at 64 x 64 on the int8 form of the store and
    the port's walk (the transposed walk from the mask, which the forward
    does not read), the same seed: (out, lse), numpy."""
    q, k, v, store, plan, scale, seed = _inputs(metric, True, bf16)
    mb = TFG.store_pairs(store)[0].numpy().astype(np.int8)
    cplan = tuple(p[0].numpy() for p in plan)
    cplan_t = tuple(p[0].numpy()
                    for p in TFG.compact_transposed_plan(_mask()))

    @jax.jit
    def ref(q, k, v, sc, sd):
        return JFG.flash_geometric_attention_lse(
            q, k, v, mb, metric=metric, scale_param=sc, block_m=64,
            block_n=64, bf16=bf16, plan=cplan, plan_t=cplan_t,
            dropout_rate=rate, dropout_seed=sd)
    got = ref(*(jnp.asarray(t[0].numpy()) for t in (q, k, v)),
              jnp.asarray(scale.numpy()), jnp.asarray(seed.numpy()))
    return tuple(np.asarray(a) for a in got)


def test_band_walk_cases():
    """The inputs hold the walk's cases: `band_mask`'s mask, dead rows,
    rows whose walks list more than 2 CAPR valid pairs, a whole tile and
    a one-pair tile, a walked slot with no bit, entries past the counts
    that name other tiles."""
    store, plan = _inputs("euclidean", True, False)[3:5]
    adj = _mask()[0].numpy() != 0
    assert (~adj.any(-1)).sum() >= 6
    tiles = adj[:320, :320].reshape(5, 64, 5, 64).sum((1, 3))
    assert tiles[0, 1] == 64 * 64 and tiles[2, 0] == 1
    on = TFG.store_pairs(store)[0]
    jl, jc, js = (p[0] for p in plan)
    # each row's pairs along its tile's walk, as the walk lists them
    listed = torch.zeros(N, dtype=torch.long)
    for i in range(jc.shape[0]):
        rows = slice(64 * i, min(64 * (i + 1), N))
        for t in range(int(jc[i])):
            listed[rows] += on[int(js[i, t])].sum(-1)[:rows.stop - rows.start]
    assert torch.equal(listed, torch.from_numpy(adj.sum(-1)))
    assert int((listed > 2 * CAPR).sum()) >= 4
    walked = torch.arange(jl.shape[-1]) < jc[:, None]
    per_tile = on[js[walked].long()].sum((-1, -2))
    assert int((per_tile == 0).sum()) == 1
    past = ~walked
    assert past.any() and (jl[past] != jl.gather(
        1, (jc - 1).clamp(min=0)[:, None].long()).expand_as(jl)[past]).any()


def test_dropout_hash_matches_jax():
    """The one-seed keep mask of the port's hash equals the JAX package's
    ``_keep_mask`` bit for bit at every pair of the padded grid and each
    head, with the snapshot's negative seed, and drops some of the band's
    pairs: the same pairs are dropped on both sides."""
    thresh = TFG._keep_thresh(0.1)
    side = 6 * 64
    adj = _mask()[0] != 0
    for h in range(H):
        port = TFG._keep_mask(DROP_SEED, h, 0, 0, side, side, thresh)
        jaxm = np.asarray(JFG._keep_mask(jnp.int32(DROP_SEED), jnp.int32(h),
                                         0, 0, side, side, thresh))
        assert np.array_equal(port.numpy(), jaxm)
        assert (~port[:N, :N] & adj).any()


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("pack", [True, False])
@pytest.mark.parametrize("metric,rate", CASES)
def test_plain_compact_fwd_matches_jax(metric, rate, pack, bf16, interpret):
    """out and lse of the compact plain forward (fp32, or its bf16 form)
    against JAX's compact forward on the same store, walk and seed: fp32
    within TOL, bf16 under the three gates with the port's fp32 plain
    version the witness (lse: the max and mean gates); dead rows exactly
    0 and ``LSE_DEAD`` on both sides, and the rows past 2 CAPR pairs
    live."""
    adj = _mask()[0] != 0
    out, lse = _port(metric, rate, pack, bf16, bf16)
    j_out, j_lse = _jax(metric, rate, bf16)
    dead = (~adj.any(-1)).numpy()
    long_rows = adj.sum(-1).numpy() > 2 * CAPR
    assert dead.any() and long_rows.any()
    assert torch.all(out[:, dead] == 0) and np.all(j_out[:, dead] == 0)
    assert torch.all(lse[:, dead] == TFG.LSE_DEAD)
    assert np.all(j_lse[:, dead] == JFG.LSE_DEAD)
    assert np.all(j_lse[:, long_rows] < 1e29)
    live = ~dead
    if not bf16:
        np.testing.assert_allclose(out[:, live].numpy(), j_out[:, live],
                                   rtol=TOL, atol=TOL)
        np.testing.assert_allclose(lse[:, live].numpy(), j_lse[:, live],
                                   rtol=TOL, atol=TOL)
        return
    f_out, f_lse = _port(metric, rate, pack, bf16, False)
    _check("out", out[:, live], j_out[:, live], f_out[:, live])
    _check("lse", lse[:, live], j_lse[:, live], f_lse[:, live],
           witness=False)
