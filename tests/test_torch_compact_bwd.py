"""The plain compact backward (`flash_geometric_backward_compact_plain`,
fp32 and ``bf16=True``), the function that B3b c's compact key pair walk
(``csrc/flash_pairwalk_bwd_compact.cu``) and B3a c are held to on the
card, against JAX's ``flash_geometric_attention_bwd`` with 3-tuple plans
(the Pallas ``_flash_bwd_dq_kernel`` and ``_flash_bwd_dkv_kernel`` in
interpret mode at the port's 64 x 64 tile, on the same store, forward walk
and transposed walk), in the cases a key walk over the store handles
differently from a tile walk. The mask comes from
`tests.test_torch_gpu.band_mask`: ~1 valid pair a row a walked tile over
several tiles, a whole 64 x 64 tile (its keys' row lists pass the walk's
64 entries, so that it flushes more than once), a tile holding one pair,
a key tile no row reaches (its transposed walk is empty, icount = 0),
rows past 128 keys, dead rows, N = 330 (a ragged last tile). The walks
come from `band_compact`: a walked slot whose bits are all 0, and entries
past the counts naming other tiles and slots. One live row's lse is set
to ``LSE_DEAD`` though the store lists its pairs (p = 0 there on both
sides). Both stores (JAX takes the int8 one), every metric, dropout on
and off in turn (the hash at the global (row, key)), dscale where the
metric has a scale, and a non-zero lse cotangent.

Tolerances: fp32 as in test_torch_hybrid.py (``rtol = atol = 1e-4``:
sums in another order). bf16 under `test_torch_bf16.py`'s three gates
(max error <= 2e-3 and mean error <= 1e-5 of the largest entry, the
port's fp32 plain version at least 100 times the mean error away; dscale,
a sum of terms that cancel, under the max gate alone), q and k at
``BF16_QK_SCALE`` as the card's bf16 tests take them."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tagan_tpu.ops.pallas import flash_geometric as JFG
from tagan_torch.ops import flash_geometric as TFG
from tests.test_torch_bf16 import MAX_TOL, _check, _gates
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
# the live row whose lse is set to LSE_DEAD
DEAD_LISTED = 7
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
def _inputs(metric, rate, pack, bf16):
    """One snapshot of `_compact_biased_bwd_inputs` at `band_mask`'s
    cases (CPU tensors), q and k at half scale for ``bf16``: q, k, v, the
    mask, the store, both walks, scale, one seed, dO; the compact plain
    forward's (out, lse) (its bf16 form's for ``bf16``) with row
    DEAD_LISTED's lse at LSE_DEAD, and an lse cotangent on live rows."""
    (q, k, v, mask, store, _, plan, plan_t, scale, seeds, do, _, _, _,
     _) = _compact_biased_bwd_inputs(1, H, N, D, DV, metric, pack, rate,
                                     SEED, BF16_QK_SCALE if bf16 else 1.0,
                                     band=True)
    seed = seeds[:, 0].contiguous()
    out, lse = TFG.flash_geometric_forward_compact_plain(
        q, k, v, store, *plan, metric, scale, rate, seed, bf16=bf16)
    live = (mask != 0).any(-1)
    lse[:, :, DEAD_LISTED] = TFG.LSE_DEAD
    rng = np.random.default_rng(SEED + 600)
    dlse = 0.25 * torch.from_numpy(rng.standard_normal((1, H, N)).astype(
        np.float32)) * live[:, None]
    return (q, k, v, mask, store, plan, plan_t, scale, seed, do, out, lse,
            dlse)


@functools.lru_cache(maxsize=None)
def _port(metric, rate, pack, bf16, plain_bf16):
    """(dq, dk, dv, dscale or None) of the port's plain compact backward
    on `_inputs` (``plain_bf16``: its bf16 form), snapshot 0."""
    (q, k, v, _, store, plan, _, scale, seed, do, out, lse,
     dlse) = _inputs(metric, rate, pack, bf16)
    got = TFG.flash_geometric_backward_compact_plain(
        q, k, v, store, out, lse, do, *plan, metric, scale, rate, seed,
        metric in TFG.SCALED_METRICS, dlse, plain_bf16)
    return tuple(None if g is None else g[0] if g.dim() > 1 else g
                 for g in got)


@functools.lru_cache(maxsize=None)
def _jax(metric, rate, bf16):
    """JAX's two-walk compact backward at 64 x 64 on the int8 form of the
    store, the port's forward and transposed walks, the same (out, lse),
    dO, lse cotangent and seed: (dq, dk, dv[, dscale]), numpy."""
    (q, k, v, _, store, plan, plan_t, scale, seed, do, out, lse,
     dlse) = _inputs(metric, rate, True, bf16)
    mb = TFG.store_pairs(store)[0].numpy().astype(np.int8)
    cplan, cplan_t = (tuple(p[0].numpy() for p in pl_)
                      for pl_ in (plan, plan_t))
    scaled = metric in TFG.SCALED_METRICS

    @jax.jit
    def ref(q, k, v, out, lse, do, dlse, sc, sd):
        return JFG.flash_geometric_attention_bwd(
            q, k, v, mb, out, lse, do, metric=metric, scale=sc, block_m=64,
            block_n=64, bf16=bf16, plan=cplan, plan_t=cplan_t, seed=sd,
            dropout_rate=rate, need_dscale=scaled, dlse=dlse)
    got = ref(*(jnp.asarray(t[0].numpy()) for t in (
        q, k, v, out, lse, do, dlse)), jnp.asarray(scale.numpy()),
        jnp.asarray(seed.numpy()))
    return tuple(np.asarray(a) for a in got)


def test_band_cases():
    """The inputs hold the key walk's cases: `band_mask`'s mask, dead rows,
    rows past 128 keys; in the transposed walk a key tile with icount = 0,
    a key whose rows pass CAPR (64) entries (the whole tile and the band
    around it), a walked slot with no bit and entries past the counts;
    the row whose lse is LSE_DEAD has pairs in the store."""
    (_, _, _, mask, store, _, plan_t, _, _, _, _, lse,
     _) = _inputs("euclidean", 0.1, True, False)
    adj = mask[0].numpy() != 0
    assert np.array_equal(adj, band_mask(1, N, SEED)[0] != 0)
    dead = ~adj.any(-1)
    assert dead.sum() >= 6 and (adj.sum(-1) > 128).sum() >= 4
    tiles = adj[:320, :320].reshape(5, 64, 5, 64).sum((1, 3))
    assert tiles[0, 1] == 64 * 64 and tiles[2, 0] == 1
    assert adj[:, 64:128].sum(0).max() > 64
    il, ic, isl = (p[0] for p in plan_t)
    assert int(ic[3]) == 0 and not adj[:, 192:256].any()
    on = TFG.store_pairs(store)[0]
    walked = torch.arange(il.shape[-1]) < ic[:, None]
    per_tile = on[isl[walked].long()].sum((-1, -2))
    assert int((per_tile == 0).sum()) == 1
    past = ~walked
    assert past.any() and (il[past] != il.gather(
        1, (ic - 1).clamp(min=0)[:, None].long()).expand_as(il)[past]).any()
    assert adj[DEAD_LISTED].any()
    assert torch.all(lse[0, :, DEAD_LISTED] == TFG.LSE_DEAD)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("pack", [True, False])
@pytest.mark.parametrize("metric,rate", CASES)
def test_plain_compact_bwd_matches_jax(metric, rate, pack, bf16, interpret):
    """dq, dk, dv (and dscale for gaussian and rbf) of the compact plain
    backward (fp32, or its bf16 form) against JAX's two-walk compact
    backward on the same store, walks, (out, lse), cotangents and seed:
    fp32 within TOL, bf16 under the three gates with the port's fp32
    plain version the witness; dq 0 on dead rows and dk, dv 0 on the key
    tile no row reaches, on both sides."""
    mask = _inputs(metric, rate, pack, bf16)[3][0]
    got = _port(metric, rate, pack, bf16, bf16)
    want = _jax(metric, rate, bf16)
    dead = (mask == 0).all(-1).numpy()
    assert dead.any()
    assert torch.all(got[0][:, dead] == 0) and np.all(want[0][:, dead] == 0)
    for g, w in zip(got[1:3], want[1:3]):
        assert torch.all(g[:, 192:256] == 0) and np.all(w[:, 192:256] == 0)
    scaled = metric in TFG.SCALED_METRICS
    assert (got[3] is not None) == scaled and len(want) == 3 + scaled
    if not bf16:
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), w, rtol=TOL, atol=TOL)
        return
    f32 = _port(metric, rate, pack, bf16, False)
    for name, g, w, f in zip(("dq", "dk", "dv"), got, want, f32):
        _check(name, g, w, f)
    if scaled:
        # sums of many terms that cancel: the max gate alone, as in
        # test_torch_bf16.py
        assert _gates(got[3], want[3], f32[3])[0] <= MAX_TOL
