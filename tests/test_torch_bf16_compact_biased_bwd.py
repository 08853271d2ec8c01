"""The plain bf16 compact biased backward with the hybrid band's union
statistics (the compact plain parts with ``bf16=True``, B6c's, then the
residual's delta1 added, then B7a c's and B7b c's:
`_biased_backward_compact(..., bf16=True)` on CPU tensors) against the
Pallas band backward with ``bf16=True`` (``_band_bwd_pre`` then
``_band_bwd_dq_dkv``, in interpret mode at the port's 64 x 64 tile, on
the same store, walks and union statistics): the function that the bf16
forms of the compact row walk (B6c and B7a c) and key walk (B7b c) of
``csrc/flash_pairwalk_biased_bwd_compact.cu`` are held to on the card.
The mask and walks are those of the fp32 file
(test_torch_fp32_compact_biased_bwd.py): `tests.test_torch_gpu.band_mask`
over `band_compact`'s walks (~1 valid pair a row a walked tile, a whole
tile, a one-pair tile, a key tile no row reaches, rows past 128 keys,
dead rows, a walked slot with no bit, entries past the counts), the
port's plain forward statistics raised as a union's, a residual delta1
that is not 0, a cotangent that is 0 on rows with no edge (ROADMAP C10),
the bit and the int8 store (JAX takes the int8 one), every metric with
the dropouts on and off in turn, and for gaussian and rbf the scale's
gradient; q and k at the card's bf16 tests' half scale
(``BF16_QK_SCALE``). dB is compared at the store's pairs.

The tolerance is the bf16 band test's of
test_torch_hybrid_edge_bf16.py: `test_torch_bf16.py`'s three gates over
each output's largest entry, max error <= 2e-3 (an fp32 sum in another
order may flip a bf16 rounding), mean error <= 1e-5, and the port's fp32
plain version standing at least 100 times the mean error away (the
witness); dscale, a sum of terms that cancel, the max gate alone."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tagan_tpu.ops.pallas import flash_geometric as JFG
from tagan_tpu.ops.pallas import hybrid_biased as JHB
from tagan_torch.ops import flash_geometric as TFG
from tests.test_torch_bf16 import MAX_TOL, _check, _gates
from tests.test_torch_gpu import (BF16_QK_SCALE, _compact_biased_bwd_inputs,
                                  band_mask)

# torch's CPU operations on one thread: the tier-1 command runs six
# pytest workers on 8 cores, and torch's default of a thread per core
# oversubscribes them
torch.set_num_threads(1)

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
def _inputs(metric, rate, pack):
    """One snapshot of `_compact_biased_bwd_inputs` at `band_mask`'s
    cases, q and k at half scale (CPU tensors)."""
    return _compact_biased_bwd_inputs(1, H, N, D, DV, metric, pack, rate,
                                      SEED, BF16_QK_SCALE, band=True)


@functools.lru_cache(maxsize=None)
def _port(metric, rate, pack, bf16, rest=True):
    """The port's compact backward (dq, dk, dv, dB, dscale, delta1_U) on
    `_inputs`, its plain bf16 (or fp32) parts; ``rest`` False leaves the
    residual's delta1 out."""
    (q, k, v, _, store, bias_store, plan, plan_t, scale, seeds, do, lse1,
     lse2, delta2, d1_rest) = _inputs(metric, rate, pack)
    return TFG._biased_backward_compact(
        q, k, v, store, bias_store, do, lse1, lse2, delta2, plan, plan_t,
        metric, scale, rate, seeds, metric in TFG.SCALED_METRICS,
        d1_rest if rest else None, bf16)


@functools.lru_cache(maxsize=None)
def _jax_band(metric, rate):
    """JAX's bf16 band backward at 64 x 64 on the int8 form of the store,
    the port's walks and union statistics: (delta1_band, dbias_blocks,
    delta1_U, dq, dk, dv[, dscale]), numpy, the trash slot dropped."""
    (q, k, v, _, store, bias_store, plan, plan_t, scale, seeds, do, lse1,
     lse2, delta2, d1_rest) = _inputs(metric, rate, True)
    mb = TFG.store_pairs(store)[0].numpy().astype(np.int8)
    cplan, cplan_t = (tuple(p[0].numpy() for p in pl)
                      for pl in (plan, plan_t))
    need = metric in TFG.SCALED_METRICS
    kw = dict(metric=metric, block_m=64, block_n=64, bf16=True,
              dropout_rate=rate)

    @jax.jit
    def ref(q, k, v, bias, do, l1u, l2u, d2, d1_rest, sc, sd):
        d1, db = JHB._band_bwd_pre(q, k, v, mb, bias, do, l1u, l2u, d2,
                                   cplan, sc, sd, **kw)
        d1u = d1 + d1_rest
        return (d1, db, d1u) + tuple(JHB._band_bwd_dq_dkv(
            q, k, v, mb, bias, do, l1u, l2u, d2, d1u, cplan, cplan_t, sc, sd,
            need_dscale=need, **kw))
    out = ref(*(jnp.asarray(t[0].numpy()) for t in (
        q, k, v, bias_store, do, lse1, lse2, delta2, d1_rest)),
        jnp.asarray(scale.numpy()), jnp.asarray(seeds[0].numpy()))
    out = [np.asarray(a) for a in out]
    out[1] = out[1][:store.shape[1]]
    return out


def test_band_mask_cases():
    """The bf16 inputs hold the walks' cases: `band_mask`'s mask, dead
    rows with dO 0, a residual delta1 that is not 0 on live rows, q and k
    at half the fp32 file's scale."""
    (q, _, _, mask, _, _, _, _, _, _, do, _, _, _,
     d1_rest) = _inputs("euclidean", 0.1, True)
    q32 = _compact_biased_bwd_inputs(1, H, N, D, DV, "euclidean", True, 0.1,
                                     SEED, band=True)[0]
    adj = mask[0].numpy() != 0
    assert np.array_equal(adj, band_mask(1, N, SEED)[0] != 0)
    dead = ~adj.any(-1)
    assert dead.sum() >= 6 and (adj.sum(-1) > 128).sum() >= 4
    assert torch.all(do[0][:, dead] == 0)
    assert (d1_rest[0][:, ~dead] != 0).all()
    assert torch.equal(q, BF16_QK_SCALE * q32)


@pytest.mark.parametrize("pack", [True, False])
@pytest.mark.parametrize("metric,rate", CASES)
def test_plain_bf16_compact_biased_bwd_matches_jax(metric, rate, pack,
                                                   interpret):
    """delta1_U, dB at the store's pairs, dq, dk, dv (and dscale for
    gaussian and rbf) of the compact plain bf16 parts with the residual's
    delta1 folded in between B6c and B7a c, against ``_band_bwd_pre`` +
    ``_band_bwd_dq_dkv`` with bf16=True on the same store, walks and
    union statistics, under the bf16 gates with the port's fp32 plain
    parts as the witness; dq exactly 0 on dead rows and dk, dv exactly 0
    at keys no row reaches, on both sides."""
    (_, _, _, mask, store, _, _, _, _, _, _, _, _, _,
     _) = _inputs(metric, rate, pack)
    dq, dk, dv, db, dsc, d1u = _port(metric, rate, pack, True)
    f32 = _port(metric, rate, pack, False)
    want = _jax_band(metric, rate)
    on = TFG.store_pairs(store)[0]
    _check("delta1_U", d1u[0], want[2], f32[5][0])
    _check("dB", db[0][on], want[1][on.numpy()], f32[3][0][on])
    for name, g, w, f in (("dq", dq, want[3], f32[0]),
                          ("dk", dk, want[4], f32[1]),
                          ("dv", dv, want[5], f32[2])):
        _check(name, g[0], w, f[0])
    if metric in TFG.SCALED_METRICS:
        # a sum of many terms that cancel: the max gate alone, as in
        # test_torch_bf16.py
        assert _gates(dsc, want[6], f32[4])[0] <= MAX_TOL
    else:
        assert dsc is None
    adj = mask[0].numpy() != 0
    dead, unreached = ~adj.any(-1), ~adj.any(0)
    assert torch.all(dq[0][:, dead] == 0) and np.all(want[3][:, dead] == 0)
    for g, w in ((dk, want[4]), (dv, want[5])):
        assert torch.all(g[0][:, unreached] == 0)
        assert np.all(w[:, unreached] == 0)


@pytest.mark.parametrize("metric,rate", CASES[:2])
def test_union_delta1_reaches_dq_dk(metric, rate, interpret):
    """The residual's delta1 moves the bf16 B7a c's and B7b c's results:
    with it left out (delta1_rest None) dq and dk fail the max gate
    against JAX's on the union, while delta1 is the band's alone and
    passes against JAX's ``_band_bwd_pre``. A walk that forgot to add it
    fails `test_plain_bf16_compact_biased_bwd_matches_jax`."""
    dq, dk, _, _, _, d1 = _port(metric, rate, True, True, rest=False)
    f32 = _port(metric, rate, True, False, rest=False)
    want = _jax_band(metric, rate)
    _check("delta1_band", d1[0], want[0], f32[5][0])
    assert min(_gates(dq[0], want[3], f32[0][0])[0],
               _gates(dk[0], want[4], f32[1][0])[0]) > 10 * MAX_TOL
