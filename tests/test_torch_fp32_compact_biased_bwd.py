"""The plain fp32 compact biased backward with the hybrid band's union
statistics (the compact plain parts, B6c's, then the residual's delta1
added, then B7a c's and B7b c's: `_biased_backward_compact` on CPU
tensors) against the Pallas band backward with ``bf16=False``
(``_band_bwd_pre`` then ``_band_bwd_dq_dkv``, in interpret mode at the
port's 64 x 64 tile, on the same store, walks and union statistics): the
function that the compact row walk (B6c and B7a c) and key walk (B7b c)
of ``csrc/flash_pairwalk_biased_bwd_compact.cu`` are held to on the card,
in the cases they handle differently from a tile walk. The mask comes
from `tests.test_torch_gpu.band_mask`, which the card's tests of the
walks share: ~1 valid pair a row a walked tile over several tiles, a
whole 64 x 64 tile, a tile holding one pair, a key tile no row reaches
(its transposed walk is empty), rows past 128 keys (the row walk's lists
overflow and it walks its slots again), dead rows, N not a multiple of
16. The walks come from `band_compact`: a walked slot whose bits are all
0, and entries past the counts naming other tiles and slots. Both sides
take the port's plain forward statistics raised as a union's, a residual
delta1 that is not 0 (B7a c and B7b c must take the union's delta1), a
cotangent that is 0 on rows with no edge (ROADMAP C10), the bit and the
int8 store (JAX takes the int8 one), every metric, and for gaussian and
rbf the scale's gradient. dB is compared at the store's pairs.

fp32 on both sides, sums in another order: each output's max abs error
over its largest entry (at least 1) is held to ``TOL``."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tagan_tpu.ops.pallas import flash_geometric as JFG
from tagan_tpu.ops.pallas import hybrid_biased as JHB
from tagan_torch.ops import flash_geometric as TFG
from tests.test_torch_gpu import _compact_biased_bwd_inputs, band_mask

# torch's CPU operations on one thread: the tier-1 command runs six
# pytest workers on 8 cores, and torch's default of a thread per core
# oversubscribes them
torch.set_num_threads(1)

# fp32 on both sides, sums in another order; errors over each tensor's
# largest entry (at least 1), since gradients span many scales
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


def _err(got, want):
    want = np.asarray(want, np.float64)
    got = got.detach().numpy().astype(np.float64)
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


@functools.lru_cache(maxsize=None)
def _inputs(metric, rate, pack):
    """One snapshot of `_compact_biased_bwd_inputs` at `band_mask`'s
    cases (CPU tensors)."""
    return _compact_biased_bwd_inputs(1, H, N, D, DV, metric, pack, rate,
                                      SEED, band=True)


@functools.lru_cache(maxsize=None)
def _jax_band(metric, rate):
    """JAX's band backward at 64 x 64 on the int8 form of the store, the
    port's walks and union statistics: (delta1_band, dbias_blocks,
    delta1_U, dq, dk, dv[, dscale]), numpy, the trash slot dropped."""
    (q, k, v, _, store, bias_store, plan, plan_t, scale, seeds, do, lse1,
     lse2, delta2, d1_rest) = _inputs(metric, rate, True)
    mb = TFG.store_pairs(store)[0].numpy().astype(np.int8)
    cplan, cplan_t = (tuple(p[0].numpy() for p in pl)
                      for pl in (plan, plan_t))
    need = metric in TFG.SCALED_METRICS
    kw = dict(metric=metric, block_m=64, block_n=64, bf16=False,
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
    """The mask and walks hold the compact walks' cases: ~1 valid pair a
    row a walked tile on most walked tiles, a whole tile, a one-pair
    tile, a key tile no row reaches, rows past 128 keys, dead rows (dO 0
    there), a walked slot with no bit and entries past the counts that
    name other tiles; the residual delta1 is not 0 on live rows."""
    (_, _, _, mask, store, _, plan, plan_t, _, _, do, lse1, _, _,
     d1_rest) = _inputs("euclidean", 0.1, True)
    adj = mask[0].numpy() != 0
    assert np.array_equal(adj, band_mask(1, N, SEED)[0] != 0)
    dead = ~adj.any(-1)
    assert dead.sum() >= 6 and (adj.sum(-1) > 128).sum() >= 4
    tiles = adj[:320, :320].reshape(5, 64, 5, 64).sum((1, 3))
    assert tiles[0, 1] == 64 * 64 and tiles[2, 0] == 1
    assert not adj[:, 192:256].any() and int(plan_t[1][0, 3]) == 0
    on = TFG.store_pairs(store)[0]
    jl, jc, js = (p[0] for p in plan)
    walked = torch.arange(jl.shape[-1]) < jc[:, None]
    per_tile = on[js[walked].long()].sum((-1, -2))
    assert int((per_tile == 0).sum()) == 1 and int(per_tile.max()) == 4096
    live = per_tile[(per_tile > 0) & (per_tile < 4096)]
    assert float(live.float().median()) <= 2 * 64
    past = ~walked
    assert past.any() and (jl[past] != jl.gather(
        1, (jc - 1).clamp(min=0)[:, None].long()).expand_as(jl)[past]).any()
    assert torch.all(do[0][:, dead] == 0)
    assert (d1_rest[0][:, ~dead] != 0).all()


@pytest.mark.parametrize("pack", [True, False])
@pytest.mark.parametrize("metric,rate", CASES)
def test_plain_fp32_compact_biased_bwd_matches_jax(metric, rate, pack,
                                                   interpret):
    """delta1_U, dB at the store's pairs, dq, dk, dv (and dscale for
    gaussian and rbf) of the compact plain parts with the residual's delta1
    folded in between B6c and B7a c, against ``_band_bwd_pre`` +
    ``_band_bwd_dq_dkv`` on the same store, walks and union statistics,
    within TOL of each output's largest entry; dq exactly 0 on dead rows
    and dk, dv exactly 0 at keys no row reaches, on both sides."""
    (q, k, v, mask, store, bias_store, plan, plan_t, scale, seeds, do, lse1,
     lse2, delta2, d1_rest) = _inputs(metric, rate, pack)
    need = metric in TFG.SCALED_METRICS
    got = TFG._biased_backward_compact(
        q, k, v, store, bias_store, do, lse1, lse2, delta2, plan, plan_t,
        metric, scale, rate, seeds, need, d1_rest)
    want = _jax_band(metric, rate)
    dq, dk, dv, db, dsc, d1u = got
    on = TFG.store_pairs(store)[0]
    errs = {"delta1_U": _err(d1u[0], want[2]),
            "dB": _err(db[0][on], want[1][on.numpy()]),
            "dq": _err(dq[0], want[3]), "dk": _err(dk[0], want[4]),
            "dv": _err(dv[0], want[5])}
    if need:
        errs["dscale"] = _err(dsc, want[6])
    else:
        assert dsc is None
    assert max(errs.values()) <= TOL, errs
    adj = mask[0].numpy() != 0
    dead, unreached = ~adj.any(-1), ~adj.any(0)
    assert torch.all(dq[0][:, dead] == 0) and np.all(want[3][:, dead] == 0)
    for g, w in zip((dk, dv), want[4:6]):
        assert torch.all(g[0][:, unreached] == 0)
        assert np.all(w[:, unreached] == 0)


@pytest.mark.parametrize("metric,rate", CASES[:2])
def test_union_delta1_reaches_dq_dk(metric, rate, interpret):
    """The residual's delta1 moves B7a c's and B7b c's results: with it
    left out (delta1_rest None) dq and dk stand far past TOL from JAX's
    on the union, while delta1 is the band's alone, as JAX's
    ``_band_bwd_pre`` gives it. A walk that forgot to add it fails
    `test_plain_fp32_compact_biased_bwd_matches_jax`."""
    (q, k, v, _, store, bias_store, plan, plan_t, scale, seeds, do, lse1,
     lse2, delta2, _) = _inputs(metric, rate, True)
    dq, dk, _, _, _, d1 = TFG._biased_backward_compact(
        q, k, v, store, bias_store, do, lse1, lse2, delta2, plan, plan_t,
        metric, scale, rate, seeds, False, None)
    want = _jax_band(metric, rate)
    assert _err(d1[0], want[0]) <= TOL
    assert min(_err(dq[0], want[3]), _err(dk[0], want[4])) > 100 * TOL
