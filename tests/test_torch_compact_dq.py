"""The plain compact backward's dq and dscale
(`flash_geometric_backward_compact_plain`, fp32 and ``bf16=True``), the
function that B3a c's compact row pair walk
(``csrc/flash_pairwalk_bwd_compact.cu``) is held to on the card, against
JAX's ``flash_geometric_attention_bwd`` with 3-tuple plans (the Pallas
``_flash_bwd_dq_kernel`` in interpret mode at the port's 64 x 64 tile, on
the same store and forward walk), in the cases that are the row walk's
own: 33 heads (two head groups of a warp's 32 items); rows whose walks
list more than twice a row list's 64 entries (`band_mask`'s rows past 128
keys: the walk flushes three times or more) beside the band's ~1 valid
pair a row a walked tile, a whole 64 x 64 tile, dead rows and N = 330 (a
ragged last tile); and the per-item d(scale) term summed over rows and
snapshots at the two metrics with a scale, gaussian (sigma) and rbf
(gamma). The walks come from `band_compact` (a walked slot whose bits are
all 0, entries past the counts); one live row's lse is set to
``LSE_DEAD`` though the store lists its pairs. Both stores (JAX takes the
int8 one), both precisions, dropout on at gaussian and off at rbf, a
non-zero lse cotangent.

Tolerances: fp32 as in test_torch_hybrid.py (``rtol = atol = 1e-4``:
sums in another order). bf16 under `test_torch_bf16.py`'s three gates
(dq: max error <= 2e-3 and mean error <= 1e-5 of the largest entry, the
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
# 33 heads: a warp holds 32 (row, head) items, so two head groups
N, H, D, DV = 330, 33, 16, 8
SEED = 3
# the live row whose lse is set to LSE_DEAD
DEAD_LISTED = 7
# a row list's entries between flushes (csrc/flash_pairwalk.cuh: CAPR)
CAPR = 64
# the metrics with a scale, dropout on at one and off at the other
CASES = [("gaussian_kernel", 0.1), ("rbf_kernel", 0.0)]


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
    mask, the store, the forward walk, scale, one seed, dO; the compact
    plain forward's (out, lse) (its bf16 form's for ``bf16``) with row
    DEAD_LISTED's lse at LSE_DEAD, and an lse cotangent on live rows."""
    (q, k, v, mask, store, _, plan, _, scale, seeds, do, _, _, _,
     _) = _compact_biased_bwd_inputs(1, H, N, D, DV, metric, pack, rate,
                                     SEED, BF16_QK_SCALE if bf16 else 1.0,
                                     band=True)
    seed = seeds[:, 0].contiguous()
    out, lse = TFG.flash_geometric_forward_compact_plain(
        q, k, v, store, *plan, metric, scale, rate, seed, bf16=bf16)
    live = (mask != 0).any(-1)
    lse[:, :, DEAD_LISTED] = TFG.LSE_DEAD
    rng = np.random.default_rng(SEED + 700)
    dlse = 0.25 * torch.from_numpy(rng.standard_normal((1, H, N)).astype(
        np.float32)) * live[:, None]
    return q, k, v, mask, store, plan, scale, seed, do, out, lse, dlse


@functools.lru_cache(maxsize=None)
def _port(metric, rate, pack, bf16, plain_bf16):
    """(dq [H, N, D], dscale f32[H]) of the port's plain compact backward
    on `_inputs` (``plain_bf16``: its bf16 form)."""
    (q, k, v, _, store, plan, scale, seed, do, out, lse,
     dlse) = _inputs(metric, rate, pack, bf16)
    got = TFG.flash_geometric_backward_compact_plain(
        q, k, v, store, out, lse, do, *plan, metric, scale, rate, seed,
        True, dlse, plain_bf16)
    return got[0][0], got[3]


@functools.lru_cache(maxsize=None)
def _jax(metric, rate, bf16):
    """JAX's two-walk compact backward at 64 x 64 on the int8 form of the
    store, the port's forward walk (the transposed walk from the mask, as
    the port builds it), the same (out, lse), dO, lse cotangent and seed:
    (dq, dscale), numpy."""
    (q, k, v, mask, store, plan, scale, seed, do, out, lse,
     dlse) = _inputs(metric, rate, True, bf16)
    mb = TFG.store_pairs(store)[0].numpy().astype(np.int8)
    cplan = tuple(p[0].numpy() for p in plan)
    cplan_t = tuple(p[0].numpy() for p in TFG.compact_transposed_plan(mask))

    @jax.jit
    def ref(q, k, v, out, lse, do, dlse, sc, sd):
        return JFG.flash_geometric_attention_bwd(
            q, k, v, mb, out, lse, do, metric=metric, scale=sc, block_m=64,
            block_n=64, bf16=bf16, plan=cplan, plan_t=cplan_t, seed=sd,
            dropout_rate=rate, need_dscale=True, dlse=dlse)
    got = ref(*(jnp.asarray(t[0].numpy()) for t in (
        q, k, v, out, lse, do, dlse)), jnp.asarray(scale.numpy()),
        jnp.asarray(seed.numpy()))
    return np.asarray(got[0]), np.asarray(got[3])


def test_row_walk_cases():
    """The inputs hold the row walk's cases: 33 heads; `band_mask`'s
    mask with rows whose walks list more than 2 CAPR valid pairs, a
    whole tile, dead rows; in the forward walk a walked slot with no bit
    and entries past the counts; the row whose lse is LSE_DEAD has pairs
    in the store."""
    (q, _, _, mask, store, plan, _, _, _, _, lse,
     _) = _inputs("gaussian_kernel", 0.1, True, False)
    assert q.shape[1] == H and H > 32
    adj = mask[0].numpy() != 0
    assert np.array_equal(adj, band_mask(1, N, SEED)[0] != 0)
    assert (~adj.any(-1)).sum() >= 6
    on = TFG.store_pairs(store)[0]
    jl, jc, js = (p[0] for p in plan)
    walked = torch.arange(jl.shape[-1]) < jc[:, None]
    # each row's pairs along its tile's walk, as the walk lists them
    listed = torch.zeros(N, dtype=torch.long)
    for i in range(jc.shape[0]):
        rows = slice(64 * i, min(64 * (i + 1), N))
        for t in range(int(jc[i])):
            listed[rows] += on[int(js[i, t])].sum(-1)[:rows.stop - rows.start]
    assert torch.equal(listed, torch.from_numpy(adj.sum(-1)))
    assert int((listed > 2 * CAPR).sum()) >= 4
    per_tile = on[js[walked].long()].sum((-1, -2))
    assert int((per_tile == 0).sum()) == 1 and int(per_tile.max()) == 64 * 64
    assert (~walked).any()
    assert adj[DEAD_LISTED].any()
    assert torch.all(lse[0, :, DEAD_LISTED] == TFG.LSE_DEAD)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("pack", [True, False])
@pytest.mark.parametrize("metric,rate", CASES)
def test_plain_compact_dq_matches_jax(metric, rate, pack, bf16, interpret):
    """dq and dscale of the compact plain backward (fp32, or its bf16
    form) against JAX's compact backward on the same store, walk, (out,
    lse), cotangents and seed at 33 heads: fp32 within TOL, bf16 under
    the gates with the port's fp32 plain version the witness; dq 0 on
    dead rows on both sides, and non-zero on the rows past 2 CAPR
    pairs."""
    mask = _inputs(metric, rate, pack, bf16)[3][0]
    got = _port(metric, rate, pack, bf16, bf16)
    want = _jax(metric, rate, bf16)
    dead = (mask == 0).all(-1).numpy()
    long_rows = (mask != 0).sum(-1).numpy() > 2 * CAPR
    assert dead.any() and long_rows.any()
    assert torch.all(got[0][:, dead] == 0) and np.all(want[0][:, dead] == 0)
    assert np.all(np.abs(want[0][:, long_rows]).max(-1) > 0)
    assert got[1].shape == want[1].shape == (H,)
    if not bf16:
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), w, rtol=TOL, atol=TOL)
        return
    f32 = _port(metric, rate, pack, bf16, False)
    _check("dq", got[0], want[0], f32[0])
    # a sum of many terms that cancel: the max gate alone, as in
    # test_torch_bf16.py
    assert _gates(got[1], want[1], f32[1])[0] <= MAX_TOL
