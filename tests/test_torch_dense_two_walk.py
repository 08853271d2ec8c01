"""The plain backward (`flash_geometric_backward_plain`, fp32 and
``bf16=True``), the function that the dense two-walk backward's pair
walks, B3a's row walk and B3b's key walk
(``csrc/flash_pairwalk_two_walk.cu``), are held to on the card, against
JAX's ``flash_geometric_attention_bwd(..., fused=False)`` (the Pallas
``_flash_bwd_dq_kernel`` and ``_flash_bwd_dkv_kernel`` in interpret mode
at the port's 64 x 64 tile), in the cases that are the walks' own. The
mask is `tests.test_torch_gpu.two_walk_mask`: `sparse_mask`'s few keys a
row over several tiles, a whole 64 x 64 tile, a tile of one pair, an
empty tile between walked ones, rows past 128 keys (the row walk flushes
before its end), dead rows; and the key walk's own, an empty key strip
(keys no row reaches: their dk and dv are 0) and keys past 128 rows (the
key walk flushes before its end); N = 330 (a ragged last tile). 33 heads:
two head groups of the row walk's warp (32 items) and five of the key
walk's block (8 heads). dscale at the two metrics with a scale, gaussian
(sigma) with dropout on and rbf (gamma) with dropout off; a non-zero lse
cotangent. Both sides take the same out and lse (the port's plain
forward, its bf16 form for bf16).

Tolerances: fp32 as in test_torch_compact_dq.py (``rtol = atol = 1e-4``:
sums in another order). bf16 under `test_torch_bf16.py`'s three gates
(dq, dk, dv: max error <= 2e-3 and mean error <= 1e-5 of the largest
entry, the port's fp32 plain version at least 100 times the mean error
away; dscale, a sum of terms that cancel, under the max gate alone), q
and k at ``BF16_QK_SCALE`` as the card's bf16 tests take them."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tagan_tpu.ops.pallas import flash_geometric as JFG
from tagan_torch.ops import flash_geometric as TFG
from tests.test_torch_bf16 import MAX_TOL, _check, _gates
from tests.test_torch_gpu import BF16_QK_SCALE, two_walk_mask

# torch's CPU operations on one thread: the tier-1 command runs six
# pytest workers on 8 cores, and torch's default of a thread per core
# oversubscribes them
torch.set_num_threads(1)

# fp32 on both sides, sums in another order (test_torch_compact_dq.py's)
TOL = 1e-4
# 33 heads: a row walk warp holds 32 (row, head) items, a key walk block 8
# heads (csrc/flash_pairwalk_biased_bwd.cuh: KEY_HG)
N, H, D, DV = 330, 33, 16, 8
SEED = 3
# a row's (a key's) list entries between flushes (csrc/flash_pairwalk.cuh:
# CAPR)
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
def _inputs(metric, rate, bf16):
    """One snapshot at `two_walk_mask`'s cases (CPU tensors [1, ...]), q
    and k at half scale for ``bf16``: q, k, v, the mask, scale, one seed,
    dO, an lse cotangent on live rows, and the plain forward's (out, lse)
    (its bf16 form's walking the forward plan for ``bf16``)."""
    rng = np.random.default_rng(SEED + 400)
    qk = BF16_QK_SCALE if bf16 else 1.0
    q, k = (qk * rng.standard_normal((1, H, N, D)).astype(np.float32)
            for _ in range(2))
    v, do = (rng.standard_normal((1, H, N, DV)).astype(np.float32)
             for _ in range(2))
    mask = two_walk_mask(1, N, SEED)
    live = mask[0].any(-1)
    dlse = (0.25 * rng.standard_normal((1, H, N)) * live).astype(np.float32)
    q, k, v, do, dlse, mask = (torch.from_numpy(a)
                               for a in (q, k, v, do, dlse, mask))
    scale = torch.linspace(0.7, 2.0, H)
    seed = torch.tensor([-7], dtype=torch.int32)
    out, lse = TFG.flash_geometric_forward_plain(
        q, k, v, mask, metric, scale, rate, seed, bf16,
        TFG.make_block_plan(mask))
    return q, k, v, mask, scale, seed, do, dlse, out, lse


@functools.lru_cache(maxsize=None)
def _port(metric, rate, bf16, plain_bf16):
    """(dq, dk, dv [H, N, .], dscale f32[H]) of the port's plain backward
    on `_inputs` (``plain_bf16``: its bf16 form)."""
    q, k, v, mask, scale, seed, do, dlse, out, lse = _inputs(metric, rate,
                                                             bf16)
    got = TFG.flash_geometric_backward_plain(
        q, k, v, mask, out, lse, do, metric, scale, rate, seed, True, dlse,
        plain_bf16)
    return tuple(g[0] for g in got[:3]) + (got[3],)


@functools.lru_cache(maxsize=None)
def _jax(metric, rate, bf16):
    """JAX's two-walk backward (fused=False) at 64 x 64, its plans built
    from the mask, on the same (out, lse), dO, lse cotangent and seed,
    jitted once per case: (dq, dk, dv, dscale), numpy."""
    q, k, v, mask, scale, seed, do, dlse, out, lse = _inputs(metric, rate,
                                                             bf16)

    @jax.jit
    def ref(q, k, v, adj, out, lse, do, dlse, sc, sd):
        return JFG.flash_geometric_attention_bwd(
            q, k, v, adj, out, lse, do, metric=metric, scale=sc, block_m=64,
            block_n=64, bf16=bf16, seed=sd, dropout_rate=rate,
            need_dscale=True, fused=False, dlse=dlse)
    got = ref(*(jnp.asarray(t[0].numpy()) for t in (
        q, k, v, mask != 0, out, lse, do, dlse)),
        jnp.asarray(scale.numpy()), jnp.asarray(seed.numpy()))
    return tuple(np.asarray(g) for g in got)


def test_two_walk_mask_cases():
    """The mask holds the walks' cases: rows past 2 CAPR keys and keys
    past 2 CAPR rows (each walk flushes before its end), a whole 64 x 64
    tile, a tile of one pair, an empty tile between walked ones, an empty
    key strip, dead rows, keys that no row reaches, 33 heads."""
    q, _, _, mask = _inputs("gaussian_kernel", 0.1, False)[:4]
    assert q.shape[1] == H and H > 32 and -(-H // 8) == 5
    adj = mask[0].numpy() != 0
    assert (adj.sum(-1) > 2 * CAPR).sum() >= 4
    assert (adj.sum(0) > 2 * CAPR).sum() >= 4
    assert (~adj.any(-1)).sum() >= 6
    assert not adj[:, 128:192].any()
    tiles = adj[:320, :320].reshape(5, 64, 5, 64).sum((1, 3))
    assert tiles[0, 1] == 64 * 64 and tiles[2, 0] == 1 and tiles[1, 3] == 0


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("metric,rate", CASES)
def test_plain_backward_matches_jax_two_walk(metric, rate, bf16, interpret):
    """dq, dk, dv and dscale of the plain backward (fp32, or its bf16
    form) against JAX's two-walk backward on the same inputs at 33 heads:
    fp32 within TOL, bf16 under the gates with the port's fp32 plain
    version the witness; dq 0 on dead rows and dk, dv 0 at keys no row
    reaches on both sides; non-zero dq on the rows past 2 CAPR keys and
    dk on the keys past 2 CAPR rows."""
    mask = _inputs(metric, rate, bf16)[3][0]
    got = _port(metric, rate, bf16, bf16)
    want = _jax(metric, rate, bf16)
    adj = mask.numpy() != 0
    dead, unreached = ~adj.any(-1), ~adj.any(0)
    long_rows, long_keys = adj.sum(-1) > 2 * CAPR, adj.sum(0) > 2 * CAPR
    assert torch.all(got[0][:, dead] == 0) and np.all(want[0][:, dead] == 0)
    for g, w in zip(got[1:3], want[1:3]):
        assert torch.all(g[:, unreached] == 0)
        assert np.all(w[:, unreached] == 0)
    assert np.all(np.abs(want[0][:, long_rows]).max(-1) > 0)
    assert np.all(np.abs(want[1][:, long_keys]).max(-1) > 0)
    assert got[3].shape == want[3].shape == (H,)
    if not bf16:
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), w, rtol=TOL, atol=TOL)
        return
    f32 = _port(metric, rate, bf16, False)
    for name, g, w, f in zip(("dq", "dk", "dv"), got, want, f32):
        _check(name, g, w, f)
    # a sum of many terms that cancel: the max gate alone, as in
    # test_torch_bf16.py
    assert _gates(got[3], want[3], f32[3])[0] <= MAX_TOL
