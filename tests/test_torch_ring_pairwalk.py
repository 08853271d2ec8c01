"""The port's plain B9 (ring flash attention) against the JAX package's
Pallas ring kernel at the masks that put the port's pair walk over each
hop's column block to the test (``tests.test_torch_gpu.ring_walk_mask``):
rows past 2 CAPR = 128 valid keys in one hop, rows valid only in the chunk
that arrives last or only in their own chunk, dead rows.

The JAX side runs on the conftest's 8-device virtual CPU mesh, its Pallas
kernel in interpret mode with emulated remote DMAs, as
``tests/test_torch_ring.py`` runs it; the port's side runs its plain
version on CPU virtual ranks, the same function the card's walk is held to
in ``tests/test_torch_gpu.py``. Inputs are numpy arrays from seeds, fed to
both.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from tagan_tpu.ops.pallas.ring_flash import (ring_flash_attention as
                                             j_ring_flash)
from tagan_torch.dist import mesh as TM
from tagan_torch.ops import flash_geometric as FG
from tagan_torch.ops import ring_flash as TF
from tests.test_torch_bf16 import MAX_TOL, _check
from tests.test_torch_gpu import ring_walk_mask

# torch's CPU operations on one thread: the tier-1 command runs six
# pytest workers on 8 cores, and torch's default of a thread per core
# oversubscribes them
torch.set_num_threads(1)

# fp32 on both sides, the same hops in the same order; sums in another
# order: max abs error over the largest entry (test_torch_ring.py's)
TOL = 1e-5
G = 4
H = 3
SCALE = np.asarray([0.8, 1.3, 2.0], np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


@pytest.fixture(scope="module")
def ring_jit():
    """The JAX ring flash attention, jitted once per (metric, bf16, g)."""
    cache = {}

    def get(metric, bf16=False, g=G):
        if (metric, bf16, g) not in cache:
            # interpret-mode remote DMA takes scalar device ids: a
            # one-axis mesh
            jm = JMesh(np.asarray(jax.devices("cpu")[:g]), ("graph",))
            cache[metric, bf16, g] = jax.jit(
                lambda q, k, v, m, s: j_ring_flash(
                    jm, q, k, v, m, metric=metric, scale_param=s,
                    bf16=bf16))
        return cache[metric, bf16, g]
    return get


def _inputs(per, seed, qk_scale=1.0, g=G):
    """q, k, v [H, N, D] from a seed (q, k times qk_scale; cosine metrics
    normalise them on both sides) and `ring_walk_mask`'s mask at ~8 random
    keys a row, N = g * per."""
    N = g * per
    rng = np.random.default_rng(seed)
    q, k = ((rng.standard_normal((H, N, 16)) * qk_scale).astype(np.float32)
            for _ in range(2))
    v = rng.standard_normal((H, N, 16)).astype(np.float32)
    return q, k, v, ring_walk_mask(g, per, seed=seed)


def _pair(ring_jit, metric, data, bf16=False, g=G):
    """(the port's plain ring, JAX's) on ``data`` over g ranks."""
    q, k, v, mask = data
    want = ring_jit(metric, bf16, g)(q, k, v, mask, SCALE)
    mesh = TM.make_mesh(graph=g, devices=["cpu"] * g)
    got = TF.ring_flash_attention(mesh, *(_t(a) for a in (q, k, v, mask)),
                                  metric=metric, scale_param=_t(SCALE),
                                  bf16=bf16)
    return got, np.asarray(want)


@pytest.mark.parametrize("per", [75, 150])
@pytest.mark.parametrize("metric", FG.MXU_METRICS)
def test_ring_walk_masks_match_jax(metric, per, ring_jit):
    """fp32, every metric, at 4 ranks of 75 rows (two key tiles a hop, the
    second ragged) and of 150 (rows past 128 keys in one hop), per-head
    scales."""
    data = _inputs(per, seed=per)
    got, want = _pair(ring_jit, metric, data)
    assert _err(got, want) <= TOL


@pytest.mark.parametrize("g", [2, 8])
def test_ring_walk_masks_other_rings(g, ring_jit):
    """fp32 at 2 and 8 ranks of 75 rows: the chunk that arrives last is
    the neighbour's at any g, and at g = 2 also the only other one."""
    data = _inputs(75, seed=g, g=g)
    got, want = _pair(ring_jit, "gaussian_kernel", data, g=g)
    assert _err(got, want) <= TOL


@pytest.mark.parametrize("per", [75, 150])
def test_ring_walk_masks_bf16_match_jax(per, ring_jit):
    """The bf16 form under the bf16 gates of ``test_torch_bf16.py``: p is
    rounded against each hop's chunk-wide row max, which the dense rows
    reach in several of the walk's flushes; the fp32 form stands far off
    (the witness)."""
    data = _inputs(per, seed=per + 1, qk_scale=0.5)
    got, want = _pair(ring_jit, "euclidean", data, bf16=True)
    f32, _ = _pair(ring_jit, "euclidean", data)
    _check(f"ring walk bf16 per={per}", got, want, f32)


@pytest.mark.parametrize("bf16", [False, True])
def test_ring_walk_rows(bf16, ring_jit):
    """Each rank's dead row exactly 0 on both sides; its row valid only in
    the chunk that arrives last and its row valid only in its own chunk
    live (not 0) and as JAX's."""
    per = 75
    data = _inputs(per, seed=7, qk_scale=0.5 if bf16 else 1.0)
    got, want = _pair(ring_jit, "gaussian_kernel", data, bf16=bf16)
    got = got.numpy()
    dead = [r * per for r in range(G)]
    only = [r * per + i for r in range(G) for i in (5, 6)]
    assert np.all(got[:, dead] == 0) and np.all(want[:, dead] == 0)
    assert np.all(np.abs(got[:, only]).max(-1) > 0)
    tol = MAX_TOL if bf16 else TOL
    assert _err(got[:, only], want[:, only]) <= tol
