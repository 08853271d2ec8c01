"""The port's mesh, ring all-gather (B8), ring flash attention (B9) and
collective ring (``tagan_torch.dist``) against the JAX package on the CPU.

The JAX side runs on the conftest's 8-device virtual CPU mesh, its Pallas
ring kernels in interpret mode with emulated remote DMAs (as
``tests/test_ring_gather.py`` and ``tests/test_ring_flash.py`` run them);
the port's side runs its plain versions on CPU virtual ranks. Inputs are
numpy arrays from seeds, fed to both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from tagan_tpu.dist import edge_partition as JE
from tagan_tpu.dist.mesh import make_mesh as j_make_mesh
from tagan_tpu.ops.pallas.ring_flash import (ring_flash_attention as
                                             j_ring_flash)
from tagan_tpu.ops.pallas.ring_gather import (ring_all_gather as j_ring_gather,
                                              ring_all_gather_sharded as
                                              j_ring_gather_sharded)
from tagan_torch.dist import edge_partition as TE
from tagan_torch.dist import mesh as TM
from tagan_torch.ops import ring_flash as TF
from tagan_torch.ops import ring_gather as TG
from tests.test_torch_bf16 import _check

# torch's CPU operations on one thread: the tier-1 command runs six
# pytest workers on 8 cores, and torch's default of a thread per core
# oversubscribes them
torch.set_num_threads(1)

# fp32 on both sides, the same hops in the same order; sums in another
# order: max abs error over the largest entry
TOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _jmesh(g):
    # interpret-mode remote DMA takes scalar device ids: a one-axis mesh
    return JMesh(np.asarray(jax.devices("cpu")[:g]), ("graph",))


def _mesh(g, data=1):
    return TM.make_mesh(data=data, graph=g, devices=["cpu"] * (data * g))


def _err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _attn_data(N, H=2, D=16, seed=0, dead_row=None):
    """q, k, v [H, N, D] and a bool mask with self loops, as
    ``tests/test_ring_flash.py`` draws them."""
    r = np.random.default_rng(seed)
    q, k, v = (r.standard_normal((H, N, D)).astype(np.float32)
               for _ in range(3))
    adj = r.random((N, N)) < 0.3
    adj[np.arange(N), np.arange(N)] = True
    if dead_row is not None:
        adj[dead_row] = False
    return q, k, v, adj


def test_make_mesh():
    """Shapes and axes as JAX's, virtual ranks (a device repeated), the
    ring along the graph axis, no streams on the CPU, and the raise on a
    grid that does not cover the devices."""
    for data, graph in ((None, 1), (2, 4), (4, 2), (1, 8), (None, 2)):
        jm = j_make_mesh(data=data, graph=graph)
        tm = TM.make_mesh(data=data, graph=graph, devices=["cpu"] * 8)
        assert tm.shape == dict(jm.shape) and tm.axis_names == jm.axis_names
        assert tm.devices.shape == jm.devices.shape and tm.size == 8
        assert tm.ring("graph") == [torch.device("cpu")] * graph
        assert tm.ring_streams("graph") == ([None] * graph, [None] * graph)
    with pytest.raises(AssertionError):
        j_make_mesh(data=3, graph=2)
    with pytest.raises(AssertionError):
        TM.make_mesh(data=3, graph=2, devices=["cpu"] * 8)
    with pytest.raises(AssertionError):
        TM.make_mesh(graph=3, devices=["cpu"] * 8)
    x = torch.arange(24.0).reshape(8, 3)
    shards = TM.shard_rows(_mesh(4), x)
    assert [tuple(s.shape) for s in shards] == [(2, 3)] * 4
    assert torch.equal(TM.gather_rows(shards), x)
    with pytest.raises(ValueError):
        TM.shard_rows(_mesh(3), x)


@pytest.mark.parametrize("g", [2, 4, 8])
def test_ring_all_gather_matches_jax(g):
    """B8's plain version against the Pallas ring, bit for bit, on every
    rank."""
    x = np.random.default_rng(g).standard_normal((g * 16, 128)).astype(
        np.float32)
    jm = _jmesh(g)
    want = np.asarray(j_ring_gather_sharded(
        jm, jax.device_put(jnp.asarray(x), NamedSharding(jm, P("graph"))),
        "graph"))
    got = TG.ring_all_gather_sharded(_mesh(g), torch.from_numpy(x), "graph")
    assert len(got) == g
    for out in got:
        np.testing.assert_array_equal(out.numpy(), want)


def test_ring_all_gather_inside_a_computation():
    """The gather feeding local compute, per rank (the edge-partition
    pattern of ``tests/test_ring_gather.py``)."""
    g, N, D = 4, 32, 128
    rng = np.random.default_rng(1)
    k = rng.standard_normal((N, D)).astype(np.float32)
    q = rng.standard_normal((N, D)).astype(np.float32)
    jm = _jmesh(g)

    def local(q_l, k_l):
        return q_l @ j_ring_gather(k_l, "graph", g, interpret=True).T

    fn = jax.jit(jax.shard_map(local, mesh=jm, in_specs=(P("graph"),
                                                         P("graph")),
                               out_specs=P("graph"), check_vma=False))
    sh = NamedSharding(jm, P("graph"))
    want = np.asarray(fn(jax.device_put(jnp.asarray(q), sh),
                         jax.device_put(jnp.asarray(k), sh)))
    mesh = _mesh(g)
    qs = TM.shard_rows(mesh, torch.from_numpy(q))
    kg = TG.ring_all_gather(TM.shard_rows(mesh, torch.from_numpy(k)), mesh)
    got = TM.gather_rows([q_l @ k_l.T for q_l, k_l in zip(qs, kg)])
    assert _err(got, want) <= TOL


@pytest.fixture(scope="module")
def ring_flash_jit():
    """The JAX ring flash attention, jitted once per (g, metric, bf16)."""
    cache = {}

    def get(g, metric, bf16=False):
        key = (g, metric, bf16)
        if key not in cache:
            jm = _jmesh(g)
            cache[key] = jax.jit(lambda q, k, v, m, s: j_ring_flash(
                jm, q, k, v, m, metric=metric, scale_param=s, bf16=bf16))
        return cache[key]
    return get


def _ring_flash_pair(ring_flash_jit, g, metric, data, scale, bf16=False):
    q, k, v, adj = data
    want = ring_flash_jit(g, metric, bf16)(q, k, v, adj, scale)
    got = TF.ring_flash_attention(_mesh(g), *(_t(a) for a in (q, k, v, adj)),
                                  metric=metric, scale_param=_t(scale),
                                  bf16=bf16)
    return got, np.asarray(want)


@pytest.mark.parametrize("metric", ["scaled_dot_product", "euclidean",
                                    "cosine_similarity"])
@pytest.mark.parametrize("g", [2, 4])
def test_ring_flash_matches_jax(g, metric, ring_flash_jit):
    """B9's plain version against the Pallas ring flash kernel."""
    data = _attn_data(16 * g, seed=g)
    got, want = _ring_flash_pair(ring_flash_jit, g, metric, data,
                                 np.ones(2, np.float32))
    assert _err(got, want) <= TOL


def test_ring_flash_scaled_metric_and_dead_row(ring_flash_jit):
    """gaussian_kernel with a per-head sigma; the dead row exactly 0."""
    data = _attn_data(48, seed=9, dead_row=5)
    got, want = _ring_flash_pair(ring_flash_jit, 4, "gaussian_kernel", data,
                                 np.asarray([0.8, 1.3], np.float32))
    assert _err(got, want) <= TOL
    assert torch.all(got[:, 5] == 0) and np.all(want[:, 5] == 0)


def test_ring_flash_bf16_matches_jax(ring_flash_jit):
    """B9's bf16 form against the Pallas kernel's ``bf16=True`` under the
    bf16 gates of ``test_torch_bf16.py``: the rounding of p depends on the
    chunk-wide max of each hop, in each rank's ring order, so both sides
    must walk alike; the fp32 form stands far off (the witness)."""
    data = _attn_data(64, seed=3, dead_row=7)
    scale = np.ones(2, np.float32)
    got, want = _ring_flash_pair(ring_flash_jit, 4, "euclidean", data, scale,
                                 bf16=True)
    f32 = TF.ring_flash_attention(_mesh(4), *(_t(a) for a in data),
                                  metric="euclidean")
    _check("ring flash bf16", got, want, f32)
    assert torch.all(got[:, 7] == 0)


def _edges(N, E, seed):
    """A random edge list with self loops on every node (so every query
    has mass) and a few masked entries."""
    rng = np.random.default_rng(seed)
    eq = np.concatenate([rng.integers(0, N, E), np.arange(N)]).astype(
        np.int32)
    ek = np.concatenate([rng.integers(0, N, E), np.arange(N)]).astype(
        np.int32)
    em = np.concatenate([rng.random(E) > 0.2, np.ones(N, bool)])
    return eq, ek, em


def test_partitioners_match_jax():
    """The host partitioners are the JAX package's numpy code: the same
    arrays, edge ids included, and the same overflow raise."""
    eq, ek, em = _edges(32, 200, 0)
    ids = np.arange(len(eq), dtype=np.int32)
    ids[-32:] = -1
    for got, want in ((TE.partition_edges_by_query(eq, ek, em, 32, 4),
                       JE.partition_edges_by_query(eq, ek, em, 32, 4)),
                      (TE.partition_edges_by_query_and_key(
                          eq, ek, em, 32, 4, edge_ids=ids),
                       JE.partition_edges_by_query_and_key(
                           eq, ek, em, 32, 4, edge_ids=ids))):
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    for part in (TE.partition_edges_by_query, JE.partition_edges_by_query):
        with pytest.raises(ValueError):
            part(np.zeros(10, np.int32), np.arange(10, dtype=np.int32),
                 np.ones(10, bool), 8, 2, max_edges_per_shard=4)
    rep = TE.scaling_report(_mesh(2, data=4), 100.0, 640.0)
    assert rep == JE.scaling_report(j_make_mesh(data=4, graph=2), 100.0,
                                    640.0)


def _qkv(H, N, D, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((H, N, D)).astype(np.float32)
                 for _ in range(3))


def test_edge_partitioned_attention_matches_jax():
    """The all-gather formulation on a (data=2, graph=4) mesh."""
    H, N, D = 2, 32, 8
    q, k, v = _qkv(H, N, D, 0)
    peq, pek, pem, _ = TE.partition_edges_by_query(*_edges(N, 200, 1), N, 4)
    sigma = np.asarray([0.7, 1.4], np.float32)
    want = JE.edge_partitioned_attention(
        j_make_mesh(data=2, graph=4), "gaussian_kernel", jnp.asarray(q),
        jnp.asarray(k), jnp.asarray(v), peq, pek, pem,
        sigma=jnp.asarray(sigma))
    got = TE.edge_partitioned_attention(
        _mesh(4, data=2), "gaussian_kernel", *(_t(a) for a in (q, k, v)),
        peq, pek, pem, sigma=_t(sigma))
    assert _err(got, want) <= TOL


@pytest.mark.parametrize("biased", [False, True])
def test_ring_attention_matches_jax(biased):
    """`make_ring_attention` with attention dropout as explicit keep
    masks, unbiased (gaussian, per-head sigma) and the biased double
    softmax (euclidean), on a (data=2, graph=4) mesh."""
    H, N, D, g, rate = 2, 32, 8, 4, 0.25
    metric = "euclidean" if biased else "gaussian_kernel"
    q, k, v = _qkv(H, N, D, 2)
    eq, ek, em, Ep = TE.partition_edges_by_query_and_key(
        *_edges(N, 160, 3), N, g)
    rng = np.random.default_rng(4)
    keep = rng.random(((2,) if biased else ()) + (H, g, g, Ep)) > rate
    sigma, gamma, cov = JE.metric_placeholders(H, D, jnp.float32)
    sigma = jnp.asarray([0.9, 1.6], jnp.float32)
    args = [q, k, v, eq, ek, em]
    if biased:
        args.append(rng.standard_normal((g, g, Ep)).astype(np.float32))
    jfn = jax.jit(JE.make_ring_attention(j_make_mesh(data=2, graph=4),
                                         metric, H, N, D, dropout_rate=rate,
                                         biased=biased))
    want = jfn(*(jnp.asarray(a) for a in args), sigma, gamma, cov,
               jnp.asarray(keep))
    tfn = TE.make_ring_attention(_mesh(g, data=2), metric, H, N, D,
                                 dropout_rate=rate, biased=biased)
    got = tfn(*(_t(a) for a in args), *(_t(a) for a in (sigma, gamma, cov)),
              _t(keep))
    assert _err(got, want) <= TOL


def test_ring_flash_matches_collective_ring():
    """The ring flash kernel's plain version against the port's collective
    ring on the same mask (``tests/test_ring_flash.py:64-84``); the
    collective ring against JAX's."""
    g, N = 4, 32
    q, k, v, adj = _attn_data(N, seed=11)
    src, dst = np.nonzero(adj)
    eq, ek, em, _ = TE.partition_edges_by_query_and_key(
        src.astype(np.int32), dst.astype(np.int32), np.ones_like(src, bool),
        N, g)
    coll = TE.ring_edge_attention(_mesh(g, data=2), "scaled_dot_product",
                                  *(_t(a) for a in (q, k, v)), eq, ek, em)
    want = JE.ring_edge_attention(j_make_mesh(data=2, graph=g),
                                  "scaled_dot_product", jnp.asarray(q),
                                  jnp.asarray(k), jnp.asarray(v), eq, ek, em)
    fused = TF.ring_flash_attention(_mesh(g), *(_t(a) for a in (q, k, v, adj)))
    assert _err(coll, want) <= TOL
    assert _err(fused, coll) <= TOL


def test_what_raises():
    """A metric outside MXU_METRICS (as JAX raises), N not divisible by
    g, a head dim past 128, ranks on CUDA without a card, a CPU tensor
    handed to the kernel, shards that do not fit the ring."""
    q, k, v, adj = _attn_data(32)
    with pytest.raises(NotImplementedError):
        j_ring_flash(_jmesh(4), *(jnp.asarray(a) for a in (q, k, v, adj)),
                     metric="manhattan")
    with pytest.raises(NotImplementedError):
        TF.ring_flash_attention(_mesh(4), *(_t(a) for a in (q, k, v, adj)),
                                metric="manhattan")
    with pytest.raises(ValueError):
        TF.ring_flash_attention(_mesh(3), *(_t(a) for a in (q, k, v, adj)))
    wide = np.zeros((2, 32, 130), np.float32)
    with pytest.raises(ValueError):
        TF.ring_flash_attention(_mesh(4), *(_t(wide),) * 3, _t(adj))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            TM.make_mesh(graph=2, devices=["cuda"] * 2)
    with pytest.raises(ValueError):
        TG.ring_copy_kernel(torch.zeros(4), torch.zeros(4), None)
    shards = TM.shard_rows(_mesh(2), torch.zeros(8, 4))
    with pytest.raises(ValueError):
        TG.ring_all_gather(shards[:1], _mesh(2))
    with pytest.raises(ValueError):
        TG.ring_all_gather([shards[0], shards[1][:, :2]], _mesh(2))
