"""The ring all-gather's schedule (B8, ``ops.ring_gather.ring_schedule``)
run with torch copies on CPU virtual ranks, as ``csrc/ring_gather.cu``
runs it on a card: B blocks, block b taking items b, b + B, ...; an item
at hop h >= 1 waits for its left rank's flag of hop h - 1 to reach the
ring's epoch; a block releases its last item's flag after its next item's
copy, or before it waits. The blocks are interleaved at random from a
seed; if no block can move, the ring has deadlocked and the test fails.
The gathers are held bit for bit against ``ring_all_gather_plain`` and,
at g = 2, 4 and 8, against JAX's ``ring_all_gather_sharded`` (interpret
mode, emulated remote DMAs, on the conftest's 8-device CPU mesh).
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from tagan_tpu.ops.pallas.ring_gather import (ring_all_gather_sharded as
                                              j_ring_gather_sharded)
from tagan_torch.ops import ring_gather as TG

# torch's CPU operations on one thread: the tier-1 command runs six
# pytest workers on 8 cores
torch.set_num_threads(1)

CPU = torch.device("cpu")
DTYPES = {"fp32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


class Deadlock(AssertionError):
    pass


def _bytes(t):
    return t.reshape(-1).view(torch.uint8)


def _reached(flag, epoch):
    """The kernel's ``reached``: (int)(flag - epoch) >= 0 on 32 bits."""
    return ((int(flag) - epoch) & 0xFFFFFFFF) < (1 << 31)


def run_ring(shards, flags, blocks, seed, cards=None, order=None):
    """One ring of the kernel's schedule over ``shards``, one per rank.
    ``cards[r]`` is rank r's card (all on card 0 by default); each card
    runs ``blocks`` blocks over its own schedule and holds its own flag
    words, taken from ``flags`` (a `_MeshRing`) with the ring's epoch.
    ``order(sched, B)`` gives each block's item numbers (by default the
    kernel's: block b takes b, b + B, ...). Returns each rank's out."""
    g, x0 = len(shards), shards[0]
    cards = [0] * g if cards is None else cards
    ids = sorted(set(cards))
    cb = x0.numel() * x0.element_size()
    scheds = {c: TG.ring_schedule(g, [r for r in range(g) if cards[r] == c],
                                  cb) for c in ids}
    T = scheds[ids[0]].tiles
    # the cards' flag words: disjoint blocks of one CPU buffer
    n = g * g * T
    epoch, (buf,) = flags.take([CPU], len(ids) * n)
    words = {c: buf[i * n:(i + 1) * n] for i, c in enumerate(ids)}
    # outs start as 0xA5 bytes: a copy made before its rows arrived, or a
    # missing one, shows
    outs = [torch.empty((g * x0.shape[0],) + tuple(x0.shape[1:]),
                        dtype=x0.dtype) for _ in range(g)]
    for o in outs:
        _bytes(o).fill_(0xA5)
    src_of = [_bytes(x) for x in shards]
    out_of = [_bytes(o) for o in outs]
    order = order or (lambda s, B: [list(range(b, s.n_items, B))
                                    for b in range(B)])
    # a block: (card, its items, next position, unreleased (card, flag))
    state = [[c, items, 0, None] for c in ids
             for items in order(scheds[c], blocks)]
    rng = random.Random(seed)

    def release(blk):
        if blk[3] is not None:
            words[blk[3][0]][blk[3][1]] = epoch
            blk[3] = None

    def waits_on(blk):
        """The (card, flag) the block's next item waits on, if not there."""
        it = scheds[blk[0]].item(blk[1][blk[2]])
        if it.wait is None:
            return None
        card = cards[(it.rank - 1) % g]
        return None if _reached(words[card][it.wait], epoch) else \
            (card, it.wait)

    live = [blk for blk in state if blk[1]]
    while live:
        # a block can move if it has a flag to release or its next item
        # is not waiting
        movable = [blk for blk in live if blk[3] is not None or
                   blk[2] == len(blk[1]) or waits_on(blk) is None]
        if not movable:
            raise Deadlock(f"no block can move: "
                           f"{[(b[0], b[1][b[2]]) for b in live]}")
        blk = rng.choice(movable)
        if blk[2] == len(blk[1]):
            release(blk)
            live.remove(blk)
            continue
        if waits_on(blk) is not None:
            release(blk)              # the kernel releases, then spins
            continue
        it = scheds[blk[0]].item(blk[1][blk[2]])
        lo = it.chunk * cb + it.offset
        if it.hop == 0:
            src = src_of[it.rank][it.offset:it.offset + it.nbytes]
        else:
            src = out_of[(it.rank - 1) % g][lo:lo + it.nbytes]
        out_of[it.rank][lo:lo + it.nbytes] = src
        release(blk)                  # the block's last item
        blk[3] = (blk[0], it.flag)
        blk[2] += 1
    return outs


def _shards(g, rows, D, dtype, seed):
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (g * rows, D)).astype(np.float32)).to(dtype)
    return list(torch.chunk(x, g)), x


def _rows(D, dtype, g, several):
    """Odd chunk lengths: under one tile, or over two."""
    if not several:
        return 37 + 2 * g
    row = D * torch.tensor([], dtype=dtype).element_size()
    return 2 * TG.TILE_BYTES // row + 37


def _check(outs, shards):
    want = TG.ring_all_gather_plain(shards)
    assert len(outs) == len(want)
    for o, w in zip(outs, want):
        assert o.dtype == w.dtype and torch.equal(_bytes(o), _bytes(w))


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("D", [7, 64])
@pytest.mark.parametrize("g", [1, 2, 3, 4, 8])
def test_schedule_gathers_under_random_interleavings(g, D, dtype):
    """Both chunk lengths, B from 1 to past the item count, two rings in a
    row on one flag buffer (the second on the next epoch, and, after the
    longer chunk, on the words that grew): bit for bit, no deadlock."""
    tdt = DTYPES[dtype][0]
    flags = TG._MeshRing()
    for several in (False, True):
        shards, _ = _shards(g, _rows(D, tdt, g, several), D, tdt, seed=g * D)
        n = TG.ring_schedule(g, range(g), shards[0].numel()
                             * shards[0].element_size()).n_items
        T = n // (g * g)
        assert T > 2 if several else T == 1
        for blocks in sorted({1, 2, 7, n // 2 + 1, n, n + 5}):
            for ring in range(2):
                epoch = flags.epoch
                outs = run_ring(shards, flags, blocks,
                                seed=1000 * blocks + 10 * ring + several)
                assert flags.epoch == epoch + 1
                _check(outs, shards)


@pytest.mark.parametrize("g", [2, 4, 8])
def test_schedule_matches_jax_ring(g):
    """The schedule's gather against the Pallas ring in interpret mode,
    bit for bit on every rank, at D = 7 and 64 in fp32 and bf16, over a
    chunk of several tiles."""
    jm = JMesh(np.asarray(jax.devices("cpu")[:g]), ("graph",))
    for D in (7, 64):
        for tdt, jdt in DTYPES.values():
            shards, x = _shards(g, _rows(D, tdt, g, True), D, tdt,
                                seed=g + D)
            xj = jnp.asarray(x.float().numpy()).astype(jdt)
            want = np.asarray(j_ring_gather_sharded(
                jm, jax.device_put(xj, NamedSharding(jm, P("graph"))),
                "graph").astype(jnp.float32))
            outs = run_ring(shards, TG._MeshRing(), blocks=13, seed=g)
            for o in outs:
                np.testing.assert_array_equal(o.float().numpy(), want)


@pytest.mark.parametrize("g", [1, 2, 3, 5, 8])
def test_schedule_items_and_waits(g):
    """Every (rank, hop, tile) is one item, its flag released once; hop 0
    copies the rank's own chunk and hop h the chunk its left rank wrote at
    h - 1, whose flag it waits on; on one card that item has a lower
    number, so a block never waits on itself or a later item."""
    for cb in (0, 100, 3 * TG.TILE_BYTES - 16):
        s = TG.ring_schedule(g, range(g), cb)
        items = [s.item(i) for i in range(s.n_items)]
        assert s.n_items == g * g * s.tiles
        assert sorted(it.flag for it in items) == list(range(s.n_items))
        number = {it.flag: i for i, it in enumerate(items)}
        written = set()
        for i, it in enumerate(items):
            assert 0 <= it.nbytes <= TG.TILE_BYTES
            assert it.offset + it.nbytes <= cb
            written.add((it.rank, it.chunk, it.tile))
            if it.hop == 0:
                assert it.chunk == it.rank and it.wait is None
                continue
            src = items[number[it.wait]]
            assert (src.rank, src.hop, src.tile, src.chunk) == (
                (it.rank - 1) % g, it.hop - 1, it.tile, it.chunk)
            assert number[it.wait] < i
        assert len(written) == g * g * s.tiles
        assert sum(it.nbytes for it in items) == g * g * cb


@pytest.mark.parametrize("cards", [[0, 1, 0, 1], [0, 0, 1, 1, 1, 2],
                                   [0, 1, 2, 3, 4, 5, 6, 7]])
def test_schedule_over_several_cards(cards):
    """Ranks on several cards: a launch a card over its own ranks, each
    card's flags its own, a rank waiting on its left rank's card. Every
    interleaving drawn gathers bit for bit, B = 1 to past the items."""
    g = len(cards)
    shards, _ = _shards(g, _rows(7, torch.float32, g, True), 7,
                        torch.float32, seed=g)
    flags = TG._MeshRing()
    for blocks in (1, 3, 64, 1000):
        _check(run_ring(shards, flags, blocks, seed=blocks, cards=cards),
               shards)


def test_executor_finds_a_deadlock():
    """The executor fails a schedule that can deadlock: one block taking
    its items last hop first waits on a flag no one will release."""
    shards, _ = _shards(4, 41, 64, torch.float32, seed=0)
    with pytest.raises(Deadlock):
        run_ring(shards, TG._MeshRing(), 1, seed=0,
                 order=lambda s, B: [list(range(s.n_items))[::-1]])


def test_epochs_restart_with_zeroed_flags():
    """Past EPOCHS - 1 the epoch starts again at 1 and every flag word of
    the mesh is zeroed first: the rings on either side gather right (old
    flags at 2^31 - 1 would let a ring at epoch 1 read rows not yet
    written)."""
    shards, _ = _shards(3, 301, 64, torch.float32, seed=3)
    flags = TG._MeshRing()
    flags.epoch = TG.EPOCHS - 3
    for ring in range(4):
        _check(run_ring(shards, flags, 5, seed=ring), shards)
    assert flags.epoch == 2
    words = flags.words[CPU]
    assert int(words.max()) == 2 and words.dtype == torch.int32


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.uint8])
@pytest.mark.parametrize("rest", [(7,), (64,), (3, 5), (0,)])
def test_outs_are_aligned_views_of_one_slab(rest, dtype):
    """The wrapper's outs on a card: one allocation, a slab of rows a rank,
    every out contiguous, of its shape, on the 16-byte grid from the
    slab's start (so every hop moves in bulk), the slabs apart."""
    for g, chunk in ((1, 37), (3, 41), (4, 5)):
        x0 = torch.zeros((chunk,) + rest, dtype=dtype)
        outs = TG._outs(x0, g, [CPU], [list(range(g))])
        base = outs[0].data_ptr()
        nbytes = g * x0.numel() * x0.element_size()
        for r, o in enumerate(outs):
            assert o.shape == (g * chunk,) + rest and o.dtype == dtype
            assert o.is_contiguous()
            assert (o.data_ptr() - base) % 16 == 0
            if r:
                assert o.data_ptr() - outs[r - 1].data_ptr() >= nbytes


class _FakeCards:
    """Stands in for the CUDA runtime under `_RingGatherKernel.__call__`
    on the CPU: cards ``cuda:i`` whose tensors are CPU tensors, streams
    known by a raw handle, events, and the kernel's C function, all
    writing to ``log`` in the order the wrapper issues them."""

    def __init__(self, monkeypatch):
        self.log, self.current, self.handles = [], 0, {}
        self.streams, self.rings = {}, {}
        fake = self

        class Stream:
            def __init__(self, index, handle):
                self.index, self.handle = index, handle

            def wait_event(self, ev):
                fake.log.append(("wait", self.index, ev.id))

            def wait_stream(self, other):
                fake.log.append(("wait_stream", self.index, other.handle))

        class Event:
            def record(self, stream):
                self.id = len(fake.log)
                fake.log.append(("record", stream.index, self.id))

        class Device:
            def __init__(self, d):
                self.index = d.index

            def __enter__(self):
                self.prev, fake.current = fake.current, self.index

            def __exit__(self, *exc):
                fake.current = self.prev

        def current_stream(d):
            h = self.handle(d.index)
            return self.streams.setdefault(h, Stream(d.index, h))

        def on_cpu(fn, name):
            def make(*a, device=None, **k):
                self.log.append((name, device.index))
                return fn(*a, **k)
            return make

        def launch(ptrs, cb, g, n, T, epoch, grid, sys, stream):
            p = ptrs._obj
            self.log.append(("launch", self.current, tuple(p.local[:n]),
                             T, epoch, sys, stream,
                             tuple(p.card[:g])))
            return 0

        monkeypatch.setattr(torch, "empty", on_cpu(torch.empty, "empty"))
        monkeypatch.setattr(torch, "zeros", on_cpu(torch.zeros, "zeros"))
        monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                            self.handle, raising=False)
        monkeypatch.setattr(torch.cuda, "current_stream", current_stream)
        monkeypatch.setattr(torch.cuda, "current_device",
                            lambda: self.current)
        monkeypatch.setattr(torch.cuda, "device", Device)
        monkeypatch.setattr(torch.cuda, "Event", Event)
        monkeypatch.setattr(TG, "enable_peer", lambda name, d, peer:
                            self.log.append(("peer", d.index, peer.index)))
        kern = TG.ring_gather_kernel
        monkeypatch.setattr(kern, "_function", lambda: launch)
        monkeypatch.setattr(kern, "max_blocks", lambda d, sys: 8)

    def handle(self, index):
        """Card ``index``'s current stream, as a raw handle."""
        return self.handles.get(index, 100 + index)

    def ring(self, devs, rows=41, D=7):
        """One ring of the wrapper over ranks on ``devs``; returns its
        outs and the log entries it wrote."""
        start = len(self.log)
        shards, _ = _shards(len(devs), rows, D, torch.float32, seed=rows)
        ring = self.rings.setdefault(tuple(devs), TG._MeshRing())
        outs = TG.ring_gather_kernel(shards, ring, TG._Layout(devs))
        return outs, ring, self.log[start:]


@pytest.mark.parametrize("cards", [[0, 1], [0, 1, 0, 1], [0, 0, 1, 1, 1, 2],
                                   [2, 0, 1]])
def test_wrapper_on_several_cards(cards, monkeypatch):
    """Ranks on several cards: peer access from each rank's card to its
    left rank's; before any launch every card's stream waits on an event
    of every other card's; then one launch a card, with the card set, on
    its stream, over its own ranks in rank order at .sys scope; then every
    card's stream waits on an event of every other card's recorded after
    all the launches. The flag words are zeroed before the cards wait on
    each other (the other cards read them), the outs allocated on their
    own cards."""
    fake = _FakeCards(monkeypatch)
    devs = [torch.device("cuda", c) for c in cards]
    ids = list(dict.fromkeys(cards))
    g = len(cards)
    before = TG.ring_gather_kernel.launches
    outs, ring, log = fake.ring(devs)
    assert TG.ring_gather_kernel.launches - before == len(ids)
    assert [len(o) for o in outs] == [g * 41] * g
    peers = {(e[1], e[2]) for e in log if e[0] == "peer"}
    assert peers == {(cards[r], cards[r - 1]) for r in range(g)}
    launches = [i for i, e in enumerate(log) if e[0] == "launch"]
    assert [log[i][1] for i in launches] == ids
    first_record = min(i for i, e in enumerate(log) if e[0] == "record")
    assert sorted(e[1] for e in log[:first_record] if e[0] == "zeros") == \
        sorted(ids)
    assert sorted(e[1] for e in log if e[0] == "empty") == sorted(ids)
    for i, c in zip(launches, ids):
        _, _, local, T, epoch, sys, stream, card = log[i]
        assert local == tuple(r for r in range(g) if cards[r] == c)
        assert (T, epoch, sys, stream) == (1, 1, 1, 100 + c)
        assert card == tuple(ids.index(x) for x in cards)
    for part in (log[:launches[0]], log[launches[-1]:]):
        recorded = {e[2]: e[1] for e in part if e[0] == "record"}
        waits = {(e[1], recorded[e[2]]) for e in part if e[0] == "wait"}
        assert sorted(recorded.values()) == sorted(ids)
        assert waits == {(a, b) for a in ids for b in ids if a != b}
    assert sorted(d.index for d in ring.words) == sorted(ids)
    assert all(w.numel() == g * g for w in ring.words.values())


def test_wrapper_follows_the_stream_of_the_last_ring(monkeypatch):
    """A ring issued on the stream of the mesh's last ring on that card
    waits on nothing; one issued on another stream first makes that
    stream wait on the last ring's (its flags would let an earlier ring
    on); on one card no event is recorded."""
    fake = _FakeCards(monkeypatch)
    one = [torch.device("cuda", 0)] * 3
    _, ring, log = fake.ring(one)
    assert [e[0] for e in log] == ["zeros", "empty", "launch"]
    _, _, log = fake.ring(one)
    assert [e[0] for e in log] == ["empty", "launch"]
    fake.handles[0] = 7
    _, _, log = fake.ring(one)
    assert [e[0] for e in log] == ["wait_stream", "empty", "launch"]
    assert log[0] == ("wait_stream", 0, 100) and log[2][6] == 7
    assert ring.epoch == 3
    two = [torch.device("cuda", 0), torch.device("cuda", 1)]
    fake.ring(two)
    fake.handles[1] = 9
    _, _, log = fake.ring(two)
    assert [e for e in log if e[0] == "wait_stream"] == [
        ("wait_stream", 1, 101)]
    assert log.index(("wait_stream", 1, 101)) < min(
        i for i, e in enumerate(log) if e[0] != "wait_stream")
