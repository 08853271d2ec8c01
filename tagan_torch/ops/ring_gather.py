"""Ring all-gather of row shards over a mesh axis (B8).

Counterpart of ``tagan_tpu/ops/pallas/ring_gather.py``: every rank of the
axis holds a row shard ``[chunk, ...]`` and ends with all of them,
``[g * chunk, ...]`` in rank order, in the shard's dtype.

The TPU kernel ``_ring_kernel`` runs the ring inside one Pallas call per
chip, its hops remote DMAs ordered by semaphores. Here the ranks are those
of a `Mesh` (``tagan_torch.dist.mesh``), possibly virtual ranks of one
card, and the ring is one launch a card of ``csrc/ring_gather.cu``, for
every rank of the ring on that card, its hops ordered by flags in device
memory (the source's header says how). The outs of one card are views of
one allocation, a slab of rows a rank padded to 16 bytes. `ring_schedule` is the kernel's
numbering of its work: each chunk cut into tiles, an item per (rank, hop,
tile), hop-major, each item's wait on the left rank's item of the hop
before. The wrapper takes the tile count and the grid from it, and the CPU
tests run it with torch copies under random interleavings of the blocks.

Each ring takes the next epoch of its mesh, and the flags it releases
hold that epoch; the flag words (a few KB) are allocated and zeroed once
per mesh and card and never reset between rings. A flag at or past the
epoch a ring waits for lets it on, so the rings of one mesh must run on
each card in the order they were issued: the mesh keeps the stream of
its last ring on each card, and a ring issued on another stream makes
the current one wait for it first. Where all ranks share one card and
the stream is the last ring's, the ring is one launch on the card's
current stream and nothing else: no event, no stream wait. Ranks on
several cards take a launch a card, each on that card's current stream,
after that stream waits for the work queued so far on every other
card's (`_wait_all`: the allocator of one card does not know that
another card still reads the memory it hands out), and each card's
stream waits for every launch of the ring before it returns (the right
neighbours read its rows). A rank reads its left neighbour's rows and
flags through a peer pointer, after peer access is enabled; a pair of
cards without it raises.

`ring_copy_kernel` (``tagan_ring_copy``, the same source) is the ring
flash's chunk mover (``ops.ring_flash``): one copy on a given stream.

CPU shards take the plain version, the rank-order concatenation; CUDA
shards launch the kernel or raise. `ring_all_gather_sharded` first cuts
x into the ranks' shards (`shard_rows`, plain torch copies: the TPU
wrapper's sharded input); the gather itself moves rows only with the
kernel.
"""

from __future__ import annotations

import ctypes
import math
import weakref
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from ..dist.mesh import GRAPH_AXIS, Mesh, shard_rows
from . import build
from .flash_geometric import _I, _P, _U, _CudaKernel

# csrc/ring_gather.cu: TILE, MAX_RANKS, MAX_CARDS
TILE_BYTES = 32 * 1024
MAX_RANKS = 200
MAX_CARDS = 16
# a mesh's epochs run 1 .. EPOCHS - 1; then its flags are zeroed and the
# count starts again, so that a flag and an epoch never lie 2^31 apart
EPOCHS = 1 << 31

_peers = set()


def enable_peer(name: str, dev: torch.device, peer: torch.device) -> None:
    """Lets card ``dev`` reach card ``peer``'s memory, or raises."""
    if (dev, peer) in _peers:
        return
    fn = build.load("ring_gather").tagan_ring_enable_peer
    fn.argtypes, fn.restype = [_I, _I], _I
    err = fn(dev.index, peer.index)
    if err != 0:
        raise RuntimeError(f"{name}: {dev} cannot reach {peer} (peer "
                           f"access, cudaError {err})")
    _peers.add((dev, peer))


class RingItem(NamedTuple):
    """One item of the ring: ``rank`` copies ``nbytes`` at ``offset`` of
    chunk ``chunk`` into its out, from its shard (``hop`` 0) or from its
    left rank's out (hop ``hop`` - 1 of the ring), after the flag ``wait``
    of its left rank's card (None at hop 0) reached the epoch, and then
    releases its flag ``flag``."""
    rank: int
    hop: int
    tile: int
    chunk: int
    offset: int
    nbytes: int
    flag: int
    wait: Optional[int]


class RingSchedule(NamedTuple):
    """The work of one card's launch in one ring of ``g`` ranks: the
    ranks ``local`` (those on the card, in rank order), ``chunk_bytes`` a
    shard, ``tiles`` tiles of TILE_BYTES a chunk, ``n_items`` items; each
    card holds ``g * g * tiles`` flag words."""
    g: int
    local: Tuple[int, ...]
    chunk_bytes: int
    tiles: int
    n_items: int

    def item(self, i: int) -> RingItem:
        """Item ``i``, as ``ring_gather_kernel`` decodes it (its loop's
        head, ``csrc/ring_gather.cu``): hop-major, then rank, then tile."""
        g, T = self.g, self.tiles
        per_hop = len(self.local) * T
        h, rem = divmod(i, per_hop)
        r, t = self.local[rem // T], rem % T
        off = t * TILE_BYTES
        left = (r - 1) % g
        return RingItem(r, h, t, (r - h) % g, off,
                        min(TILE_BYTES, self.chunk_bytes - off),
                        (r * g + h) * T + t,
                        None if h == 0 else (left * g + h - 1) * T + t)


def ring_schedule(g: int, local: Sequence[int],
                  chunk_bytes: int) -> RingSchedule:
    """The schedule of one card's launch: ``local`` ranks of a ring of
    ``g``, ``chunk_bytes`` a shard (one tile, of 0 bytes, for an empty
    one)."""
    T = max(1, -(-chunk_bytes // TILE_BYTES))
    return RingSchedule(g, tuple(local), chunk_bytes, T, len(local) * g * T)


class _MeshRing:
    """What the rings of one mesh keep: their epoch count, their flag
    words on each card, the stream of the last ring on each card, and each
    axis's `_Layout`."""

    def __init__(self):
        self.epoch = 0
        self.words = {}
        self.streams = {}
        self.layouts = {}

    def follow(self, d: torch.device, handle: int) -> None:
        """Orders the ring about to go on card ``d``'s current stream (raw
        ``handle``) after the mesh's last ring there: if that went on
        another stream, the current one waits for it. A flag of a later
        ring would let an earlier one on, so two rings of the mesh must
        never run side by side."""
        last = self.streams.get(d)
        if last is not None and last[0] == handle:
            return
        cur = torch.cuda.current_stream(d)
        if last is not None:
            cur.wait_stream(last[1])
        self.streams[d] = (handle, cur)

    def take(self, cards, n_words: int):
        """The next epoch and the cards' flag words, at least ``n_words``
        each; new words are zeros, queued on the card's current stream."""
        self.epoch += 1
        if self.epoch == EPOCHS:
            self.epoch = 1
            for w in self.words.values():
                w.zero_()
        for d in cards:
            w = self.words.get(d)
            if w is None or w.numel() < n_words:
                self.words[d] = torch.zeros(n_words, dtype=torch.int32,
                                            device=d)
        return self.epoch, [self.words[d] for d in cards]

    def layout(self, mesh: Mesh, axis: str) -> "_Layout":
        lay = self.layouts.get(axis)
        if lay is None:
            lay = self.layouts[axis] = _Layout(mesh.ring(axis))
        return lay


class _Layout:
    """The ring over one axis: the ranks' devices, the cards in order of
    first rank, each card's ranks, and the kernel's parameter
    (`_RingPtrs`), made at the first ring and then reused: a launch
    copies it, so the next ring may change it."""

    def __init__(self, devs):
        self.devs = devs
        self.cards = list(dict.fromkeys(devs))
        self.locals = [[r for r, e in enumerate(devs) if e == d]
                       for d in self.cards]
        self.ptrs = None

    def params(self) -> "_RingPtrs":
        """The parameter with each rank's card (and, on one card, its
        ranks) in place."""
        if self.ptrs is None:
            g = len(self.devs)
            self.ptrs = _RingPtrs()
            self.ptrs.card[:g] = [self.cards.index(d) for d in self.devs]
            if len(self.cards) == 1:
                self.ptrs.local[:g] = self.locals[0]
        return self.ptrs


_rings = weakref.WeakKeyDictionary()


def _ring_of(mesh: Mesh) -> _MeshRing:
    ring = _rings.get(mesh)
    if ring is None:
        ring = _rings[mesh] = _MeshRing()
    return ring


class _RingPtrs(ctypes.Structure):
    """``RingPtrs`` of ``csrc/ring_gather.cu``, the kernel's parameter."""
    _fields_ = [("x", _P * MAX_RANKS), ("out", _P * MAX_RANKS),
                ("flags", _P * MAX_CARDS), ("card", ctypes.c_uint8 * MAX_RANKS),
                ("local", ctypes.c_uint8 * MAX_RANKS)]


class _RingGatherKernel(_CudaKernel):
    """B8, ``tagan_ring_all_gather``: the ring, one launch a card."""
    name = "ring_all_gather"
    source = "ring_gather"
    symbol = "tagan_ring_all_gather"
    argtypes = (_P, ctypes.c_longlong, _I, _I, _I, _U, _I, _I)

    def __init__(self):
        super().__init__()
        self._max_blocks = {}

    def max_blocks(self, dev: torch.device, sys: bool) -> int:
        """The largest cooperative grid of the kernel on ``dev``."""
        key = (dev, sys)
        if key not in self._max_blocks:
            fn = build.load(self.source).tagan_ring_gather_max_blocks
            fn.argtypes = [_I, ctypes.POINTER(ctypes.c_int)]
            fn.restype = _I
            n = ctypes.c_int(0)
            with torch.cuda.device(dev):
                err = fn(int(sys), ctypes.byref(n))
            if err != 0 or n.value < 1:
                raise RuntimeError(f"{self.name}: no cooperative launch on "
                                   f"{dev} (cudaError {err})")
            self._max_blocks[key] = n.value
        return self._max_blocks[key]

    def __call__(self, shards: Sequence[torch.Tensor], ring: _MeshRing,
                 lay: _Layout) -> List[torch.Tensor]:
        g, x0, cards = len(shards), shards[0], lay.cards
        if g > MAX_RANKS or len(cards) > MAX_CARDS:
            raise ValueError(f"{self.name}: {g} ranks on {len(cards)} cards, "
                             f"past the kernel's {MAX_RANKS} and {MAX_CARDS}")
        if not all(x.is_contiguous() for x in shards):
            raise ValueError(f"{self.name}: shards must be contiguous")
        sys = len(cards) > 1
        streams = [torch._C._cuda_getCurrentRawStream(d.index)
                   for d in cards]
        for d, st in zip(cards, streams):
            ring.follow(d, st)
        cb = x0.numel() * x0.element_size()
        scheds = [ring_schedule(g, local, cb) for local in lay.locals]
        T = scheds[0].tiles
        # before the cards' streams wait on each other: new flag words are
        # zeroed on their card's stream, and the other cards read them
        epoch, words = ring.take(cards, g * g * T)
        if sys:
            for r, d in enumerate(lay.devs):
                enable_peer(self.name, d, lay.devs[(r - 1) % g])
            _wait_all(cards)
        outs = _outs(x0, g, cards, lay.locals)
        ptrs = lay.params()
        ptrs.x[:g] = [x.data_ptr() for x in shards]
        ptrs.out[:g] = [o.data_ptr() for o in outs]
        ptrs.flags[:len(cards)] = [w.data_ptr() for w in words]
        fn = self._function()
        for d, sched, st in zip(cards, scheds, streams):
            n = len(sched.local)
            if sys:
                ptrs.local[:n] = sched.local
            args = (ctypes.byref(ptrs), cb, g, n, T, epoch,
                    min(self.max_blocks(d, sys), sched.n_items), int(sys),
                    st)
            # the card's current stream as a raw handle, without a Stream
            # object, and its device set only if it is not the current one
            if d.index == torch.cuda.current_device():
                err = fn(*args)
            else:
                with torch.cuda.device(d):
                    err = fn(*args)
            if err != 0:
                raise RuntimeError(f"{self.name}: CUDA launch failed with "
                                   f"cudaError {err}")
            self.launches += 1
        if sys:
            _wait_all(cards)
        return outs


def _wait_all(cards) -> None:
    """Each card's current stream waits for the work queued so far on
    every other card's current stream."""
    evs = [record(torch.cuda.current_stream(d)) for d in cards]
    for d in cards:
        st = torch.cuda.current_stream(d)
        for e, ev in zip(cards, evs):
            if e != d:
                st.wait_event(ev)


def _outs(x0: torch.Tensor, g: int, cards, locals_) -> List[torch.Tensor]:
    """Each rank's out ``[g * chunk, ...]``: on each card one allocation,
    a slab of rows a rank, each slab padded to 16 bytes, so that every
    out starts on the 16-byte grid and the hops' copies move in bulk."""
    rest = tuple(x0.shape[1:])
    n = g * x0.shape[0]
    align = 16 // math.gcd(x0.element_size() * math.prod(rest), 16)
    rows = -(-n // align) * align
    outs = [None] * g
    for d, local in zip(cards, locals_):
        slab = torch.empty((len(local), rows) + rest, dtype=x0.dtype,
                           device=d)
        for r, out in zip(local, (slab if rows == n else slab[:, :n])
                          .unbind(0)):
            outs[r] = out
    return outs


class _RingCopyKernel(_CudaKernel):
    """``tagan_ring_copy``: dst <- src, on a stream of src's card; the
    ring flash's chunk mover."""
    name = "ring_copy"
    source = "ring_gather"
    symbol = "tagan_ring_copy"
    argtypes = (_P, _P, ctypes.c_longlong)

    def __call__(self, dst: torch.Tensor, src: torch.Tensor,
                 stream: torch.cuda.Stream) -> None:
        dev = self._device_of(self.name, src)
        if dst.device.type != "cuda":
            raise ValueError(f"{self.name}: dst on {dst.device}")
        if dst.dtype != src.dtype or dst.shape != src.shape:
            raise ValueError(f"{self.name}: dst {dst.dtype} "
                             f"{tuple(dst.shape)} != src {src.dtype} "
                             f"{tuple(src.shape)}")
        if not (dst.is_contiguous() and src.is_contiguous()):
            raise ValueError(f"{self.name}: tensors must be contiguous")
        if dst.device != dev:
            enable_peer(self.name, dev, dst.device)
        self._launch(dev, dst.data_ptr(), src.data_ptr(),
                     src.numel() * src.element_size(), stream=stream)


ring_gather_kernel = _RingGatherKernel()
ring_copy_kernel = _RingCopyKernel()
KERNELS = (ring_gather_kernel, ring_copy_kernel)


def fork(streams) -> None:
    """Each stream waits for the work queued so far on its device's
    current stream (the inputs)."""
    for st in streams:
        st.wait_stream(torch.cuda.current_stream(st.device))


def join(streams) -> None:
    """Each device's current stream waits for the streams on it."""
    for st in streams:
        torch.cuda.current_stream(st.device).wait_stream(st)


def record(stream) -> torch.cuda.Event:
    ev = torch.cuda.Event()
    ev.record(stream)
    return ev


def ring_all_gather_plain(shards: Sequence[torch.Tensor]
                          ) -> List[torch.Tensor]:
    """What the ring gives each rank: the shards concatenated in rank
    order, on that rank's device."""
    return [torch.cat([s.to(x.device) for s in shards]) for x in shards]


def _check_shards(name: str, shards, devs) -> str:
    """The shards' device type, after checking that there is one per rank
    on its device, all of one shape and dtype."""
    if len(shards) != len(devs):
        raise ValueError(f"{name}: {len(shards)} shards for a ring of "
                         f"{len(devs)} ranks")
    x0 = shards[0]
    for r, (x, d) in enumerate(zip(shards, devs)):
        if x.device != d:
            raise ValueError(f"{name}: shard {r} on {x.device}, its rank "
                             f"on {d}")
        if x.shape != x0.shape or x.dtype != x0.dtype:
            raise ValueError(f"{name}: shard {r} is {x.dtype} "
                             f"{tuple(x.shape)}, shard 0 {x0.dtype} "
                             f"{tuple(x0.shape)}")
    return x0.device.type


def ring_all_gather(shards: Sequence[torch.Tensor], mesh: Mesh,
                    axis: str = GRAPH_AXIS) -> List[torch.Tensor]:
    """All-gather the leading axis of the ranks' shards over ``axis``:
    shard r (``[chunk, ...]``) on rank r's device -> a list of each
    rank's ``[g * chunk, ...]``."""
    ring = _ring_of(mesh)
    lay = ring.layout(mesh, axis)
    if _check_shards(ring_gather_kernel.name, shards, lay.devs) != "cuda":
        return ring_all_gather_plain(shards)
    return ring_gather_kernel(shards, ring, lay)


def ring_all_gather_sharded(mesh: Mesh, x: torch.Tensor,
                            axis: str = GRAPH_AXIS) -> List[torch.Tensor]:
    """``x`` [N, ...] sharded by rows over ``axis`` (`shard_rows`), then
    gathered back on every rank by the ring: a list of each rank's
    ``[N, ...]``."""
    return ring_all_gather(shard_rows(mesh, x, axis), mesh, axis)
