"""Ring all-gather of row shards over a mesh axis (B8).

Counterpart of ``tagan_tpu/ops/pallas/ring_gather.py``: every rank of the
axis holds a row shard ``[chunk, ...]`` and ends with all of them,
``[g * chunk, ...]`` in rank order, in the shard's dtype.

The TPU kernel ``_ring_kernel`` runs the ring inside one Pallas call per
chip, with remote DMAs, semaphores and three communication slots. Here
the ranks are those of a `Mesh` (``tagan_torch.dist.mesh``), possibly
virtual ranks of one card, each with a stream of its own; every move is
one launch of the copy kernel ``csrc/ring_gather.cu`` on the moving
rank's stream. The hops are the TPU kernel's, but a chunk is received
straight into the neighbour's output rows, which hold every chunk anyway
and are each written once, so no slot is reused and none is needed:

- the rank's own chunk goes to ``out[my * chunk]``;
- at hop s (0 <= s < g - 1) the rank sends its rows of chunk
  (my - s) mod g, which arrived from the left at hop s - 1 (its own at
  hop 0), into the same rows of the right neighbour's out.

CUDA events order the ranks' streams: a rank sends at hop s only after
the left neighbour's hop s - 1 send, which wrote the rows it sends, has
finished, and its stream waits for the left neighbour's last send before
the ring joins. The ring forks from the current stream of each rank's
device and joins back into it, so callers see an ordinary stream-ordered
result. Between ranks on two cards the send stores through a peer
pointer, after peer access is enabled; a pair of cards without peer
access raises.

CPU shards take the plain version, the rank-order concatenation; CUDA
shards launch the kernel or raise. `ring_all_gather_sharded` first cuts
x into the ranks' shards (`shard_rows`, plain torch copies: the TPU
wrapper's sharded input); the gather itself moves rows only with the
copy kernel.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence

import torch

from ..dist.mesh import GRAPH_AXIS, Mesh, shard_rows
from . import build
from .flash_geometric import _P, _CudaKernel


class _RingCopyKernel(_CudaKernel):
    """B8, ``tagan_ring_copy``: dst <- src, on a stream of src's card."""
    name = "ring_all_gather"
    source = "ring_gather"
    symbol = "tagan_ring_copy"
    argtypes = (_P, _P, ctypes.c_longlong)

    def __init__(self):
        super().__init__()
        self._peers = set()

    def _enable_peer(self, src: torch.device, dst: torch.device) -> None:
        if (src, dst) in self._peers:
            return
        fn = build.load(self.source).tagan_ring_enable_peer
        fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_int
        err = fn(src.index, dst.index)
        if err != 0:
            raise RuntimeError(f"{self.name}: {src} cannot store into {dst} "
                               f"(peer access, cudaError {err})")
        self._peers.add((src, dst))

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
            self._enable_peer(dev, dst.device)
        self._launch(dev, dst.data_ptr(), src.data_ptr(),
                     src.numel() * src.element_size(), stream=stream)


ring_copy_kernel = _RingCopyKernel()
KERNELS = (ring_copy_kernel,)


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
    devs = mesh.ring(axis)
    if _check_shards(ring_copy_kernel.name, shards, devs) != "cuda":
        return ring_all_gather_plain(shards)
    streams = mesh.ring_streams(axis)[0]
    g, chunk = len(shards), shards[0].shape[0]
    outs = [torch.empty((g * chunk,) + tuple(x.shape[1:]), dtype=x.dtype,
                        device=x.device) for x in shards]

    def rows(r, c):
        return outs[r][c * chunk:(c + 1) * chunk]

    fork(streams)
    for r, x in enumerate(shards):
        ring_copy_kernel(rows(r, r), x, streams[r])
    sent = [[None] * g for _ in range(g)]       # sent[rank][hop]
    for s in range(g - 1):
        for r in range(g):
            if s >= 1:      # chunk (r - s) arrived from the left at s - 1
                streams[r].wait_event(sent[(r - 1) % g][s - 1])
            c = (r - s) % g
            ring_copy_kernel(rows((r + 1) % g, c), rows(r, c), streams[r])
            sent[r][s] = record(streams[r])
    if g > 1:               # the last chunk each rank received
        for r in range(g):
            streams[r].wait_event(sent[(r - 1) % g][g - 2])
    join(streams)
    return outs


def ring_all_gather_sharded(mesh: Mesh, x: torch.Tensor,
                            axis: str = GRAPH_AXIS) -> List[torch.Tensor]:
    """``x`` [N, ...] sharded by rows over ``axis`` (`shard_rows`), then
    gathered back on every rank by the ring: a list of each rank's
    ``[N, ...]``."""
    return ring_all_gather(shard_rows(mesh, x, axis), mesh, axis)
