"""A mesh of ranks and the row sharding over one of its axes.

Counterpart of ``tagan_tpu/dist/mesh.py`` (``DATA_AXIS``, ``GRAPH_AXIS``,
``make_mesh``). A JAX mesh is a grid of devices; here it is a grid of
ranks, each a ``torch.device``. A device may stand for several ranks:
ranks on one card are *virtual ranks*, the port's counterpart of the
JAX tests' ``--xla_force_host_platform_device_count=8``. Each rank on a
CUDA device owns two streams of its own, one for its compute and one
for the copies it sends, so that the ranks of one card run at the same
time; ranks on the CPU own none.

``shard_rows`` and ``gather_rows`` stand in for ``jax.device_put`` with a
``PartitionSpec`` over one axis and for the sharded result it gives
back: rows split in equal blocks, rank r's block on rank r's device.
The data-parallel helpers of the JAX module (``batch_sharding``,
``node_sharded``, ``shard_batch``, ``shard_params``) and ``dist/spmd.py``
are not ported yet.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ..core.module import resolve_device

DATA_AXIS = "data"
GRAPH_AXIS = "graph"


class Mesh:
    """A (data, graph) grid of ranks. ``devices`` is the object array of
    the ranks' ``torch.device``s, ``shape[axis]`` an axis's length."""

    def __init__(self, devices, axis_names=(DATA_AXIS, GRAPH_AXIS)):
        grid = np.asarray(devices, dtype=object)
        if grid.ndim != len(axis_names):
            raise ValueError(f"devices of shape {grid.shape} for axes "
                             f"{tuple(axis_names)}")
        self.devices = np.vectorize(_rank_device, otypes=[object])(grid)
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, grid.shape))
        cuda = self.devices.flat[0].type == "cuda"
        self.streams = np.vectorize(
            lambda d: torch.cuda.Stream(d) if cuda else None,
            otypes=[object])(self.devices)
        self.copy_streams = np.vectorize(
            lambda d: torch.cuda.Stream(d) if cuda else None,
            otypes=[object])(self.devices)

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def _line(self, axis: str, grid: np.ndarray) -> list:
        """The ranks along ``axis`` at index 0 of the other axes."""
        ax = self.axis_names.index(axis)
        idx = tuple(slice(None) if i == ax else 0
                    for i in range(grid.ndim))
        return list(grid[idx])

    def ring(self, axis: str = GRAPH_AXIS) -> List[torch.device]:
        """The devices of the ring over ``axis``, in rank order. The other
        axes hold replicas of the same computation; it runs once, on the
        ranks at their index 0."""
        return self._line(axis, self.devices)

    def ring_streams(self, axis: str = GRAPH_AXIS):
        """(compute streams, copy streams) of the ring's ranks; None on
        the CPU."""
        return (self._line(axis, self.streams),
                self._line(axis, self.copy_streams))


def _rank_device(d) -> torch.device:
    """The device of a rank; a bare "cuda" means the current card."""
    dev = resolve_device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(data: Optional[int] = None, graph: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """A (data, graph) mesh over ``devices``: by default the visible CUDA
    devices, one rank each. Repeat a device to give it several ranks."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devs = list(devices)
    n = len(devs)
    if data is None:
        assert n % graph == 0, f"{n} devices not divisible by graph={graph}"
        data = n // graph
    assert data * graph == n, f"mesh {data}x{graph} != {n} devices"
    grid = np.empty(n, dtype=object)
    grid[:] = devs
    return Mesh(grid.reshape(data, graph))


def shard_rows(mesh: Mesh, x: torch.Tensor, axis: str = GRAPH_AXIS,
               dim: int = 0) -> List[torch.Tensor]:
    """``x`` cut along ``dim`` into ``mesh.shape[axis]`` equal blocks,
    rank r's block contiguous on rank r's device of the ring."""
    devs = mesh.ring(axis)
    g = len(devs)
    if x.shape[dim] % g:
        raise ValueError(f"{x.shape[dim]} rows do not split over {g} ranks "
                         f"of axis {axis!r}")
    return [blk.to(d).contiguous()
            for blk, d in zip(torch.chunk(x, g, dim), devs)]


def gather_rows(shards: Sequence[torch.Tensor], dim: int = 0,
                device=None) -> torch.Tensor:
    """The shards concatenated along ``dim`` in rank order, on ``device``
    (the first shard's by default)."""
    dev = shards[0].device if device is None else torch.device(device)
    return torch.cat([s.to(dev) for s in shards], dim)
