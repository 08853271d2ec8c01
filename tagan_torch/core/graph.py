"""Snapshot sequences in slot space.

Counterpart of ``tagan_tpu.core.graph`` (``SnapshotSequence``,
``build_sequence``, ``batch_sequences``, ``pad_dims_for``): T graph
snapshots over a shared node-ID space, packed host-side with numpy into
static-shape arrays. The union of node IDs is sorted and assigned slots
``0..n_unique-1``; arrays are padded to ``max_nodes``/``max_edges``/
``max_time`` with validity masks. The port returns CPU tensors; the
model moves them to its device.

Only the numpy packing path is ported (the JAX package's C++ packer is
an accelerator of the same semantics), and only the base fields: the
ring and hybrid plans belong to backends the port does not have yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

MAX_ID = 2 ** 31   # ids and slots are stored as int32


@dataclasses.dataclass(frozen=True)
class SnapshotSequence:
    """One sequence (or a stack of sequences with a leading batch axis).

    x          f32[T, N, F_node]   node features per snapshot
    node_mask  bool[T, N]          node active at step t
    adj        bool[T, N, N]       directed adjacency, no self loops
                                   ([T, 1, 1] placeholder when built
                                   with dense_adj=False)
    edge_src   i32[T, E]           COO source slot (0 where padded)
    edge_dst   i32[T, E]           COO destination slot
    edge_mask  bool[T, E]          edge validity
    edge_attr  f32[T, E, F_edge]   edge features (F_edge may be 0)
    times      f32[T]              timestamp per snapshot
    time_mask  bool[T]             snapshot validity
    node_ids   i32[N]              global node ID per slot (-1 padding)
    """
    x: torch.Tensor
    node_mask: torch.Tensor
    adj: torch.Tensor
    edge_src: torch.Tensor
    edge_dst: torch.Tensor
    edge_mask: torch.Tensor
    edge_attr: torch.Tensor
    times: torch.Tensor
    time_mask: torch.Tensor
    node_ids: torch.Tensor

    @property
    def num_steps(self) -> int:
        return self.x.shape[-3]

    @property
    def max_nodes(self) -> int:
        return self.x.shape[-2]

    @property
    def node_feature_dim(self) -> int:
        return self.x.shape[-1]

    @property
    def edge_feature_dim(self) -> int:
        return self.edge_attr.shape[-1]

    @property
    def has_dense_adj(self) -> bool:
        """False when built with dense_adj=False."""
        return self.adj.shape[-1] == self.max_nodes

    @property
    def is_batched(self) -> bool:
        return self.x.dim() == 4

    def attention_mask(self, add_self_loops: bool = True) -> torch.Tensor:
        """Dense attention mask per snapshot: adjacency (+ self loops),
        restricted to active x active slots."""
        if not self.has_dense_adj:
            raise ValueError(
                "sequence was built with dense_adj=False; the dense "
                "attention path needs the adjacency - use the 'flash' "
                "spatial backend, or rebuild with dense_adj=True")
        m = self.adj
        if add_self_loops:
            eye = torch.eye(self.max_nodes, dtype=torch.bool,
                            device=m.device)
            m = m | eye
        pair = self.node_mask[..., :, None] & self.node_mask[..., None, :]
        return m & pair

    def map(self, fn) -> "SnapshotSequence":
        """The sequence with ``fn`` applied to every array."""
        return SnapshotSequence(**{f.name: fn(getattr(self, f.name))
                                   for f in dataclasses.fields(self)})

    def to(self, device) -> "SnapshotSequence":
        return self.map(lambda t: t.to(device))


SnapshotLike = Union[Dict[str, Any], Tuple]


def _unpack_snapshot(snap: SnapshotLike):
    """Accept dict snapshots {'x', 'edge_index', 'edge_attr',
    'node_ids'[, 'timestep']} or tuples (x, edge_index, edge_attr,
    node_ids[, timestep])."""
    if isinstance(snap, dict):
        x = snap["x"]
        edge_index = snap["edge_index"]
        edge_attr = snap.get("edge_attr", None)
        node_ids = snap["node_ids"]
        t = snap.get("timestep", None)
    elif isinstance(snap, (tuple, list)):
        if len(snap) < 4:
            raise ValueError(
                f"snapshot tuple needs >=4 elements, got {len(snap)}")
        x, edge_index, edge_attr, node_ids = snap[:4]
        t = snap[4] if len(snap) > 4 else None
    else:
        raise ValueError(f"unsupported snapshot type {type(snap)}")
    x = np.asarray(x, dtype=np.float32)
    edge_index = np.asarray(edge_index, dtype=np.int64)
    if edge_index.size == 0:
        edge_index = edge_index.reshape(2, 0)
    if edge_attr is not None:
        edge_attr = np.asarray(edge_attr, dtype=np.float32)
    node_ids = np.asarray(node_ids, dtype=np.int64).reshape(-1)
    if node_ids.size and (node_ids.max() >= MAX_ID
                          or node_ids.min() < -MAX_ID):
        raise ValueError("node ids must fit in int32 (|id| < 2**31)")
    return x, edge_index, edge_attr, node_ids, t


def build_sequence(
    snapshots: Sequence[SnapshotLike],
    max_nodes: Optional[int] = None,
    max_edges: Optional[int] = None,
    max_time: Optional[int] = None,
    edge_feature_dim: Optional[int] = None,
    dense_adj: bool = True,
) -> SnapshotSequence:
    """Pack a ragged snapshot list into a static-shape
    `SnapshotSequence` of CPU tensors. ``dense_adj=False`` stores a
    [T, 1, 1] placeholder instead of the [T, N, N] adjacency (the flash
    backend rebuilds its masks from the edge lists)."""
    unpacked = [_unpack_snapshot(s) for s in snapshots]
    T = len(unpacked)

    all_ids = np.unique(np.concatenate(
        [ids for (_, _, _, ids, _) in unpacked] or [np.zeros(0, np.int64)]))
    n_unique = len(all_ids)

    N = max_nodes or n_unique
    if n_unique > N:
        raise ValueError(f"sequence has {n_unique} unique nodes > max_nodes={N}")
    Emax = max_edges or max((u[1].shape[1] for u in unpacked), default=1) or 1
    Tmax = max_time or T
    if T > Tmax:
        raise ValueError(f"sequence has {T} steps > max_time={Tmax}")
    F_node = unpacked[0][0].shape[1]
    if edge_feature_dim is None:
        edge_feature_dim = 0
        for (_, _, ea, _, _) in unpacked:
            if ea is not None and ea.ndim == 2:
                edge_feature_dim = ea.shape[1]
                break
    Fe = edge_feature_dim

    x = np.zeros((Tmax, N, F_node), np.float32)
    node_mask = np.zeros((Tmax, N), bool)
    adj = np.zeros((Tmax, N if dense_adj else 1,
                    N if dense_adj else 1), bool)
    edge_src = np.zeros((Tmax, Emax), np.int32)
    edge_dst = np.zeros((Tmax, Emax), np.int32)
    edge_mask = np.zeros((Tmax, Emax), bool)
    edge_attr = np.zeros((Tmax, Emax, Fe), np.float32)
    times = np.zeros((Tmax,), np.float32)
    time_mask = np.zeros((Tmax,), bool)
    node_ids_arr = np.full((N,), -1, np.int32)
    node_ids_arr[:n_unique] = all_ids.astype(np.int32)

    for t, (xt, ei, ea, ids, tv) in enumerate(unpacked):
        slots = np.searchsorted(all_ids, ids).astype(np.int32)
        x[t, slots] = xt[: len(ids)]
        node_mask[t, slots] = True
        E = ei.shape[1]
        if E > Emax:
            raise ValueError(f"snapshot {t} has {E} edges > max_edges={Emax}")
        if E > 0:
            # edge endpoints index rows of the snapshot's x
            src = slots[ei[0]]
            dst = slots[ei[1]]
            edge_src[t, :E] = src
            edge_dst[t, :E] = dst
            edge_mask[t, :E] = True
            if dense_adj:
                adj[t, src, dst] = True
            if ea is not None and Fe > 0:
                edge_attr[t, :E, :] = ea[:E, :Fe]
        times[t] = float(tv) if tv is not None else float(t)
        time_mask[t] = True

    return SnapshotSequence(
        x=torch.from_numpy(x), node_mask=torch.from_numpy(node_mask),
        adj=torch.from_numpy(adj), edge_src=torch.from_numpy(edge_src),
        edge_dst=torch.from_numpy(edge_dst),
        edge_mask=torch.from_numpy(edge_mask),
        edge_attr=torch.from_numpy(edge_attr),
        times=torch.from_numpy(times), time_mask=torch.from_numpy(time_mask),
        node_ids=torch.from_numpy(node_ids_arr))


def batch_sequences(seqs: Sequence[SnapshotSequence]) -> SnapshotSequence:
    """Stack same-shape sequences along a new leading batch axis."""
    return SnapshotSequence(**{
        f.name: torch.stack([getattr(s, f.name) for s in seqs])
        for f in dataclasses.fields(SnapshotSequence)})


def pad_dims_for(
    dataset: Sequence[Sequence[SnapshotLike]],
) -> Tuple[int, int, int, int]:
    """(max_time, max_nodes, max_edges, edge_feature_dim) over a dataset
    of ragged sequences."""
    Tm, Nm, Em, Fe = 1, 1, 1, 0
    for snapshots in dataset:
        Tm = max(Tm, len(snapshots))
        ids = set()
        for s in snapshots:
            _, ei, ea, nid, _ = _unpack_snapshot(s)
            ids.update(nid.tolist())
            Em = max(Em, ei.shape[1])
            if ea is not None and ea.ndim == 2:
                Fe = max(Fe, ea.shape[1])
        Nm = max(Nm, len(ids))
    return Tm, Nm, Em, Fe
