"""Snapshot sequences in slot space.

Counterpart of ``tagan_tpu.core.graph`` (``SnapshotSequence``,
``build_sequence``, ``locality_order``, ``batch_sequences``,
``pad_dims_for``, ``CSRSnapshots``/``coo_to_csr``): T graph snapshots
over a shared node-ID space, packed host-side into static-shape arrays.
The union of node IDs is sorted and assigned slots ``0..n_unique-1``
(or, with ``reorder="rcm"``, slots in reverse Cuthill-McKee order of the
union graph); arrays are padded to ``max_nodes``/``max_edges``/
``max_time`` with validity masks. The port returns CPU tensors; the
model moves them to its device.

The packing runs in numpy; the reverse Cuthill-McKee order runs in C++
(`tagan_torch.native`, built with g++ at first use of ``reorder="rcm"``).
Besides the base fields, a sequence carries the hybrid backend's band + residual plan
(`SnapshotSequence.with_hybrid_plan`, `attach_hybrid_plans`); the ring
plan belongs to a backend the port does not have yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

MAX_ID = 2 ** 31   # ids and slots are stored as int32
# the hybrid plan's square tile: the CUDA kernels' (ops.flash_geometric.
# BLOCK_M, BLOCK_N); one uint64 word holds a tile row of the bit store
HYBRID_TILE = 64


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

    The hybrid plan (``None`` until `with_hybrid_plan`), per snapshot, at
    64 x 64 tiles (`HYBRID_TILE`):

    hyb_mask_blocks  the band's occupied-block store: bits
                     i64[T, S, 64] (bit c of word r is pair (r, c) of
                     the tile) or int8[T, S, 64, 64]
    hyb_plan         (jlist, jcount, jslot) i32 [T, n_i, Wj], [T, n_i],
                     [T, n_i, Wj]: the row tiles' walks and the store
                     slot of each step
    hyb_plan_t       (ilist, icount, islot) i32 [T, n_i, Wi], [T, n_i],
                     [T, n_i, Wi]: the transposed walk (each key tile's
                     occupied row tiles, and the slot of the same store
                     tile), which the backward's dk/dv kernel walks;
                     ``None`` unless planned with ``transposed=True``
    hyb_res          (eq, ek, em) [T, Er]: the residual edges as COO
    hyb_res_eid      i32[T, Er]: each residual slot's edge id (-1 padding)
    hyb_band_slot    i32[T, E]: each band edge's store slot (-1 residual
                     or invalid)
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
    hyb_mask_blocks: Optional[torch.Tensor] = None
    hyb_plan: Optional[Tuple[torch.Tensor, ...]] = None
    hyb_plan_t: Optional[Tuple[torch.Tensor, ...]] = None
    hyb_res: Optional[Tuple[torch.Tensor, ...]] = None
    hyb_res_eid: Optional[torch.Tensor] = None
    hyb_band_slot: Optional[torch.Tensor] = None

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
        """The sequence with ``fn`` applied to every array (to each
        array of a tuple field; ``None`` fields stay ``None``)."""
        return SnapshotSequence(**{f.name: _map_field(fn, getattr(self,
                                                                  f.name))
                                   for f in dataclasses.fields(self)})

    def to(self, device) -> "SnapshotSequence":
        return self.map(lambda t: t.to(device))

    def with_hybrid_plan(self, band_width: Optional[int] = None,
                         pack: bool = True, band_quantile: float = 0.95,
                         pin: Optional[dict] = None,
                         transposed: bool = False) -> "SnapshotSequence":
        """Attach the band + residual split consumed by
        ``spatial_backend="hybrid"`` (the JAX package's
        ``with_hybrid_plan``, host-side numpy). Valid edges with
        |src - dst| <= ``band_width`` form the BAND: an occupied-block
        store of their 64 x 64 tiles with the self loops of active nodes,
        and the walks over it; the rest form the RESIDUAL, a COO list for
        the O(E) partial. ``band_width=None`` takes the ``band_quantile``
        quantile of |src - dst| over the valid edges.

        ``pack=True`` stores one uint64 word per tile row (512 bytes a
        tile), ``pack=False`` int8 tiles. ``transposed=True`` also builds
        the transposed walk (``hyb_plan_t``) that training's backward
        walks; serving does without it. ``pin`` (from `hybrid_plan_dims`,
        merged with `merge_hybrid_dims`) fixes the form, the padded sizes
        S, Wj and Er, and with a ``Wi`` the transposed walk and its width,
        so that sequences stack; a plan that exceeds it raises
        ValueError."""
        if self.is_batched:
            raise ValueError("with_hybrid_plan takes one sequence, not a "
                             "batch")
        layout = _hybrid_layout(self, band_width, band_quantile)
        if pin is None:
            pin = dict(pack=pack, **_plan_dims(layout, transposed))
        return _attach_plan(self, layout, pin)


def _map_field(fn, value):
    if value is None:
        return None
    if isinstance(value, tuple):
        return tuple(fn(t) for t in value)
    return fn(value)


# ---------------------------------------------------------------------------
# The hybrid plan (the JAX package's with_hybrid_plan, _rows_plan,
# hybrid_plan_dims, merge_hybrid_dims, attach_hybrid_plans), numpy
# ---------------------------------------------------------------------------

def _hybrid_layout(seq: SnapshotSequence, band_width, band_quantile):
    """What a plan is built from, before its padded sizes are known:
    (src, dst, node_mask, band bool[T, E], residual bool[T, E], the band
    tiles' occupancy bool[n_i, n_i] per snapshot)."""
    src, dst, em, nm = (np.asarray(t) for t in (
        seq.edge_src, seq.edge_dst, seq.edge_mask, seq.node_mask))
    band_sel, res_sel = _hybrid_split(src, dst, em, band_width,
                                      band_quantile)
    occs = _band_occupancy(src, dst, band_sel, nm, seq.max_nodes)
    return src, dst, nm, band_sel, res_sel, occs


def _hybrid_split(src, dst, em, band_width, band_quantile):
    """(band, residual) bool[T, E]: valid edges within ``band_width``
    slots of the diagonal, and the other valid ones."""
    gap = np.abs(src.astype(np.int64) - dst.astype(np.int64))
    if band_width is None:
        valid = gap[em]
        band_width = int(np.quantile(valid, band_quantile)) \
            if valid.size else HYBRID_TILE
    band = em & (gap <= band_width)
    return band, em & ~band


def _band_occupancy(src, dst, band_sel, nm, n):
    """Per snapshot, bool[n_i, n_i]: the tiles holding a band edge or
    the self loop of an active node."""
    n_t = -(-n // HYBRID_TILE)
    occs = []
    for t in range(src.shape[0]):
        occ = np.zeros((n_t, n_t), bool)
        b = band_sel[t]
        occ[src[t][b] // HYBRID_TILE, dst[t][b] // HYBRID_TILE] = True
        d = np.nonzero(nm[t])[0] // HYBRID_TILE
        occ[d, d] = True
        occs.append(occ)
    return occs


def _plan_dims(layout, transposed: bool = False) -> Dict[str, int]:
    """The padded sizes a plan needs: store slots S, walk width Wj,
    residual slots Er and, with ``transposed``, the transposed walk's
    width Wi (each at least 1)."""
    occs, res_sel = layout[5], layout[4]
    dims = dict(S=max(max(int(o.sum()) for o in occs), 1),
                Wj=max(max(int(o.sum(1).max()) for o in occs), 1),
                Er=max(int(res_sel.sum(1).max()), 1))
    if transposed:
        dims["Wi"] = max(max(int(o.sum(0).max()) for o in occs), 1)
    return dims


def _rows_plan(occ: np.ndarray, W: int):
    """(list i32[R, W], count i32[R]) of an occupancy matrix: each row's
    occupied columns in order, padded by repeating the last (zeros on an
    empty row), and their count (the JAX package's ``_rows_plan``; W is
    at least the largest count)."""
    R = occ.shape[0]
    r, c = np.nonzero(occ)            # row-major: columns ascending per row
    cnt = np.bincount(r, minlength=R).astype(np.int32)
    lst = np.zeros((R, W), np.int32)
    lst[r, np.arange(r.size) - (np.cumsum(cnt) - cnt)[r]] = c
    last = lst[np.arange(R), np.maximum(cnt - 1, 0)]
    return np.where(np.arange(W) < cnt[:, None], lst, last[:, None]), cnt


def _attach_plan(seq: SnapshotSequence, layout, pin: dict
                 ) -> SnapshotSequence:
    """``seq`` with its plan built from ``layout`` at the form and padded
    sizes of ``pin``, the transposed walk too where it has a ``Wi``
    (raises ValueError if the plan needs more)."""
    dims = _plan_dims(layout, "Wi" in pin)
    over = {k: (dims[k], pin[k]) for k in dims if dims[k] > pin[k]}
    if over:
        raise ValueError(f"hybrid plan exceeds its pin: {over}")
    return dataclasses.replace(seq, **_build_hybrid(
        *layout, pin["pack"], pin["S"], pin["Wj"], pin["Er"],
        pin.get("Wi")))


def _build_hybrid(src, dst, nm, band_sel, res_sel, occs, pack, S, Wj, Er,
                  Wi=None) -> Dict[str, Any]:
    """The plan's arrays for `with_hybrid_plan`, padded to the given
    sizes, as CPU tensors; the transposed walk at width ``Wi`` unless it
    is None. The bit store's words are set straight from the edges: the
    work grows with E, not with the S * 64 * 64 pairs."""
    T, E = src.shape
    tile = HYBRID_TILE
    n_t = occs[0].shape[0]
    store = np.zeros((T, S * tile), np.uint64) if pack \
        else np.zeros((T, S * tile * tile), np.int8)
    jl = np.zeros((T, n_t, Wj), np.int32)
    jc = np.zeros((T, n_t), np.int32)
    js = np.zeros((T, n_t, Wj), np.int32)
    il = np.zeros((T, n_t, Wi or 1), np.int32)
    ic = np.zeros((T, n_t), np.int32)
    isl = np.zeros((T, n_t, Wi or 1), np.int32)
    req = np.zeros((T, Er), np.int32)
    rek = np.zeros((T, Er), np.int32)
    rem = np.zeros((T, Er), bool)
    reid = np.full((T, Er), -1, np.int32)
    band_slot = np.full((T, E), -1, np.int32)
    for t in range(T):
        occ = occs[t]
        slot_flat = np.cumsum(occ.reshape(-1)).astype(np.int64) - 1
        jl[t], jc[t] = _rows_plan(occ, Wj)
        js[t] = np.clip(slot_flat[np.arange(n_t)[:, None] * n_t + jl[t]],
                        0, S - 1)
        if Wi is not None:
            # key tile j's occupied row tiles, and the slot of the same
            # (row tile, key tile) store tile
            il[t], ic[t] = _rows_plan(occ.T, Wi)
            isl[t] = np.clip(
                slot_flat[il[t] * n_t + np.arange(n_t)[:, None]], 0, S - 1)
        b = np.nonzero(band_sel[t])[0]
        d = np.nonzero(nm[t])[0]
        rows = np.concatenate([src[t][b], d]).astype(np.int64)
        cols = np.concatenate([dst[t][b], d]).astype(np.int64)
        slot_e = slot_flat[(rows // tile) * n_t + cols // tile]
        # self loops carry no edge, so no bias slot
        band_slot[t, b] = slot_e[:b.size]
        word = slot_e * tile + rows % tile
        if pack:
            # bit c of the word of tile row r is pair (r, c)
            np.bitwise_or.at(store[t], word, np.left_shift(
                np.uint64(1), (cols % tile).astype(np.uint64)))
        else:
            store[t, word * tile + cols % tile] = 1
        r = np.nonzero(res_sel[t])[0]
        req[t, :r.size] = src[t][r]
        rek[t, :r.size] = dst[t][r]
        rem[t, :r.size] = True
        reid[t, :r.size] = r
    store = store.view(np.int64).reshape(T, S, tile) if pack \
        else store.reshape(T, S, tile, tile)
    t_ = torch.from_numpy
    return dict(
        hyb_mask_blocks=t_(store), hyb_plan=(t_(jl), t_(jc), t_(js)),
        hyb_plan_t=None if Wi is None else (t_(il), t_(ic), t_(isl)),
        hyb_res=(t_(req), t_(rek), t_(rem)),
        hyb_res_eid=t_(reid), hyb_band_slot=t_(band_slot))


def hybrid_plan_dims(seq: SnapshotSequence) -> dict:
    """A hybrid plan's store form and padded sizes as a ``pin`` dict
    (`SnapshotSequence.with_hybrid_plan`), with ``Wi`` where the plan has
    the transposed walk."""
    if seq.hyb_mask_blocks is None:
        raise ValueError("sequence has no hybrid plan")
    pack = seq.hyb_mask_blocks.dtype == torch.int64
    lead = seq.hyb_plan[1].dim() - 1
    dims = dict(pack=bool(pack), S=int(seq.hyb_mask_blocks.shape[lead]),
                Wj=int(seq.hyb_plan[0].shape[-1]),
                Er=int(seq.hyb_res[0].shape[-1]))
    if seq.hyb_plan_t is not None:
        dims["Wi"] = int(seq.hyb_plan_t[0].shape[-1])
    return dims


def merge_hybrid_dims(dims: Sequence[dict]) -> dict:
    """Elementwise max of `hybrid_plan_dims` dicts of one store form,
    all with the transposed walk's ``Wi`` or all without it."""
    if len({d["pack"] for d in dims}) > 1:
        raise ValueError("bit and int8 stores cannot merge")
    if len({"Wi" in d for d in dims}) > 1:
        raise ValueError("plans with and without the transposed walk "
                         "(Wi) cannot merge")
    keys = ("S", "Wj", "Er") + (("Wi",) if "Wi" in dims[0] else ())
    return dict(pack=dims[0]["pack"],
                **{k: max(d[k] for d in dims) for k in keys})


def attach_hybrid_plans(seqs: Sequence[SnapshotSequence],
                        pin: Optional[dict] = None, pack: bool = True,
                        band_width: Optional[int] = None,
                        band_quantile: float = 0.95,
                        transposed: bool = False
                        ) -> Tuple[List[SnapshotSequence], dict]:
    """Hybrid plans for several sequences with shared padded sizes, so
    that they stack into one batch: (planned sequences, pin). Without a
    ``pin`` the sizes are the most any of them needs; each plan is built
    once, after the sizes are known. Arguments as in
    `SnapshotSequence.with_hybrid_plan` (``transposed``: the transposed
    walk too, for training; a ``pin`` decides by its ``Wi``)."""
    layouts = [_hybrid_layout(s, band_width, band_quantile) for s in seqs]
    if pin is None:
        pin = merge_hybrid_dims([dict(pack=pack,
                                      **_plan_dims(l, transposed))
                                 for l in layouts])
    return [_attach_plan(s, l, pin) for s, l in zip(seqs, layouts)], pin


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


def _union_graph(unpacked):
    """(sorted unique IDs int64[n], src, dst int64[E]): every
    snapshot's edges in the index space of the union's IDs."""
    id_arr = np.unique(np.concatenate(
        [ids for (_, _, _, ids, _) in unpacked] or [np.zeros(0, np.int64)]))
    srcs = [ids[ei[0]] for (_, ei, _, ids, _) in unpacked if ei.size]
    dsts = [ids[ei[1]] for (_, ei, _, ids, _) in unpacked if ei.size]
    if not srcs:
        return id_arr, np.zeros(0, np.int64), np.zeros(0, np.int64)
    return (id_arr, np.searchsorted(id_arr, np.concatenate(srcs)),
            np.searchsorted(id_arr, np.concatenate(dsts)))


def _rcm_order_python(src: np.ndarray, dst: np.ndarray, n: int) -> list:
    """Reverse Cuthill-McKee order of an undirected [0, n) index graph,
    a BFS over Python sets: the plain version of ``rcm.cpp``'s
    ``tagan_rcm_order`` (the JAX package's fallback, line for line)."""
    import collections
    adjd = [set() for _ in range(n)]
    for a, b in zip(src.tolist(), dst.tolist()):
        if a != b:
            adjd[a].add(b)
            adjd[b].add(a)
    deg = [len(s) for s in adjd]
    visited = [False] * n
    order = []
    for start in sorted(range(n), key=lambda i: (deg[i], i)):
        if visited[start]:
            continue
        visited[start] = True
        queue = collections.deque([start])
        while queue:
            u = queue.popleft()
            order.append(u)
            for w in sorted(adjd[u], key=lambda i: (deg[i], i)):
                if not visited[w]:
                    visited[w] = True
                    queue.append(w)
    return order[::-1]


def locality_order(unpacked) -> np.ndarray:
    """Reverse Cuthill-McKee order of the union graph's node IDs,
    int64[n_unique] (``unpacked``: `_unpack_snapshot`'s tuples).

    Slot assignment is semantically arbitrary (every slot-space op is
    permutation-equivariant), but it decides the block structure: RCM
    puts each node's neighbours in nearby slots, so the flash plans walk
    fewer occupied 64 x 64 tiles and the hybrid band holds more of the
    edges. The BFS runs in C++ (`tagan_torch.native`); `_rcm_order_python`
    is its plain version."""
    from .. import native
    id_arr, src, dst = _union_graph(unpacked)
    return id_arr[native.rcm_order_native(src, dst, len(id_arr))]


def _resolve_dims(unpacked, max_nodes, max_edges, max_time,
                  edge_feature_dim):
    """(N, Emax, Tmax, Fe, sorted unique IDs) of a sequence; raises
    ValueError past the given maxima."""
    all_ids = np.unique(np.concatenate(
        [ids for (_, _, _, ids, _) in unpacked] or [np.zeros(0, np.int64)]))
    n_unique = len(all_ids)
    N = max_nodes or n_unique
    if n_unique > N:
        raise ValueError(
            f"sequence has {n_unique} unique nodes > max_nodes={N}")
    Emax = max_edges or max((u[1].shape[1] for u in unpacked),
                            default=1) or 1
    T = len(unpacked)
    Tmax = max_time or T
    if T > Tmax:
        raise ValueError(f"sequence has {T} steps > max_time={Tmax}")
    if edge_feature_dim is None:
        edge_feature_dim = 0
        for (_, _, ea, _, _) in unpacked:
            if ea is not None and ea.ndim == 2:
                edge_feature_dim = ea.shape[1]
                break
    return N, Emax, Tmax, edge_feature_dim, all_ids


def _pack(unpacked, N, Emax, Tmax, Fe, all_ids, dense_adj):
    """The packed arrays in `_BASE_FIELDS` order."""
    n_unique = len(all_ids)
    F_node = unpacked[0][0].shape[1]
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
    return (x, node_mask, adj, edge_src, edge_dst, edge_mask, edge_attr,
            times, time_mask, node_ids_arr)


_BASE_FIELDS = ("x", "node_mask", "adj", "edge_src", "edge_dst",
                "edge_mask", "edge_attr", "times", "time_mask", "node_ids")


def build_sequence(
    snapshots: Sequence[SnapshotLike],
    max_nodes: Optional[int] = None,
    max_edges: Optional[int] = None,
    max_time: Optional[int] = None,
    edge_feature_dim: Optional[int] = None,
    dense_adj: bool = True,
    reorder: Optional[str] = None,
) -> SnapshotSequence:
    """Pack a ragged snapshot list into a static-shape
    `SnapshotSequence` of CPU tensors. ``dense_adj=False`` stores a
    [T, 1, 1] placeholder instead of the [T, N, N] adjacency (the flash
    and hybrid backends build their masks from the edge lists).

    ``reorder="rcm"`` assigns slots in reverse Cuthill-McKee order of
    the union graph (`locality_order`) instead of sorted-ID order: the
    IDs are ranked by that order, packed, and ``node_ids`` gets the
    original IDs back. The outputs are the same up to the permutation of
    slots; the flash and hybrid plans walk fewer tiles on graphs with
    locality."""
    unpacked = [_unpack_snapshot(s) for s in snapshots]
    order = None
    if reorder is not None:
        if reorder != "rcm":
            raise ValueError(f"unknown reorder {reorder!r} (use 'rcm')")
        order = locality_order(unpacked)
        # rank of each ID in the order: the packer's sorted-ID slots are
        # then the RCM order
        by_id = np.argsort(order, kind="stable")
        sorted_ids = order[by_id]
        unpacked = [(xt, ei, ea, by_id[np.searchsorted(sorted_ids, ids)], tv)
                    for (xt, ei, ea, ids, tv) in unpacked]
    N, Emax, Tmax, Fe, all_ids = _resolve_dims(
        unpacked, max_nodes, max_edges, max_time, edge_feature_dim)
    fields = dict(zip(_BASE_FIELDS, _pack(unpacked, N, Emax, Tmax, Fe,
                                          all_ids, dense_adj)))
    if order is not None:
        ids = fields["node_ids"]
        fields["node_ids"] = np.where(
            ids >= 0, order[np.clip(ids, 0, len(order) - 1)],
            -1).astype(np.int32)
    return SnapshotSequence(**{k: torch.from_numpy(v)
                               for k, v in fields.items()})


def batch_sequences(seqs: Sequence[SnapshotSequence]) -> SnapshotSequence:
    """Stack same-shape sequences along a new leading batch axis (tuple
    fields element by element; a field ``None`` in every sequence stays
    ``None``)."""
    def stack(name):
        vals = [getattr(s, name) for s in seqs]
        if all(v is None for v in vals):
            return None
        if any(v is None for v in vals):
            raise ValueError(f"{name} is set in some sequences only")
        if isinstance(vals[0], tuple):
            return tuple(torch.stack(parts) for parts in zip(*vals))
        return torch.stack(vals)
    return SnapshotSequence(**{f.name: stack(f.name)
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


# ---------------------------------------------------------------------------
# CSR conversion (the JAX package's CSRSnapshots / coo_to_csr)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CSRSnapshots:
    """Per-snapshot CSR with query-sorted edges.

    row_ptr    i32[T, N+1]  CSR offsets over queries
    col        i32[T, E]    key slot per edge (sorted by query)
    perm       i32[T, E]    sorted order -> original COO position
    edge_mask  bool[T, E]
    """
    row_ptr: torch.Tensor
    col: torch.Tensor
    perm: torch.Tensor
    edge_mask: torch.Tensor


def coo_to_csr(edge_q: torch.Tensor, edge_k: torch.Tensor,
               edge_mask: torch.Tensor, num_nodes: int) -> CSRSnapshots:
    """Sort padded COO edges [T, E] by query node (a stable sort, on the
    tensors' own device) and build the row pointers; padded edges go to
    the end."""
    qkey = torch.where(edge_mask, edge_q.long(),
                       torch.full_like(edge_q, num_nodes, dtype=torch.long))
    order = torch.argsort(qkey, dim=-1, stable=True)
    q_sorted = qkey.gather(-1, order)
    counts = torch.zeros(qkey.shape[:-1] + (num_nodes + 1,),
                         dtype=torch.int32, device=qkey.device)
    counts.scatter_add_(-1, q_sorted.clamp(max=num_nodes),
                        torch.ones_like(q_sorted, dtype=torch.int32))
    cum = counts[..., :num_nodes].cumsum(-1, dtype=torch.int32)
    row_ptr = torch.cat([torch.zeros_like(counts[..., :1]), cum], -1)
    return CSRSnapshots(row_ptr=row_ptr, col=edge_k.gather(-1, order),
                        perm=order.to(torch.int32),
                        edge_mask=edge_mask.gather(-1, order))
