"""Block-sparse edge-masked geometric attention, forward and backward.

Counterpart of ``tagan_tpu/ops/pallas/flash_geometric.py``: the score
helpers, the dropout hash, the block-plan builders, the plain PyTorch
versions of the forward and the backward, the wrappers of the CUDA
kernels that port the Pallas ones, and the differentiable entry point:

    B1   _flash_kernel            csrc/flash_pairwalk_fwd.cu
    B2   _flash_bwd_fused_kernel  csrc/flash_pairwalk_bwd.cu
    B3a  _flash_bwd_dq_kernel     csrc/flash_pairwalk_two_walk.cu (row walk)
    B3b  _flash_bwd_dkv_kernel    csrc/flash_pairwalk_two_walk.cu (key walk)
    B4   _lse1_kernel             csrc/flash_pairwalk_fwd.cu
    B5   _flash_biased_kernel     csrc/flash_pairwalk_fwd.cu
    B6   _biased_bwd_pre_kernel   csrc/flash_pairwalk_biased_bwd.cu (row walk)
    B7a  _biased_bwd_dq_kernel    csrc/flash_pairwalk_biased_bwd.cu (row walk)
    B7b  _biased_bwd_dkv_kernel   csrc/flash_pairwalk_biased_bwd.cu (key walk)
    B1c  _flash_kernel, compact   csrc/flash_pairwalk_fwd_compact.cu
    B3a c  _flash_bwd_dq_kernel, compact   csrc/flash_pairwalk_bwd_compact.cu
    B3b c  _flash_bwd_dkv_kernel, compact  csrc/flash_pairwalk_bwd_compact.cu
    B4c  _lse1_kernel, compact    csrc/flash_pairwalk_fwd_compact.cu
    B5c  _flash_biased_kernel, compact  csrc/flash_pairwalk_fwd_compact.cu
    B6c  _biased_bwd_pre_kernel, compact  the compact row walk (*)
    B7a c  _biased_bwd_dq_kernel, compact   the compact row walk (*)
    B7b c  _biased_bwd_dkv_kernel, compact  the compact key walk (*)

(*) csrc/flash_pairwalk_biased_bwd_compact.cu.

B1, B2, B4 and B5 are pair walks that read each mask tile once for all
heads and compute only the mask's valid pairs; so are B3a (a row walk) and
B3b (a key walk), B6 and B7a, together as one row walk, and B7b as the key
walk, and over the compact store B1c,
B4c and B5c (the forward walk's three modes), B6c and B7a c (one row walk),
B3a c (the unbiased row walk), B7b c and B3b c (key walks). Every kernel
above also has a bf16 form (the TPU kernels' ``bf16=True``: every
product's operands rounded to bf16, float32 sums), in the same source
under its own entry point and launch count; the model takes them under
``bf16_matmul``.

B4 and B5 are the forward of the edge-biased variant (``bias=``), the
dense path's double softmax, and B6, B7a and B7b its backward. The
compact forms (a "c" after the name) walk the compact occupied-block
store of the hybrid backend's band (the mask, and the bias, only in the
occupied tiles; a slot per walk step): B1c with B3a c and B3b c here,
and B4c and B5c with B6c, B7a c and B7b c under the edge-biased band's
autograd Function in ``ops.hybrid_biased``.

Supported metrics are those written through the cross term q.k and the
row norms (``MXU_METRICS``); cosine metrics run on L2-normalised q/k;
gaussian/rbf take a per-head scale. Squared distances use the norm
expansion ``max(|q|^2 + |k|^2 - 2 q.k, 0)``, as the TPU kernel does (the
dense path in ``ops.distances`` subtracts then squares).

Dispatch: CPU tensors take the plain versions and CUDA tensors the
kernels; there is no fallback between the two. The kernels trust the
block plans they walk; the public entry points check a plan given by
their caller (`check_plan`), and only the model's own plans, built here,
reach the kernels unchecked.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from ..core.module import round_bf16
from ..ops import build

NEG_INF = -1e30
LSE_DEAD = 1e30   # lse of a row with no valid key

# The CUDA kernels' tile (csrc/flash_geometric_common.cuh: BM, BN). Plans
# fed to the kernels are built at this tile.
BLOCK_M = 64
BLOCK_N = 64

MXU_METRICS = ("scaled_dot_product", "dot_product", "squared_euclidean",
               "euclidean", "gaussian_kernel", "rbf_kernel",
               "cosine_similarity", "cosine_distance")
_SQ_METRICS = ("squared_euclidean", "euclidean", "gaussian_kernel",
               "rbf_kernel")
SCALED_METRICS = ("gaussian_kernel", "rbf_kernel")
_COSINE = ("cosine_similarity", "cosine_distance")

_U32 = 0xFFFFFFFF

# query rows per step of the plain forward: bounds each of its score
# tensors to G * H * 1024 * N floats
_ROW_CHUNK = 1024


def _l2_normalize(x: torch.Tensor) -> torch.Tensor:
    """Row L2 normalisation with the dense path's zero guard."""
    n = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    return x / torch.where(n == 0, torch.full_like(n, 1e-8), n)


def _scores_from(metric: str, qk, sq, scale, true_d: int):
    """Scores from the cross term (and squared distance where needed);
    ``scale`` is the per-head sigma/gamma, broadcastable to ``qk``."""
    if metric == "scaled_dot_product":
        return qk / math.sqrt(true_d)
    if metric == "dot_product":
        return qk
    if metric == "cosine_similarity":
        return qk.clamp(-1.0, 1.0)
    if metric == "cosine_distance":
        return qk.clamp(-1.0, 1.0) - 1.0
    if metric == "squared_euclidean":
        return -sq
    if metric == "euclidean":
        return -torch.sqrt(sq + 1e-8)
    if metric == "gaussian_kernel":
        return torch.exp(-sq / (2.0 * scale * scale))
    if metric == "rbf_kernel":
        return torch.exp(-scale * sq)
    raise NotImplementedError(metric)


def _mm(a, b, bf16: bool = False):
    """``a @ b``; with ``bf16`` the TPU kernels' bf16 contraction: both
    operands rounded to bf16, products and sums in float32."""
    if bf16:
        return round_bf16(a) @ round_bf16(b)
    return a @ b


def _qk_sq(metric: str, q, k, bf16: bool = False):
    """Cross term ``q @ k^T`` and, for the squared-distance metrics, the
    squared distance by the norm expansion. With ``bf16`` only the cross
    term's operands are rounded: the norms take q and k as they are, as
    the TPU kernel's ``_qk_sq`` does."""
    qk = _mm(q, k.transpose(-1, -2), bf16)
    sq = None
    if metric in _SQ_METRICS:
        qn = (q * q).sum(-1, keepdim=True)
        kn = (k * k).sum(-1, keepdim=True).transpose(-1, -2)
        sq = torch.clamp(qn + kn - 2.0 * qk, min=0.0)
    return qk, sq


# ---------------------------------------------------------------------------
# Dropout: the TPU kernel's counter-based hash on global coordinates. uint32
# arithmetic in int64 tensors; products are split in 16-bit halves so that
# no intermediate leaves the int64 range.
# ---------------------------------------------------------------------------

def _keep_thresh(rate: float) -> int:
    """uint32 threshold: ``bits < thresh`` keeps with probability
    1 - rate."""
    return min(int(round((1.0 - rate) * 4294967296.0)), 4294967295)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    lo, hi = x & 0xFFFF, x >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & _U32


def _keep_bits(seed, h, r, c) -> torch.Tensor:
    """The hash of (seed, head, row, col); int64 tensors, broadcast.
    ``seed`` is the int32 seed (negative values wrap as uint32)."""
    x = _mul32(r & _U32, 0x9E3779B1)
    x = x ^ _mul32(c & _U32, 0x85EBCA77)
    x = (x + ((seed & _U32) ^ _mul32(h & _U32, 0xC2B2AE3D))) & _U32
    x = x ^ (x >> 17)
    x = _mul32(x, 0xED5AD4BB)
    x = x ^ (x >> 11)
    x = _mul32(x, 0xAC4C1B51)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x31848BAB)
    return x ^ (x >> 14)


def _keep_mask(seed: int, h: int, row0: int, col0: int, bm: int, bn: int,
               thresh: int) -> torch.Tensor:
    """Keep mask bool[bm, bn] of the block at global (row0, col0), head
    h: the TPU kernel's ``_keep_mask``, bit for bit."""
    r = torch.arange(row0, row0 + bm, dtype=torch.int64)[:, None]
    c = torch.arange(col0, col0 + bn, dtype=torch.int64)[None, :]
    s = torch.tensor(int(seed), dtype=torch.int64)
    hh = torch.tensor(int(h), dtype=torch.int64)
    return _keep_bits(s, hh, r, c) < thresh


# ---------------------------------------------------------------------------
# Block-sparsity plans: for each query block, the occupied key blocks
# (jlist, padded by repeating the last entry) and their count (jcount).
# Leading batch dims are allowed.
# ---------------------------------------------------------------------------

def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _plan_from_occ(occ: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """bool[..., n_i, n_j] occupancy -> (jlist i32[..., n_i, n_j],
    jcount i32[..., n_i])."""
    n_j = occ.shape[-1]
    jcount = occ.sum(-1)
    jidx = torch.arange(n_j, device=occ.device).expand(occ.shape)
    order = torch.argsort(torch.where(occ, jidx, n_j), dim=-1, stable=True)
    jlist = torch.take_along_dim(torch.where(occ, jidx, 0), order, dim=-1)
    last = torch.take_along_dim(
        jlist, torch.clamp(jcount - 1, min=0)[..., None], dim=-1)
    jlist = torch.where(jidx < jcount[..., None], jlist, last)
    return jlist.to(torch.int32), jcount.to(torch.int32)


def _occ_from_mask(mask: torch.Tensor, block_m: int,
                   block_n: int) -> torch.Tensor:
    N = mask.shape[-1]
    Np = _round_up(N, max(block_m, block_n))
    m = torch.nn.functional.pad(mask != 0, (0, Np - N, 0, Np - N))
    lead = m.shape[:-2]
    m = m.reshape(*lead, Np // block_m, block_m, Np // block_n, block_n)
    return m.any(dim=-1).any(dim=-2)


def make_block_plan(mask: torch.Tensor, block_m: int = BLOCK_M,
                    block_n: int = BLOCK_N):
    """The forward walk plan (jlist, jcount) of a dense mask."""
    return _plan_from_occ(_occ_from_mask(mask, block_m, block_n))


def make_block_plans_from_mask(mask: torch.Tensor, block_m: int = BLOCK_M,
                               block_n: int = BLOCK_N):
    """(plan, plan_t): the forward walk and the transposed walk (the
    backward's dk/dv walk) from one occupancy reduction."""
    occ = _occ_from_mask(mask, block_m, block_n)
    return _plan_from_occ(occ), _plan_from_occ(occ.transpose(-1, -2))


def _occ_from_edges(edge_src, edge_dst, edge_mask, node_mask, n: int,
                    block_m: int, block_n: int) -> torch.Tensor:
    """Occupancy bool[..., n_i, n_j] straight from the edge list plus the
    self loops of live nodes, O(E)."""
    Np = _round_up(n, max(block_m, block_n))
    n_i, n_j = Np // block_m, Np // block_n
    lead = edge_src.shape[:-1]
    src, dst = edge_src.long(), edge_dst.long()
    d = torch.arange(n, device=src.device)
    ids = torch.cat([(src // block_m) * n_j + dst // block_n,
                     ((d // block_m) * n_j + d // block_n).expand(lead + (n,))],
                    dim=-1)
    w = torch.cat([edge_mask.to(torch.float32),
                   node_mask.to(torch.float32)], dim=-1)
    contrib = torch.zeros(lead + (n_i * n_j,), device=src.device)
    contrib.scatter_add_(-1, ids, w)
    return (contrib > 0).reshape(lead + (n_i, n_j))


def make_block_plans_from_edges(edge_src, edge_dst, edge_mask, node_mask,
                                n: int, block_m: int = BLOCK_M,
                                block_n: int = BLOCK_N):
    """(plan, plan_t) from the edge list: `make_block_plans_from_mask` of
    the densified edges."""
    occ = _occ_from_edges(edge_src, edge_dst, edge_mask, node_mask, n,
                          block_m, block_n)
    return _plan_from_occ(occ), _plan_from_occ(occ.transpose(-1, -2))


def check_plan(jlist: torch.Tensor, jcount: torch.Tensor, n: int) -> None:
    """Raise ValueError unless (jlist, jcount) is a walk the kernel can
    follow over ``n`` keys at its tile: 0 <= jcount <= W and
    0 <= jlist < ceil(n / BLOCK_N). The kernel reads K/V/mask tiles at
    these indices unchecked. One host synchronisation."""
    n_j, W = -(-n // BLOCK_N), jlist.shape[-1]
    if jlist.shape[:-1] != jcount.shape or jcount.numel() == 0:
        raise ValueError(f"plan shapes {tuple(jlist.shape)} and "
                         f"{tuple(jcount.shape)} do not match")
    lo_c, hi_c = torch.aminmax(jcount)
    ends = [lo_c, hi_c]
    if jlist.numel():
        ends += list(torch.aminmax(jlist))
    ends = torch.stack(ends).tolist()
    if ends[0] < 0 or ends[1] > W:
        raise ValueError(f"plan jcount outside [0, {W}]: {ends[:2]}")
    if len(ends) > 2 and (ends[2] < 0 or ends[3] >= n_j):
        raise ValueError(f"plan jlist outside [0, {n_j}): {ends[2:]}")


# ---------------------------------------------------------------------------
# Plain versions: the forward and the backward, dense over row chunks
# ---------------------------------------------------------------------------

def flash_geometric_forward_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor,
    metric: str, scale: Optional[torch.Tensor] = None,
    dropout_rate: float = 0.0, seed: Optional[torch.Tensor] = None,
    bf16: bool = False, plan=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """What the kernel computes, as a dense masked softmax over row
    chunks. q, k [G, H, N, D], v [G, H, N, Dv], mask [G, N, N], scale
    f32[H], seed i32[G] -> (out f32[G, H, N, Dv], lse f32[G, H, N]).
    Cosine metrics expect q/k already normalised, as the kernel does.

    ``bf16``: what B1's bf16 form computes. q.k and drop(p) v take bf16
    operands, and p is rounded relative to the running max of the walk,
    so this form walks the plan (jlist, jcount) [G, ceil(N/64), W] at the
    kernel's 64 x 64 tile (built from the mask when None), in its order,
    with the kernel's online softmax."""
    G, H, N, D = q.shape
    if scale is None:
        scale = torch.ones(H, dtype=q.dtype, device=q.device)
    if bf16:
        jlist, jcount = make_block_plan(mask) if plan is None else plan
        return _walk_forward(
            _dense_steps(q, k, mask, jlist, jcount, metric, scale, True),
            q, v, jlist, dropout_rate, seed, True)
    sc = scale.reshape(1, H, 1, 1)
    thresh = _keep_thresh(dropout_rate)
    inv_keep = 1.0 / (1.0 - dropout_rate) if dropout_rate > 0 else 1.0
    outs, lses = [], []
    for r0 in range(0, N, _ROW_CHUNK):
        r1 = min(N, r0 + _ROW_CHUNK)
        s, valid = _chunk_scores(metric, q, k, mask, sc, r0, r1)
        s = torch.where(valid, s, torch.full_like(s, NEG_INF))
        m = s.amax(-1, keepdim=True)
        p = torch.exp(s - m)
        l = p.sum(-1, keepdim=True)
        if dropout_rate > 0.0:
            keep = _keep_rows(seed, H, r0, r1, N, q.device) < thresh
            p = torch.where(keep, p * inv_keep, torch.zeros_like(p))
        acc = p @ v
        dead = m <= NEG_INF
        safe = torch.where(dead, torch.ones_like(l), l)
        outs.append(torch.where(dead, torch.zeros_like(acc), acc / safe))
        lses.append(torch.where(dead, torch.full_like(m, LSE_DEAD),
                                m + torch.log(safe))[..., 0])
    return torch.cat(outs, dim=2), torch.cat(lses, dim=2)


def _keep_rows(seed, H, r0, r1, N, dev) -> torch.Tensor:
    """Keep-mask hash bits [G, H, r1 - r0, N] of query rows r0..r1."""
    G = seed.shape[0]
    return _keep_bits(seed.to(dev, torch.int64).reshape(G, 1, 1, 1),
                      torch.arange(H, device=dev).reshape(1, H, 1, 1),
                      torch.arange(r0, r1, device=dev).reshape(1, 1, -1, 1),
                      torch.arange(N, device=dev).reshape(1, 1, 1, -1))


def _chunk_scores(metric, q, k, mask, sc, r0, r1, bf16=False):
    """(scores [G, H, r1 - r0, N], valid) of query rows r0..r1; q.k at
    bf16 with ``bf16`` (`_qk_sq`)."""
    qk, sq = _qk_sq(metric, q[:, :, r0:r1], k, bf16)
    s = _scores_from(metric, qk, sq, sc, q.shape[-1])
    return s, mask[:, None, r0:r1, :] != 0


# ---------------------------------------------------------------------------
# The compact occupied-block store: the mask only in the occupied tiles
# (the kernels' BLOCK_M x BLOCK_N = 64 x 64), and a slot per walk step
# (jslot). Bits: i64[..., S, 64], bit c of word r is pair (r, c) of the
# tile; or int8 [..., S, 64, 64].
# ---------------------------------------------------------------------------

def store_packed(store: torch.Tensor) -> bool:
    """Whether a compact store is bits (i64[..., S, 64]) rather than int8
    ([..., S, 64, 64]); ValueError for any other shape or type."""
    if store.dtype == torch.int64 and store.dim() >= 2 \
            and store.shape[-1] == BLOCK_M:
        return True
    if store.dtype in (torch.int8, torch.uint8, torch.bool) \
            and store.dim() >= 3 and store.shape[-2:] == (BLOCK_M, BLOCK_N):
        return False
    raise ValueError(f"compact store must be int64 bits [..., S, {BLOCK_M}] "
                     f"or int8 [..., S, {BLOCK_M}, {BLOCK_N}], got "
                     f"{store.dtype} {tuple(store.shape)}")


def unpack_bits(words: torch.Tensor) -> torch.Tensor:
    """bool[..., 64] of int64 words: bit c of each word at column c."""
    c = torch.arange(64, device=words.device)
    return ((words[..., None] >> c) & 1) != 0


def store_pairs(store: torch.Tensor) -> torch.Tensor:
    """bool [..., S, 64, 64]: the valid pairs of a compact store (bits or
    int8, `store_packed`) or of tiles gathered from one."""
    return unpack_bits(store) if store_packed(store) else store != 0


def pack_bits(rows: torch.Tensor) -> torch.Tensor:
    """int64 words of bool[..., 64] rows, the inverse of `unpack_bits`
    (bit 63 is the sign bit)."""
    c = torch.arange(63, device=rows.device)
    low = (rows[..., :63].to(torch.int64) << c).sum(-1)
    return low + torch.where(rows[..., 63], torch.iinfo(torch.int64).min, 0)


def _compact_slots(mask: torch.Tensor):
    """(occupancy [G, n_i, n_j], each tile's row-major slot [G, n_i * n_j]
    (valid where occupied), S the most slots any g has)."""
    occ = _occ_from_mask(mask, BLOCK_M, BLOCK_N)
    slot = occ.reshape(occ.shape[0], -1).long().cumsum(-1) - 1
    return occ, slot, max(int(slot[:, -1].max()) + 1, 1)


def compact_values(mask: torch.Tensor, values: torch.Tensor
                   ) -> torch.Tensor:
    """values [G, N, N] in the slots `compact_from_mask` gives the mask's
    occupied tiles: [G, S, 64, 64] (a bias store; unused slots zero)."""
    G, N = mask.shape[0], mask.shape[-1]
    occ, slot, S = _compact_slots(mask)
    n_i, n_j = occ.shape[1:]
    tiles = torch.nn.functional.pad(
        values, (0, n_j * BLOCK_N - N, 0, n_i * BLOCK_M - N)).reshape(
        G, n_i, BLOCK_M, n_j, BLOCK_N).transpose(2, 3)
    out = torch.zeros((G, S, BLOCK_M, BLOCK_N), dtype=values.dtype,
                      device=mask.device)
    g, i, j = occ.nonzero(as_tuple=True)
    out[g, slot[g, i * n_j + j]] = tiles[g, i, j]
    return out


def compact_from_mask(mask: torch.Tensor, pack: bool = True):
    """(store, (jlist, jcount, jslot)) of a dense mask [G, N, N]: its
    occupied tiles in row-major slots, bits or int8 (`store_packed`)."""
    occ, slot, S = _compact_slots(mask)
    n_i, n_j = occ.shape[1:]
    jlist, jcount = _plan_from_occ(occ)
    jslot = slot.gather(-1, (torch.arange(n_i, device=mask.device)[:, None]
                             * n_j + jlist.long()).reshape(mask.shape[0], -1))
    jslot = jslot.clamp(0, S - 1).reshape(jlist.shape).to(torch.int32)
    tiles = compact_values(mask, mask != 0)
    store = pack_bits(tiles) if pack else tiles.to(torch.int8)
    return store, (jlist, jcount, jslot)


def compact_transposed_plan(mask: torch.Tensor):
    """(ilist, icount, islot) of a dense mask [G, N, N]: the transposed
    walk (each key tile's occupied row tiles) over the store
    `compact_from_mask` builds, islot naming the same (row tile, key
    tile) slot, so both walks read one store."""
    occ, slot, S = _compact_slots(mask)
    n_j = occ.shape[-1]
    ilist, icount = _plan_from_occ(occ.transpose(-1, -2))
    keys = torch.arange(n_j, device=mask.device)[:, None]
    islot = slot.gather(-1, (ilist.long() * n_j + keys).reshape(
        mask.shape[0], -1))
    return ilist, icount, islot.clamp(0, S - 1).reshape(ilist.shape).to(
        torch.int32)


def check_compact_plan(jlist, jcount, jslot, store, n: int) -> None:
    """Raise ValueError unless (jlist, jcount, jslot) is a walk over the
    store of ``n`` keys: shapes that match each other and the store, 0 <=
    jcount <= W, 0 <= jlist < ceil(n / BN) and 0 <= jslot < S. The
    kernels read tiles at these indices unchecked. One host
    synchronisation."""
    packed = store_packed(store)
    S = store.shape[-2 if packed else -3]
    if jslot.shape != jlist.shape or jlist.shape[:-1] != jcount.shape \
            or jcount.numel() == 0:
        raise ValueError(f"compact plan shapes {tuple(jlist.shape)}, "
                         f"{tuple(jcount.shape)}, {tuple(jslot.shape)} do "
                         f"not match")
    if jcount.shape[-1] * BLOCK_M < n:
        raise ValueError(f"{jcount.shape[-1]} row tiles of {BLOCK_M} do "
                         f"not cover {n} rows")
    if S == 0:
        raise ValueError("compact store has no slot")
    n_j, W = -(-n // BLOCK_N), jlist.shape[-1]
    ends = [*torch.aminmax(jcount)]
    if jlist.numel():
        ends += [*torch.aminmax(jlist), *torch.aminmax(jslot)]
    ends = torch.stack(ends).tolist()
    if ends[0] < 0 or ends[1] > W:
        raise ValueError(f"plan jcount outside [0, {W}]: {ends[:2]}")
    if len(ends) > 2 and (ends[2] < 0 or ends[3] >= n_j):
        raise ValueError(f"plan jlist outside [0, {n_j}): {ends[2:4]}")
    if len(ends) > 2 and (ends[4] < 0 or ends[5] >= S):
        raise ValueError(f"plan jslot outside [0, {S}): {ends[4:]}")


def _row_tiles(x, n_i, value=0.0):
    """x [G, H, N(, F)] padded to n_i whole row tiles with ``value``:
    [G, H, n_i, BM(, F)]."""
    G, H, N = x.shape[:3]
    pad = (0, 0) * (x.dim() - 3) + (0, n_i * BLOCK_M - N)
    return torch.nn.functional.pad(x, pad, value=value).reshape(
        G, H, n_i, BLOCK_M, *x.shape[3:])


def _key_tiles(x, rows_p):
    """x [G, H, N, F] padded to whole key tiles: [G, H, n_t, BN, F], with
    every tile index a plan over ``rows_p`` padded rows can name."""
    G, H, N, F = x.shape
    keys_p = _round_up(max(rows_p, N), BLOCK_N)
    return torch.nn.functional.pad(x, (0, 0, 0, keys_p - N)).reshape(
        G, H, keys_p // BLOCK_N, BLOCK_N, F)


def _gather_tiles(xt, jb):
    """Tiles jb [G, n_i] of xt [G, H, n_t, BN, F]: [G, H, n_i, BN, F]."""
    gi = torch.arange(xt.shape[0], device=xt.device)[:, None]
    return xt[gi, :, jb].permute(0, 2, 1, 3, 4)


def _compact_steps(q, k, store, jlist, jcount, jslot, metric, scale,
                   bf16=False):
    """The compact walk of the plain versions, all row tiles at once
    (`_walk_steps`, q.k at bf16 with ``bf16``): step w of row tile i
    reads the mask tile store[g, jslot[g, i, w]]."""
    gi = torch.arange(q.shape[0], device=q.device)[:, None]

    def tile_of(w, jb):
        return store_pairs(store[gi, jslot[..., w].long()])
    return _walk_steps(q, k, tile_of, jlist, jcount, metric, scale, bf16)


def _pair_tiles(x: torch.Tensor, n_i: int):
    """The (row tile i, key tile jb) tiles of a pair matrix x [G, N, N],
    padded with zeros (False) to whole tiles: a function of the walk step
    (w, jb [G, n_i]) -> [G, n_i, BM, BN], as `_walk_steps` takes it."""
    G, N = x.shape[0], x.shape[-1]
    keys_p = _round_up(max(n_i * BLOCK_M, N), BLOCK_N)
    tiles = torch.nn.functional.pad(
        x, (0, keys_p - N, 0, n_i * BLOCK_M - N)).reshape(
        G, n_i, BLOCK_M, keys_p // BLOCK_N, BLOCK_N)
    gi = torch.arange(G, device=x.device)[:, None]
    ri = torch.arange(n_i, device=x.device)[None, :]

    def tile_of(w, jb):
        return tiles[gi, ri, :, jb]
    return tile_of


def _dense_steps(q, k, mask, jlist, jcount, metric, scale, bf16=False):
    """The walk of the plan (jlist, jcount) over a dense mask [G, N, N]
    (`_walk_steps`): step w of row tile i reads the mask's tile (i,
    jlist[g, i, w])."""
    return _walk_steps(q, k, _pair_tiles(mask != 0, jlist.shape[-2]), jlist,
                       jcount, metric, scale, bf16)


def _walk_steps(q, k, tile_of, jlist, jcount, metric, scale, bf16=False):
    """The walk of the plain versions, all row tiles at once: per step w,
    (scores [G, H, n_i, BM, BN], valid [G, 1, n_i, BM, BN], key tile
    index [G, n_i], global rows [n_i, BM, 1], global columns
    [G, n_i, 1, BN]). Step w of row tile i scores the key tile
    jlist[g, i, w] against the mask tile ``tile_of(w, jlist[..., w])``
    (bool [G, n_i, BM, BN]); pairs of steps at or past jcount, and rows or
    columns past N, are not valid. Also yields the step's cross terms and
    squared distances (`_qk_sq`, with ``bf16``) last, for the backward's
    chain weights."""
    G, H, N, D = q.shape
    n_i, W = jlist.shape[-2], jlist.shape[-1]
    rows_p = n_i * BLOCK_M
    qt = _row_tiles(q, n_i)
    kt = _key_tiles(k, rows_p)
    sc = scale.reshape(1, H, 1, 1, 1)
    rows = torch.arange(rows_p, device=q.device).reshape(n_i, BLOCK_M, 1)
    for w in range(W):
        jb = jlist[..., w].long()                                # [G, n_i]
        qk, sq = _qk_sq(metric, qt, _gather_tiles(kt, jb), bf16)
        s = _scores_from(metric, qk, sq, sc, D)
        cols = (jb * BLOCK_N)[..., None, None] \
            + torch.arange(BLOCK_N, device=q.device)
        valid = tile_of(w, jb) & (rows < N) & (cols < N) \
            & (w < jcount)[..., None, None]
        yield s, valid[:, None], jb, rows, cols, qk, sq


def _tile_keep(seed, H, rows, cols) -> torch.Tensor:
    """Hash bits [G, H, n_i, BM, BN] of the tiles' global (row, column)
    pairs: the TPU kernel's coordinate hash, so the keep mask does not
    depend on the tile."""
    dev = rows.device
    return _keep_bits(seed.to(dev, torch.int64).reshape(-1, 1, 1, 1, 1),
                      torch.arange(H, device=dev).reshape(1, H, 1, 1, 1),
                      rows[None, None], cols[:, None])


def _finish_online(m, l, acc, N):
    """(out [G, H, N, Dv] or None, lse [G, H, N]) of the online softmax
    state over row tiles [G, H, n_i, BM(, Dv)]."""
    G, H = m.shape[:2]
    dead = m <= NEG_INF
    safe = torch.where(dead, torch.ones_like(l), l)
    lse = torch.where(dead, torch.full_like(m, LSE_DEAD), m + torch.log(safe))
    lse = lse.reshape(G, H, -1)[..., :N].contiguous()
    if acc is None:
        return None, lse
    out = torch.where(dead[..., None], torch.zeros_like(acc),
                      acc / safe[..., None])
    return out.reshape(G, H, -1, acc.shape[-1])[:, :, :N].contiguous(), lse


def _online_step(m, l, acc, z, valid, p_fn=None, vt=None, bf16=False):
    """One step of the online softmax of z (masked by ``valid``):
    updates (m, l, acc); ``p_fn`` drops the weights before P@V, which
    takes bf16 operands with ``bf16`` (the sum l does not)."""
    m_new = torch.maximum(m, torch.where(valid, z, NEG_INF).amax(-1))
    alpha = torch.exp(m - m_new)
    p = torch.where(valid, torch.exp(z - m_new[..., None]),
                    torch.zeros_like(z))
    l = l * alpha + p.sum(-1)
    if acc is not None:
        pd = p if p_fn is None else p_fn(p)
        acc = acc * alpha[..., None] + _mm(pd, vt, bf16)
    return m_new, l, acc


def _online_init(q, jlist, Dv=None):
    G, H = q.shape[:2]
    shape = (G, H, jlist.shape[-2], BLOCK_M)
    m = torch.full(shape, NEG_INF, dtype=q.dtype, device=q.device)
    acc = None if Dv is None else torch.zeros(shape + (Dv,), dtype=q.dtype,
                                              device=q.device)
    return m, torch.zeros_like(m), acc


def flash_geometric_forward_compact_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, store: torch.Tensor,
    jlist: torch.Tensor, jcount: torch.Tensor, jslot: torch.Tensor,
    metric: str, scale: Optional[torch.Tensor] = None,
    dropout_rate: float = 0.0, seed: Optional[torch.Tensor] = None,
    bf16: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """What B1c computes: the forward over the compact store, an online
    softmax over the walk steps, every row tile at once. q, k [G, H, N,
    D], v [G, H, N, Dv], store and plan as in `check_compact_plan` with
    leading dim G, scale f32[H], seed i32[G] -> (out [G, H, N, Dv], lse
    [G, H, N]), zero and ``LSE_DEAD`` on rows with no valid key. The
    dropout hash takes global coordinates, as B1's does. ``bf16``: what
    B1c's bf16 form computes, q.k and drop(p) v from bf16 operands, p
    rounded relative to the running max after each step of the walk, in
    jlist order (as the dense plain bf16 forward walks its plan)."""
    if scale is None:
        scale = torch.ones(q.shape[1], dtype=q.dtype, device=q.device)
    return _walk_forward(
        _compact_steps(q, k, store, jlist, jcount, jslot, metric, scale,
                       bf16), q, v, jlist, dropout_rate, seed, bf16)


def _walk_forward(steps, q, v, jlist, dropout_rate, seed, bf16=False):
    """(out, lse) of the online softmax over a walk's ``steps``
    (`_walk_steps`), P@V at bf16 with ``bf16``."""
    H, N = q.shape[1], q.shape[2]
    thresh = _keep_thresh(dropout_rate)
    inv_keep = 1.0 / (1.0 - dropout_rate) if dropout_rate > 0 else 1.0
    vt = _key_tiles(v, jlist.shape[-2] * BLOCK_M)
    m, l, acc = _online_init(q, jlist, v.shape[-1])
    for s, valid, jb, rows, cols, _, _ in steps:
        drop = None
        if dropout_rate > 0.0:
            keep = _tile_keep(seed, H, rows, cols) < thresh

            def drop(p, keep=keep):
                return torch.where(keep, p * inv_keep, torch.zeros_like(p))
        m, l, acc = _online_step(m, l, acc, s, valid, drop,
                                 _gather_tiles(vt, jb), bf16)
    return _finish_online(m, l, acc, N)


def flash_lse1_compact_plain(q, k, store, jlist, jcount, jslot, metric: str,
                             scale: Optional[torch.Tensor] = None,
                             bf16: bool = False) -> torch.Tensor:
    """What B4c computes: lse1 [G, H, N] over the compact store
    (``LSE_DEAD`` on rows with no valid key). ``bf16``: what B4c's bf16
    form computes, q.k from bf16 operands (the norms and the sums
    float32)."""
    H, N = q.shape[1], q.shape[2]
    if scale is None:
        scale = torch.ones(H, dtype=q.dtype, device=q.device)
    m, l, _ = _online_init(q, jlist)
    for s, valid, _, _, _, _, _ in _compact_steps(q, k, store, jlist,
                                                  jcount, jslot, metric,
                                                  scale, bf16):
        m, l, _ = _online_step(m, l, None, s, valid)
    return _finish_online(m, l, None, N)[1]


def flash_biased_forward_compact_plain(
    q, k, v, store, bias_store, lse1, jlist, jcount, jslot, metric: str,
    scale: Optional[torch.Tensor] = None, dropout_rate: float = 0.0,
    seeds: Optional[torch.Tensor] = None, bf16: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """What B5c computes: `flash_biased_forward_plain` over the compact
    store, with the bias in the same slots, f32[G, S, BM, BN], and lse1
    [G, H, N] given (the hybrid backend's union lse1: a logsumexp over a
    superset of the walked pairs). -> (out [G, H, N, Dv], lse2
    [G, H, N]). ``bf16``: what B5c's bf16 form computes, q.k and
    drop2(p2) v from bf16 operands, p2 rounded relative to the running
    max after each step of the walk, in jlist order (as the dense plain
    bf16 B5 walks its plan)."""
    if scale is None:
        scale = torch.ones(q.shape[1], dtype=q.dtype, device=q.device)
    gi = torch.arange(q.shape[0], device=q.device)[:, None]

    def bias_of(w, jb):
        return bias_store[gi, jslot[..., w].long()]
    return _walk_biased(
        _compact_steps(q, k, store, jlist, jcount, jslot, metric, scale,
                       bf16), q, v, lse1, bias_of, jlist, dropout_rate,
        seeds, bf16)


def _walk_biased(steps, q, v, lse1, bias_of, jlist, dropout_rate, seeds,
                 bf16=False):
    """(out, lse2) of the second softmax over a walk's ``steps``
    (`_walk_steps`): per step w1 = exp(s - lse1), z = drop1(w1) +
    ``bias_of(w, jb)`` ([G, n_i, BM, BN]), then the online softmax of z
    with drop2 before P@V, P@V at bf16 with ``bf16``."""
    G, H, N, _ = q.shape
    thresh = _keep_thresh(dropout_rate)
    inv_keep = 1.0 / (1.0 - dropout_rate) if dropout_rate > 0 else 1.0
    n_i = jlist.shape[-2]
    l1 = torch.nn.functional.pad(lse1, (0, n_i * BLOCK_M - N),
                                 value=LSE_DEAD).reshape(G, H, n_i, BLOCK_M,
                                                         1)
    vt = _key_tiles(v, n_i * BLOCK_M)
    m, l, acc = _online_init(q, jlist, v.shape[-1])
    for w, (s, valid, jb, rows, cols, _, _) in enumerate(steps):
        w1 = torch.exp(torch.where(valid, s - l1, NEG_INF))
        if dropout_rate > 0.0:
            keep1 = _tile_keep(seeds[:, 0], H, rows, cols) < thresh
            w1 = torch.where(keep1, w1 * inv_keep, torch.zeros_like(w1))
        z = w1 + bias_of(w, jb)[:, None]
        drop = None
        if dropout_rate > 0.0:
            keep2 = _tile_keep(seeds[:, 1], H, rows, cols) < thresh

            def drop(p, keep=keep2):
                return torch.where(keep, p * inv_keep, torch.zeros_like(p))
        m, l, acc = _online_step(m, l, acc, z, valid, drop,
                                 _gather_tiles(vt, jb), bf16)
    return _finish_online(m, l, acc, N)


def flash_lse1_plain(q: torch.Tensor, k: torch.Tensor, mask: torch.Tensor,
                     metric: str, scale: Optional[torch.Tensor] = None,
                     bf16: bool = False) -> torch.Tensor:
    """What B4 computes: lse1 f32[G, H, N], the logsumexp of the masked
    scores (the first softmax of the edge-biased variant), ``LSE_DEAD``
    on rows with no valid key. Shapes as in
    `flash_geometric_forward_plain`. ``bf16``: what B4's bf16 form
    computes, q.k from bf16 operands (the norms and the sums float32);
    no rounding follows the walk, so the row chunks serve."""
    G, H, N, _ = q.shape
    if scale is None:
        scale = torch.ones(H, dtype=q.dtype, device=q.device)
    sc = scale.reshape(1, H, 1, 1)
    lses = []
    for r0 in range(0, N, _ROW_CHUNK):
        s, valid = _chunk_scores(metric, q, k, mask, sc, r0,
                                 min(N, r0 + _ROW_CHUNK), bf16)
        s = torch.where(valid, s, torch.full_like(s, NEG_INF))
        m = s.amax(-1)
        dead = m <= NEG_INF
        l = torch.exp(s - m[..., None]).sum(-1)
        lses.append(torch.where(dead, torch.full_like(m, LSE_DEAD),
                                m + torch.log(torch.where(dead,
                                                          torch.ones_like(l),
                                                          l))))
    return torch.cat(lses, dim=2)


def flash_biased_forward_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor,
    bias: torch.Tensor, lse1: torch.Tensor, metric: str,
    scale: Optional[torch.Tensor] = None, dropout_rate: float = 0.0,
    seeds: Optional[torch.Tensor] = None, bf16: bool = False, plan=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """What B5 computes, given lse1 (B4's output, or a logsumexp over a
    superset of the mask's pairs): per valid pair w1 = exp(s - lse1),
    w1d = drop1(w1), z = w1d + bias; out = drop2(softmax_j z) @ v with
    the un-dropped denominator, and lse2 = logsumexp_j z. A dropped w1 is
    not a masked pair: it enters the second softmax as z = bias. bias
    f32[G, N, N] (shared by the heads), lse1 [G, H, N], seeds i32[G, 2]
    (drop1's seed, drop2's seed) -> (out [G, H, N, Dv], lse2 [G, H, N]),
    zero and ``LSE_DEAD`` on rows with no valid key.

    ``bf16``: what B5's bf16 form computes. q.k and drop2(p2) v take bf16
    operands, and p2 is rounded relative to the running max of the walk,
    so this form walks the plan (jlist, jcount) at the kernel's 64 x 64
    tile (built from the mask when None), in its order, as the bf16
    `flash_geometric_forward_plain` does."""
    G, H, N, _ = q.shape
    if scale is None:
        scale = torch.ones(H, dtype=q.dtype, device=q.device)
    if seeds is None:
        seeds = torch.zeros((G, 2), dtype=torch.int32, device=q.device)
    if bf16:
        jlist, jcount = make_block_plan(mask) if plan is None else plan
        return _walk_biased(
            _dense_steps(q, k, mask, jlist, jcount, metric, scale, True),
            q, v, lse1, _pair_tiles(bias, jlist.shape[-2]), jlist,
            dropout_rate, seeds, True)
    sc = scale.reshape(1, H, 1, 1)
    thresh = _keep_thresh(dropout_rate)
    inv_keep = 1.0 / (1.0 - dropout_rate) if dropout_rate > 0 else 1.0
    outs, lses = [], []
    for r0 in range(0, N, _ROW_CHUNK):
        r1 = min(N, r0 + _ROW_CHUNK)
        s, valid = _chunk_scores(metric, q, k, mask, sc, r0, r1)
        neg = torch.full_like(s, NEG_INF)
        w1 = torch.exp(torch.where(valid, s - lse1[:, :, r0:r1, None], neg))
        if dropout_rate > 0.0:
            keep1 = _keep_rows(seeds[:, 0], H, r0, r1, N, q.device) < thresh
            w1 = torch.where(keep1, w1 * inv_keep, torch.zeros_like(w1))
        z = torch.where(valid, w1 + bias[:, None, r0:r1, :], neg)
        m = z.amax(-1, keepdim=True)
        p = torch.exp(z - m)
        l = p.sum(-1, keepdim=True)
        if dropout_rate > 0.0:
            keep2 = _keep_rows(seeds[:, 1], H, r0, r1, N, q.device) < thresh
            p = torch.where(keep2, p * inv_keep, torch.zeros_like(p))
        acc = p @ v
        dead = m <= NEG_INF
        safe = torch.where(dead, torch.ones_like(l), l)
        outs.append(torch.where(dead, torch.zeros_like(acc), acc / safe))
        lses.append(torch.where(dead, torch.full_like(m, LSE_DEAD),
                                m + torch.log(safe))[..., 0])
    return torch.cat(outs, dim=2), torch.cat(lses, dim=2)


def _biased_chunks(q, k, v, mask, bias, do, lse1, lse2, delta2, metric,
                   scale, dropout_rate, seeds, bf16=False):
    """The biased backward's recompute (the TPU kernels'
    ``_bwd_biased_common``) over the row chunks of the plain forward:
    per chunk (r0, r1, w1, dw1, dz, w2d, s, sq, qk) [G, H, r1 - r0, N],
    with w1 = exp(s - lse1) on the mask, z = drop1(w1) + bias, w2 =
    exp(z - lse2), dz = w2 (drop2(do v^T) - delta2), dw1 = drop1(dz) and
    w2d = drop2(w2); all 0 off the mask. q.k and do v^T take bf16
    operands with ``bf16``."""
    G, H, N, D = q.shape
    sc = scale.reshape(1, H, 1, 1)
    thresh = _keep_thresh(dropout_rate)
    inv_keep = 1.0 / (1.0 - dropout_rate) if dropout_rate > 0 else 1.0
    for r0 in range(0, N, _ROW_CHUNK):
        r1 = min(N, r0 + _ROW_CHUNK)
        qk, sq = _qk_sq(metric, q[:, :, r0:r1], k, bf16)
        s = _scores_from(metric, qk, sq, sc, D)
        valid = mask[:, None, r0:r1, :] != 0
        neg = torch.full_like(s, NEG_INF)
        w1 = torch.exp(torch.where(valid, s - lse1[:, :, r0:r1, None], neg))
        dp2 = _mm(do[:, :, r0:r1], v.transpose(-1, -2), bf16)
        w1d = w1
        if dropout_rate > 0.0:
            keep1 = _keep_rows(seeds[:, 0], H, r0, r1, N, q.device) < thresh
            keep2 = _keep_rows(seeds[:, 1], H, r0, r1, N, q.device) < thresh
            w1d = torch.where(keep1, w1 * inv_keep, torch.zeros_like(w1))
            dp2 = torch.where(keep2, dp2 * inv_keep, torch.zeros_like(dp2))
        z = torch.where(valid, w1d + bias[:, None, r0:r1, :], neg)
        w2 = torch.exp(z - lse2[:, :, r0:r1, None])
        dz = w2 * (dp2 - delta2[:, :, r0:r1, None])
        dw1, w2d = dz, w2
        if dropout_rate > 0.0:
            dw1 = torch.where(keep1, dz * inv_keep, torch.zeros_like(dz))
            w2d = torch.where(keep2, w2 * inv_keep, torch.zeros_like(w2))
        yield r0, r1, w1, dw1, dz, w2d, s, sq, qk


def _biased_bwd_plain(q, k, v, mask, bias, do, lse1, lse2, delta2, metric,
                      scale, dropout_rate, seeds, delta1=None,
                      need_dscale=False, parts=("pre", "dq", "dkv"),
                      bf16=False):
    """The plain biased backward over row chunks; ``parts`` picks what is
    formed: "pre" (delta1, dB), "dq" (dq, dscale), "dkv" (dk, dv).
    ``delta1`` None takes each chunk's own row sums (the whole walk);
    given, it is used as it is, as in B7a and B7b. ``bf16``: the
    products take bf16 operands, the chain's being the quantity the TPU
    kernels round (`_chain_operand`), in their order. Returns a dict."""
    G, H, N, D = q.shape
    if scale is None:
        scale = torch.ones(H, dtype=q.dtype, device=q.device)
    if seeds is None:
        seeds = torch.zeros((G, 2), dtype=torch.int32, device=q.device)
    sc = scale.reshape(1, H, 1, 1)
    sq_metric = metric in _SQ_METRICS
    res = {}
    if "pre" in parts:
        res["delta1"] = torch.empty(G, H, N, dtype=q.dtype, device=q.device)
        res["dbias"] = torch.empty(G, N, N, dtype=q.dtype, device=q.device)
    if "dq" in parts:
        res["dq"] = torch.empty_like(q)
        dsc = torch.zeros(H, dtype=q.dtype, device=q.device)
    if "dkv" in parts:
        res["dk"], res["dv"] = torch.zeros_like(k), torch.zeros_like(v)
        wcol = torch.zeros(G, H, N, dtype=q.dtype, device=q.device)
    for r0, r1, w1, dw1, dz, w2d, s, sq, qk in _biased_chunks(
            q, k, v, mask, bias, do, lse1, lse2, delta2, metric, scale,
            dropout_rate, seeds, bf16):
        d1 = (w1 * dw1).sum(-1) if delta1 is None else delta1[:, :, r0:r1]
        if "pre" in parts:
            res["delta1"][:, :, r0:r1] = d1
            res["dbias"][:, r0:r1] = dz.sum(1)
        if "dq" not in parts and "dkv" not in parts:
            continue
        ds = w1 * (dw1 - d1[..., None])
        w = _chain_weight(metric, ds, s, sq, qk, sc, D)
        u, c = _chain_operand(metric, ds, s, sq, qk, sc, D) if bf16 \
            else (w, 1.0)
        qc = q[:, :, r0:r1]
        if "dq" in parts:
            dqc = _mm(u, k, bf16) / c
            if sq_metric:
                dqc = dqc - w.sum(-1, keepdim=True) * qc
            res["dq"][:, :, r0:r1] = dqc
            if need_dscale:
                dsc += (ds * s * sq).sum((0, 2, 3))
        if "dkv" in parts:
            res["dk"] += _mm(u.transpose(-1, -2), qc, bf16) / c
            res["dv"] += _mm(w2d.transpose(-1, -2), do[:, :, r0:r1], bf16)
            if sq_metric:
                wcol += w.sum(-2)
    if "dkv" in parts and sq_metric:
        res["dk"] -= wcol[..., None] * k
    if "dq" in parts:
        res["dscale"] = None
        if need_dscale:
            res["dscale"] = dsc / scale ** 3 \
                if metric == "gaussian_kernel" else -dsc
    return res


def flash_biased_backward_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor,
    bias: torch.Tensor, out: torch.Tensor, lse1: torch.Tensor,
    lse2: torch.Tensor, do: torch.Tensor, metric: str,
    scale: Optional[torch.Tensor] = None, dropout_rate: float = 0.0,
    seeds: Optional[torch.Tensor] = None, need_dscale: bool = False,
    bf16: bool = False,
):
    """What B6, B7a and B7b compute together (the TPU package's
    ``flash_biased_attention_bwd``), written out over the row chunks of
    `flash_biased_forward_plain` (not autograd of it: the kernels' chain
    takes the clamp max(sq, 0) as the identity). Per pair on the mask,
    w1 = exp(s - lse1), z = drop1(w1) + bias, w2 = exp(z - lse2),
    dz = w2 (drop2(do v^T) - delta2) with delta2 = rowsum(do out),
    dw1 = drop1(dz); then delta1 = rowsum(w1 dw1), dB = sum_h dz, ds =
    w1 (dw1 - delta1), the metric chain (`_chain_weight`) to dq and dk,
    dv = drop2(w2)^T do, and for gaussian/rbf dscale as in
    `flash_geometric_backward_plain`. Shapes as in
    `flash_biased_forward_plain`; out and do like the forward's out.
    Returns (dq, dk, dv, dB f32[G, N, N] (0 off the mask), dscale f32[H]
    or None). Cosine metrics expect q/k already normalised.

    ``bf16``: what their bf16 forms compute. q.k, do v^T, the chain's
    products (`_chain_operand`, in the TPU kernels' order) and dv's take
    bf16 operands; w1, z, w2, dz, delta1, dB and the squared-distance
    metrics' sums of W stay float32. The backward normalises by lse1 and
    lse2, so no walk order enters."""
    r = _biased_bwd_plain(q, k, v, mask, bias, do, lse1, lse2,
                          (do * out).sum(-1), metric, scale, dropout_rate,
                          seeds, need_dscale=need_dscale, bf16=bf16)
    return r["dq"], r["dk"], r["dv"], r["dbias"], r["dscale"]


def flash_biased_bwd_pre_plain(q, k, v, mask, bias, do, lse1, lse2, delta2,
                               metric: str, scale=None,
                               dropout_rate: float = 0.0, seeds=None,
                               bf16: bool = False):
    """What B6 computes: (delta1 f32[G, H, N], dB f32[G, N, N]) given
    lse1, lse2 and delta2 [G, H, N] (dB 0 off the mask); its bf16 form
    with ``bf16`` (`flash_biased_backward_plain`)."""
    r = _biased_bwd_plain(q, k, v, mask, bias, do, lse1, lse2, delta2, metric,
                          scale, dropout_rate, seeds, parts=("pre",),
                          bf16=bf16)
    return r["delta1"], r["dbias"]


def flash_biased_bwd_dq_plain(q, k, v, mask, bias, do, lse1, lse2, delta2,
                              delta1, metric: str, scale=None,
                              dropout_rate: float = 0.0, seeds=None,
                              need_dscale: bool = False, bf16: bool = False):
    """What B7a computes: (dq, dscale f32[H] or None) given B6's
    delta1; its bf16 form with ``bf16``."""
    r = _biased_bwd_plain(q, k, v, mask, bias, do, lse1, lse2, delta2, metric,
                          scale, dropout_rate, seeds, delta1, need_dscale,
                          ("dq",), bf16)
    return r["dq"], r["dscale"]


def flash_biased_bwd_dkv_plain(q, k, v, mask, bias, do, lse1, lse2, delta2,
                               delta1, metric: str, scale=None,
                               dropout_rate: float = 0.0, seeds=None,
                               bf16: bool = False):
    """What B7b computes: (dk, dv) given B6's delta1; its bf16 form with
    ``bf16``."""
    r = _biased_bwd_plain(q, k, v, mask, bias, do, lse1, lse2, delta2, metric,
                          scale, dropout_rate, seeds, delta1,
                          parts=("dkv",), bf16=bf16)
    return r["dk"], r["dv"]


def _clip_grad(x: torch.Tensor) -> torch.Tensor:
    """d clip(x, -1, 1)/dx with JAX's tie rule: 0.5 at exactly +-1."""
    one, half, zero = (torch.tensor(c, dtype=x.dtype, device=x.device)
                       for c in (1.0, 0.5, 0.0))
    hi = torch.where(x > 1.0, zero, torch.where(x == 1.0, half, one))
    lo = torch.where(x < -1.0, zero, torch.where(x == -1.0, half, one))
    return hi * lo


def _chain_weight(metric: str, ds, s, sq, qk, scale, true_d: int):
    """The chain weight W of each pair from ds = dL/ds: dq_i = sum_j W_ij
    k_j and dk_j = sum_i W_ij q_i; the squared-distance metrics also
    subtract (sum_j W_ij) q_i and (sum_i W_ij) k_j, since there W =
    -2 dL/dsq (the TPU kernel's ``_chain_dq``/``_chain_dk`` and
    ``_dsq_from_ds``, with the clamp max(sq, 0) as the identity)."""
    if metric == "scaled_dot_product":
        return ds / math.sqrt(true_d)
    if metric == "dot_product":
        return ds
    if metric in _COSINE:
        return ds * _clip_grad(qk)
    if metric == "squared_euclidean":
        return 2.0 * ds
    if metric == "euclidean":
        return ds * torch.rsqrt(sq + 1e-8)
    if metric == "gaussian_kernel":
        return ds * s / (scale * scale)
    if metric == "rbf_kernel":
        return 2.0 * ds * scale * s
    raise NotImplementedError(metric)


def _chain_operand(metric: str, ds, s, sq, qk, scale, true_d: int):
    """(u, c): the chain weight written W = u / c, with u the quantity
    the TPU kernels round at bf16 before their dq and dk products
    (``_chain_dq``/``_chain_dk``: ds for the dot metrics, ds clip'(qk)
    for cosine, dL/dsq by ``_dsq_from_ds`` for the squared distances) and
    c = 1, sqrt(d) or -1/2, applied after the product as they apply it."""
    if metric == "dot_product":
        return ds, 1.0
    if metric == "scaled_dot_product":
        return ds, math.sqrt(true_d)
    if metric in _COSINE:
        return ds * _clip_grad(qk), 1.0
    if metric == "squared_euclidean":
        return -ds, -0.5
    if metric == "euclidean":
        return ds * (-0.5 * torch.rsqrt(sq + 1e-8)), -0.5
    if metric == "gaussian_kernel":
        return ds * s * (-1.0 / (2.0 * scale * scale)), -0.5
    if metric == "rbf_kernel":
        return ds * (-scale * s), -0.5
    raise NotImplementedError(metric)


def _pair_grads(metric, s, sq, qk, valid, lse, dp, delta, keep, inv_keep,
                scale, true_d: int):
    """The backward's recompute of a block of pairs: p = exp(s - lse) on
    ``valid`` pairs (0 elsewhere), dp and p dropped where ``keep`` (None
    without dropout) is False, ds = p (dp - delta) -> (ds, the chain
    weight W, drop(p))."""
    p = torch.exp(torch.where(valid, s - lse, NEG_INF))
    pd = p
    if keep is not None:
        dp = torch.where(keep, dp * inv_keep, torch.zeros_like(dp))
        pd = torch.where(keep, p * inv_keep, torch.zeros_like(p))
    ds = p * (dp - delta)
    return ds, _chain_weight(metric, ds, s, sq, qk, scale, true_d), pd


def _delta(do, out, dlse):
    """rowsum(do * out), less the lse cotangent ``dlse`` when there is
    one: the backward's per-row term (the TPU package's delta')."""
    delta = (do * out).sum(-1)
    return delta if dlse is None else delta - dlse


def flash_geometric_backward_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor,
    out: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, metric: str,
    scale: Optional[torch.Tensor] = None, dropout_rate: float = 0.0,
    seed: Optional[torch.Tensor] = None, need_dscale: bool = False,
    dlse: Optional[torch.Tensor] = None, bf16: bool = False,
):
    """What the backward kernels compute (the TPU package's
    ``flash_geometric_attention_bwd``), written out over the same row
    chunks as the plain forward: per pair p = exp(s - lse) on the mask,
    dp = drop(do v^T), ds = p (dp - delta) with delta = rowsum(do out)
    (- dlse), then the metric chain (`_chain_weight`) to dq and dk, dv =
    drop(p)^T do, and for gaussian/rbf d(scale) = sum ds s sq / sigma^3
    or -sum ds s sq. Shapes as in `flash_geometric_forward_plain`; do
    like out, dlse like lse. Returns (dq, dk, dv, dscale f32[H] or
    None). Cosine metrics expect q/k already normalised.

    ``bf16``: what the bf16 forms of B2, B3a and B3b compute. The
    products q.k, do.v, dv's and the chain's take bf16 operands, the
    chain's being the quantity the TPU kernels round (`_chain_operand`),
    in their order; norms, sums of W and delta stay float32. p is
    normalised by lse, so no walk order enters."""
    G, H, N, D = q.shape
    if scale is None:
        scale = torch.ones(H, dtype=q.dtype, device=q.device)
    sc = scale.reshape(1, H, 1, 1)
    thresh = _keep_thresh(dropout_rate)
    inv_keep = 1.0 / (1.0 - dropout_rate) if dropout_rate > 0 else 1.0
    delta = _delta(do, out, dlse)
    sq_metric = metric in _SQ_METRICS
    dq = torch.empty_like(q)
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    wcol = torch.zeros(G, H, N, dtype=q.dtype, device=q.device)
    dsc = torch.zeros(H, dtype=q.dtype, device=q.device)
    for r0 in range(0, N, _ROW_CHUNK):
        r1 = min(N, r0 + _ROW_CHUNK)
        qc, doc = q[:, :, r0:r1], do[:, :, r0:r1]
        qk, sq = _qk_sq(metric, qc, k, bf16)
        s = _scores_from(metric, qk, sq, sc, D)
        keep = None
        if dropout_rate > 0.0:
            keep = _keep_rows(seed, H, r0, r1, N, q.device) < thresh
        ds, w, pd = _pair_grads(
            metric, s, sq, qk, mask[:, None, r0:r1, :] != 0,
            lse[:, :, r0:r1, None], _mm(doc, v.transpose(-1, -2), bf16),
            delta[:, :, r0:r1, None], keep, inv_keep, sc, D)
        u, c = _chain_operand(metric, ds, s, sq, qk, sc, D) if bf16 \
            else (w, 1.0)
        dqc = _mm(u, k, bf16) / c
        dkc = _mm(u.transpose(-1, -2), qc, bf16) / c
        if sq_metric:
            dqc = dqc - w.sum(-1, keepdim=True) * qc
            wcol += w.sum(-2)
        dq[:, :, r0:r1] = dqc
        dk += dkc
        dv += _mm(pd.transpose(-1, -2), doc, bf16)
        if need_dscale:
            dsc += (ds * s * sq).sum((0, 2, 3))
    if sq_metric:
        dk -= wcol[..., None] * k
    dscale = None
    if need_dscale:
        dscale = dsc / scale ** 3 if metric == "gaussian_kernel" else -dsc
    return dq, dk, dv, dscale


def _compact_grads(steps, q, k, v, do, n_i, metric, scale, need_dscale,
                   parts=("dq", "dkv"), bf16=False):
    """The gradients of a compact walk, every row tile at once, from
    ``steps``: per walk step (jb, ds, w, pd, s, sq, qk), the key tiles
    [G, n_i] and, per pair [G, H, n_i, BM, BN], ds = dL/ds, its chain
    weight w, the dropped weight pd that multiplies dO into dv, the
    scores, squared distances and cross terms. dq accumulates per row
    tile; dk and dv go back to their key tiles by index (`index_add_`),
    so the transposed walk is not read. ``parts`` picks "dq" (with
    dscale) and "dkv". ``bf16``: the chain's and dv's products take bf16
    operands, the chain's being the quantity the TPU kernels round
    (`_chain_operand`), as in `flash_geometric_backward_plain`; the sums
    of w stay float32. Returns a dict."""
    G, H, N, D = q.shape
    Dv = v.shape[-1]
    qt, dot = _row_tiles(q, n_i), _row_tiles(do, n_i)
    kt = _key_tiles(k, n_i * BLOCK_M)
    n_t = kt.shape[2]
    sq_metric = metric in _SQ_METRICS
    dq = torch.zeros_like(qt)
    wrow = torch.zeros(qt.shape[:-1], dtype=q.dtype, device=q.device)
    dsc = torch.zeros(H, dtype=q.dtype, device=q.device)
    # key-side sums per (g, key tile), flat so that index_add_ can take
    # each step's [G * n_i] tiles at once
    dk = torch.zeros((G * n_t, H, BLOCK_N, D), dtype=q.dtype, device=q.device)
    dv = torch.zeros((G * n_t, H, BLOCK_N, Dv), dtype=q.dtype,
                     device=q.device)
    wcol = torch.zeros((G * n_t, H, BLOCK_N), dtype=q.dtype, device=q.device)
    gi = torch.arange(G, device=q.device)[:, None]

    def to_keys(x):                 # [G, H, n_i, BN, ...] -> [G * n_i, H, ...]
        return x.transpose(1, 2).reshape(G * n_i, H, *x.shape[3:])
    sc = scale.reshape(1, H, 1, 1, 1)
    for jb, ds, w, pd, s, sq, qk in steps:
        u, c = _chain_operand(metric, ds, s, sq, qk, sc, D) if bf16 \
            else (w, 1.0)
        if "dq" in parts:
            dq += _mm(u, _gather_tiles(kt, jb), bf16) / c
            if sq_metric:
                wrow += w.sum(-1)
            if need_dscale:
                dsc += (ds * s * sq).sum((0, 2, 3, 4))
        if "dkv" in parts:
            idx = (gi * n_t + jb).reshape(-1)
            dk.index_add_(0, idx, to_keys(
                _mm(u.transpose(-1, -2), qt, bf16) / c))
            dv.index_add_(0, idx, to_keys(
                _mm(pd.transpose(-1, -2), dot, bf16)))
            if sq_metric:
                wcol.index_add_(0, idx, to_keys(w.sum(-2)))
    res = {}
    if "dq" in parts:
        if sq_metric:
            dq -= wrow[..., None] * qt
        res["dq"] = dq.reshape(G, H, -1, D)[:, :, :N]
        res["dscale"] = None
        if need_dscale:
            res["dscale"] = dsc / scale ** 3 \
                if metric == "gaussian_kernel" else -dsc
    if "dkv" in parts:
        def from_keys(x):           # [G * n_t, H, BN, ...] -> [G, H, N, ...]
            x = x.reshape(G, n_t, H, *x.shape[2:]).transpose(1, 2)
            return x.reshape(G, H, n_t * BLOCK_N, *x.shape[4:])[:, :, :N]
        res["dk"], res["dv"] = from_keys(dk), from_keys(dv)
        if sq_metric:
            res["dk"] = res["dk"] - from_keys(wcol)[..., None] * k
    return res


def flash_geometric_backward_compact_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, store: torch.Tensor,
    out: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
    jlist: torch.Tensor, jcount: torch.Tensor, jslot: torch.Tensor,
    metric: str, scale: Optional[torch.Tensor] = None,
    dropout_rate: float = 0.0, seed: Optional[torch.Tensor] = None,
    need_dscale: bool = False, dlse: Optional[torch.Tensor] = None,
    bf16: bool = False,
):
    """What B3a c and B3b c compute: `flash_geometric_backward_plain`
    over the compact store, walking the forward walk's occupied tiles
    with the gathers of `flash_geometric_forward_compact_plain`, every
    row tile at once, in memory that grows with the row tiles, never
    with N^2 (`_compact_grads`: the transposed walk is not read). Shapes
    as in `flash_geometric_forward_compact_plain`; do like out, dlse (the
    cotangent of lse) like lse. Returns (dq, dk, dv, dscale f32[H] or
    None). ``bf16``: what their bf16 forms compute, the products rounded
    as in `flash_geometric_backward_plain`'s (p is normalised by lse, so
    no walk order enters)."""
    H, D = q.shape[1], q.shape[-1]
    if scale is None:
        scale = torch.ones(H, dtype=q.dtype, device=q.device)
    sc = scale.reshape(1, H, 1, 1, 1)
    thresh = _keep_thresh(dropout_rate)
    inv_keep = 1.0 / (1.0 - dropout_rate) if dropout_rate > 0 else 1.0
    n_i = jlist.shape[-2]
    dot = _row_tiles(do, n_i)
    lse_t = _row_tiles(lse, n_i, LSE_DEAD)[..., None]
    delta_t = _row_tiles(_delta(do, out, dlse), n_i)[..., None]
    vt = _key_tiles(v, n_i * BLOCK_M)

    def steps():
        for s, valid, jb, rows, cols, qk, sq in _compact_steps(
                q, k, store, jlist, jcount, jslot, metric, scale, bf16):
            keep = None
            if dropout_rate > 0.0:
                keep = _tile_keep(seed, H, rows, cols) < thresh
            ds, w, pd = _pair_grads(
                metric, s, sq, qk, valid, lse_t,
                _mm(dot, _gather_tiles(vt, jb).transpose(-1, -2), bf16),
                delta_t, keep, inv_keep, sc, D)
            yield jb, ds, w, pd, s, sq, qk
    r = _compact_grads(steps(), q, k, v, do, n_i, metric, scale, need_dscale,
                       bf16=bf16)
    return r["dq"], r["dk"], r["dv"], r["dscale"]


def _biased_compact_steps(q, k, v, store, bias_store, do, lse1, lse2, delta2,
                          jlist, jcount, jslot, metric, scale, dropout_rate,
                          seeds, bf16=False):
    """`_biased_chunks`' recompute over the compact walk, every row tile
    at once: per step w, (jb, w1, dw1, dz, w2d, s, sq, qk) [G, H, n_i,
    BM, BN] (jb [G, n_i] the key tiles), the bias read from the step's
    slot of ``bias_store``; all 0 off the valid pairs. q.k and do v^T
    take bf16 operands with ``bf16``."""
    G, H = q.shape[:2]
    n_i = jlist.shape[-2]
    thresh = _keep_thresh(dropout_rate)
    inv_keep = 1.0 / (1.0 - dropout_rate) if dropout_rate > 0 else 1.0
    dot = _row_tiles(do, n_i)
    l1, l2 = (_row_tiles(x, n_i, LSE_DEAD)[..., None] for x in (lse1, lse2))
    d2 = _row_tiles(delta2, n_i)[..., None]
    vt = _key_tiles(v, n_i * BLOCK_M)
    gi = torch.arange(G, device=q.device)[:, None]
    for w, (s, valid, jb, rows, cols, qk, sq) in enumerate(_compact_steps(
            q, k, store, jlist, jcount, jslot, metric, scale, bf16)):
        w1 = torch.exp(torch.where(valid, s - l1, NEG_INF))
        dp2 = _mm(dot, _gather_tiles(vt, jb).transpose(-1, -2), bf16)
        w1d = w1
        if dropout_rate > 0.0:
            keep1 = _tile_keep(seeds[:, 0], H, rows, cols) < thresh
            keep2 = _tile_keep(seeds[:, 1], H, rows, cols) < thresh
            w1d = torch.where(keep1, w1 * inv_keep, torch.zeros_like(w1))
            dp2 = torch.where(keep2, dp2 * inv_keep, torch.zeros_like(dp2))
        z = w1d + bias_store[gi, jslot[..., w].long()][:, None]
        w2 = torch.exp(torch.where(valid, z - l2, NEG_INF))
        dz = w2 * (dp2 - d2)
        dw1, w2d = dz, w2
        if dropout_rate > 0.0:
            dw1 = torch.where(keep1, dz * inv_keep, torch.zeros_like(dz))
            w2d = torch.where(keep2, w2 * inv_keep, torch.zeros_like(w2))
        yield jb, w1, dw1, dz, w2d, s, sq, qk


def _biased_bwd_compact_plain(q, k, v, store, bias_store, do, lse1, lse2,
                              delta2, jlist, jcount, jslot, metric, scale,
                              dropout_rate, seeds, delta1=None,
                              need_dscale=False, parts=("pre", "dq", "dkv"),
                              bf16=False):
    """The plain biased backward over the compact walk, in memory that
    grows with the row tiles; ``parts`` and ``bf16`` as in
    `_biased_bwd_plain`. "pre" walks once for delta1 (the walk's own row
    sums) and dB, into the store's slots [G, S, BM, BN] (0 in slots no
    step walks); dq and dk/dv walk again (`_compact_grads`) with
    ``delta1`` as given, as in B7a c and B7b c, or with the first walk's
    when it is None. Returns a dict."""
    G, H, N, D = q.shape
    if scale is None:
        scale = torch.ones(H, dtype=q.dtype, device=q.device)
    if seeds is None:
        seeds = torch.zeros((G, 2), dtype=torch.int32, device=q.device)
    args = (q, k, v, store, bias_store, do, lse1, lse2, delta2, jlist,
            jcount, jslot, metric, scale, dropout_rate, seeds)
    n_i, S = jlist.shape[-2], bias_store.shape[1]
    gi = torch.arange(G, device=q.device)[:, None]
    grads = [p for p in parts if p != "pre"]
    if not grads:
        d1 = torch.zeros((G, H, n_i, BLOCK_M), dtype=q.dtype, device=q.device)
        dbias = torch.zeros((G * S, BLOCK_M, BLOCK_N), dtype=q.dtype,
                            device=q.device)
        for w, (_, w1, dw1, dz, *_) in enumerate(
                _biased_compact_steps(*args, bf16)):
            d1 += (w1 * dw1).sum(-1)
            # each occupied tile has one slot, walked once; a step past
            # jcount adds its zeros to a slot in range
            dbias.index_add_(0, (gi * S + jslot[..., w].long()).reshape(-1),
                             dz.sum(1).reshape(G * n_i, BLOCK_M, BLOCK_N))
        return {"delta1": d1.reshape(G, H, -1)[..., :N],
                "dbias": dbias.reshape(G, S, BLOCK_M, BLOCK_N)}
    res = {}
    if "pre" in parts or delta1 is None:
        res = _biased_bwd_compact_plain(*args, parts=("pre",), bf16=bf16)
        if delta1 is None:
            delta1 = res["delta1"]
        if "pre" not in parts:
            res = {}
    sc = scale.reshape(1, H, 1, 1, 1)
    d1_t = _row_tiles(delta1, n_i)[..., None]

    def steps():
        for jb, w1, dw1, _, w2d, s, sq, qk in _biased_compact_steps(*args,
                                                                    bf16):
            ds = w1 * (dw1 - d1_t)
            yield jb, ds, _chain_weight(metric, ds, s, sq, qk, sc, D), w2d, \
                s, sq, qk
    return {**res, **_compact_grads(steps(), q, k, v, do, n_i, metric, scale,
                                    need_dscale, grads, bf16)}


def flash_biased_backward_compact_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, store: torch.Tensor,
    bias_store: torch.Tensor, out: torch.Tensor, lse1: torch.Tensor,
    lse2: torch.Tensor, do: torch.Tensor, jlist: torch.Tensor,
    jcount: torch.Tensor, jslot: torch.Tensor, metric: str,
    scale: Optional[torch.Tensor] = None, dropout_rate: float = 0.0,
    seeds: Optional[torch.Tensor] = None, need_dscale: bool = False,
    bf16: bool = False,
):
    """What B6c, B7a c and B7b c compute together:
    `flash_biased_backward_plain` over the compact store, walking the
    forward walk's occupied tiles with the gathers of
    `flash_biased_forward_compact_plain`, every row tile at once, in
    memory that grows with the row tiles, never with N^2 (a first walk
    for delta1 and dB, a second for dq, dk and dv). bias_store and the
    returned dB are f32[G, S, BM, BN] in the store's slots, dB 0 in slots
    the walk does not visit; the other shapes as in
    `flash_biased_forward_compact_plain`, out and do like its out.
    Returns (dq, dk, dv, dB, dscale f32[H] or None). ``bf16``: what their
    bf16 forms compute, the products rounded as in
    `flash_biased_backward_plain`'s (w1 and w2 are normalised by lse1
    and lse2, so no walk order enters)."""
    r = _biased_bwd_compact_plain(
        q, k, v, store, bias_store, do, lse1, lse2, (do * out).sum(-1),
        jlist, jcount, jslot, metric, scale, dropout_rate, seeds,
        need_dscale=need_dscale, bf16=bf16)
    return r["dq"], r["dk"], r["dv"], r["dbias"], r["dscale"]


def flash_biased_bwd_pre_compact_plain(q, k, v, store, bias_store, do, lse1,
                                       lse2, delta2, jlist, jcount, jslot,
                                       metric: str, scale=None,
                                       dropout_rate: float = 0.0, seeds=None,
                                       bf16: bool = False):
    """What B6c computes (the JAX package's ``_band_bwd_pre``): (delta1
    f32[G, H, N], dB f32[G, S, BM, BN]) given lse1, lse2 and delta2
    [G, H, N] (the hybrid band's union statistics); its bf16 form with
    ``bf16``."""
    r = _biased_bwd_compact_plain(q, k, v, store, bias_store, do, lse1, lse2,
                                  delta2, jlist, jcount, jslot, metric, scale,
                                  dropout_rate, seeds, parts=("pre",),
                                  bf16=bf16)
    return r["delta1"], r["dbias"]


def flash_biased_bwd_dq_compact_plain(q, k, v, store, bias_store, do, lse1,
                                      lse2, delta2, delta1, jlist, jcount,
                                      jslot, metric: str, scale=None,
                                      dropout_rate: float = 0.0, seeds=None,
                                      need_dscale: bool = False,
                                      bf16: bool = False):
    """What B7a c computes (walk B of the JAX package's
    ``_band_bwd_dq_dkv``): (dq, dscale f32[H] or None) given delta1 (the
    union's); its bf16 form with ``bf16``."""
    r = _biased_bwd_compact_plain(q, k, v, store, bias_store, do, lse1, lse2,
                                  delta2, jlist, jcount, jslot, metric, scale,
                                  dropout_rate, seeds, delta1, need_dscale,
                                  ("dq",), bf16)
    return r["dq"], r["dscale"]


def flash_biased_bwd_dkv_compact_plain(q, k, v, store, bias_store, do, lse1,
                                       lse2, delta2, delta1, jlist, jcount,
                                       jslot, metric: str, scale=None,
                                       dropout_rate: float = 0.0, seeds=None,
                                       bf16: bool = False):
    """What B7b c computes (walk C of ``_band_bwd_dq_dkv``): (dk, dv)
    given delta1, over the forward walk (the transposed walk that B7b c
    takes visits the same tiles); its bf16 form with ``bf16``."""
    r = _biased_bwd_compact_plain(q, k, v, store, bias_store, do, lse1, lse2,
                                  delta2, jlist, jcount, jslot, metric, scale,
                                  dropout_rate, seeds, delta1,
                                  parts=("dkv",), bf16=bf16)
    return r["dk"], r["dv"]


# ---------------------------------------------------------------------------
# The CUDA kernels (csrc/): ctypes wrappers with launch counts
# ---------------------------------------------------------------------------

_P, _I, _F, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint


def _check_args(name: str, dev: torch.device, specs) -> None:
    """Raise ValueError unless each (label, tensor, dtype or None, shape)
    lies on ``dev`` with that dtype and shape and is contiguous."""
    for label, t, dtype, shape in specs:
        if t.device != dev:
            raise ValueError(f"{name}: {label} on {t.device}, q on {dev}")
        if dtype is not None and t.dtype != dtype:
            raise ValueError(f"{name}: {label} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: {label} shape {tuple(t.shape)} != "
                             f"{tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")


class _CudaKernel:
    """One C entry point of ``csrc/<source>.cu``, loaded at first call.
    ``launches`` counts the launches it made. Subclasses check devices,
    dtypes and shapes but trust the plan's values: pass plans from the
    builders here or through `check_plan`."""
    name = source = symbol = ""
    argtypes: Tuple = ()

    def __init__(self):
        self.launches = 0
        self._fn = None

    def _function(self):
        if self._fn is None:
            fn = getattr(build.load(self.source), self.symbol)
            fn.argtypes = list(self.argtypes) + [_P]      # + the stream
            fn.restype = _I
            self._fn = fn
        return self._fn

    def _launch(self, dev: torch.device, *args, stream=None) -> None:
        """Launch on ``stream`` (a ``torch.cuda.Stream`` of ``dev``), by
        default the current stream of ``dev``."""
        with torch.cuda.device(dev):
            if stream is None:
                stream = torch.cuda.current_stream(dev)
            err = self._function()(*args, stream.cuda_stream)
        if err != 0:
            raise RuntimeError(f"{self.name}: CUDA launch failed with "
                               f"cudaError {err}")
        self.launches += 1

    @staticmethod
    def _device_of(name: str, q: torch.Tensor) -> torch.device:
        if q.device.type != "cuda":
            raise ValueError(f"{name}: tensors must be on CUDA, got {q.device}")
        return q.device

    @staticmethod
    def _check_dims(name: str, mask: torch.Tensor, D: int, Dv: int) -> None:
        if mask.dtype not in (torch.int8, torch.uint8, torch.bool):
            raise ValueError(f"{name}: mask must be int8/uint8/bool")
        _check_widths(name, D, Dv)


def _check_widths(name: str, D: int, Dv: int) -> None:
    if not (1 <= D <= 128 and 1 <= Dv <= 128):
        raise ValueError(f"{name}: needs 1 <= D, Dv <= 128, "
                         f"got D={D}, Dv={Dv}")


def _dropout_args(dropout_rate: float):
    """(use_dropout, keep threshold, 1 / keep) for the kernels."""
    inv_keep = 1.0 / (1.0 - dropout_rate) if dropout_rate > 0 else 1.0
    return int(dropout_rate > 0.0), _keep_thresh(dropout_rate), inv_keep


class _FlashForwardKernel(_CudaKernel):
    """B1, ``tagan_flash_geometric_fwd``: (out, lse) of the forward walk,
    as a pair walk that reads each mask tile once for all heads and
    computes only its valid pairs (csrc/flash_pairwalk_fwd.cu)."""
    name = "flash_geometric_fwd"
    source = "flash_pairwalk_fwd"
    symbol = "tagan_flash_geometric_fwd"
    argtypes = (_P,) * 10 + (_I,) * 8 + (_F, _I, _U, _F)

    def __call__(self, q, k, v, mask, jlist, jcount, metric: str,
                 scale: torch.Tensor, seed: torch.Tensor,
                 dropout_rate: float) -> Tuple[torch.Tensor, torch.Tensor]:
        G, H, N, D = q.shape
        Dv = v.shape[-1]
        n_i = -(-N // BLOCK_M)
        dev = self._device_of(self.name, q)
        _check_args(self.name, dev, (
            ("q", q, torch.float32, (G, H, N, D)),
            ("k", k, torch.float32, (G, H, N, D)),
            ("v", v, torch.float32, (G, H, N, Dv)),
            ("mask", mask, None, (G, N, N)),
            ("jlist", jlist, torch.int32, (G, n_i, jlist.shape[-1])),
            ("jcount", jcount, torch.int32, (G, n_i)),
            ("scale", scale, torch.float32, (H,)),
            ("seed", seed, torch.int32, (G,))))
        self._check_dims(self.name, mask, D, Dv)
        out = torch.empty((G, H, N, Dv), dtype=torch.float32, device=dev)
        lse = torch.empty((G, H, N), dtype=torch.float32, device=dev)
        self._launch(
            dev, q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
            jlist.data_ptr(), jcount.data_ptr(), scale.data_ptr(),
            seed.data_ptr(), out.data_ptr(), lse.data_ptr(),
            G, H, N, D, Dv, n_i, jlist.shape[-1], MXU_METRICS.index(metric),
            math.sqrt(D), *_dropout_args(dropout_rate))
        return out, lse


class _FlashBackwardKernel(_CudaKernel):
    """Shared checks of the backward kernels B2, B3a and B3b: q, k
    [G, H, N, D], v, do [G, H, N, Dv], lse and delta [G, H, N], the walk
    (lst, cnt) [G, ceil(N/64), W] and [G, ceil(N/64)], scale f32[H],
    seed i32[G]."""

    def _check(self, q, k, v, mask, do, lse, delta, lst, cnt, scale, seed):
        G, H, N, D = q.shape
        Dv = v.shape[-1]
        n = -(-N // BLOCK_M)
        dev = self._device_of(self.name, q)
        _check_args(self.name, dev, (
            ("q", q, torch.float32, (G, H, N, D)),
            ("k", k, torch.float32, (G, H, N, D)),
            ("v", v, torch.float32, (G, H, N, Dv)),
            ("mask", mask, None, (G, N, N)),
            ("do", do, torch.float32, (G, H, N, Dv)),
            ("lse", lse, torch.float32, (G, H, N)),
            ("delta", delta, torch.float32, (G, H, N)),
            ("plan list", lst, torch.int32, (G, n, lst.shape[-1])),
            ("plan count", cnt, torch.int32, (G, n)),
            ("scale", scale, torch.float32, (H,)),
            ("seed", seed, torch.int32, (G,))))
        self._check_dims(self.name, mask, D, Dv)
        return dev, (G, H, N, D, Dv, n, lst.shape[-1])

    @staticmethod
    def _inputs(q, k, v, mask, do, lse, delta, lst, cnt, scale, seed):
        return tuple(t.data_ptr() for t in (q, k, v, mask, do, lse, delta,
                                            lst, cnt, scale, seed))


class _FlashBwdDqKernel(_FlashBackwardKernel):
    """B3a, ``tagan_flash_geometric_bwd_dq``: dq (and dscale) over the
    forward walk (jlist, jcount), as a row pair walk: a warp owns up to 32
    (row, head) items of a row tile, reads each walked mask tile once for
    its heads, lists each row's keys and computes only the mask's valid
    pairs (csrc/flash_pairwalk_two_walk.cu). Every row of dq is written
    (dead rows and rows with an empty walk: 0), and with ``need_dscale``
    each item's d(scale) term [G, H, N], which the wrapper sums.
    Deterministic: no atomics."""
    name = "flash_geometric_bwd_dq"
    source = "flash_pairwalk_two_walk"
    symbol = "tagan_flash_geometric_bwd_dq"
    argtypes = (_P,) * 13 + (_I,) * 8 + (_F, _I, _U, _F, _I)

    def __call__(self, q, k, v, mask, do, lse, delta, jlist, jcount,
                 metric: str, scale, seed, dropout_rate: float,
                 need_dscale: bool):
        args = (q, k, v, mask, do, lse, delta, jlist, jcount, scale, seed)
        dev, (G, H, N, D, Dv, n_i, W) = self._check(*args)
        dq = torch.empty((G, H, N, D), dtype=torch.float32, device=dev)
        part = torch.empty((G, H, N) if need_dscale else (1,),
                           dtype=torch.float32, device=dev)
        self._launch(dev, *self._inputs(*args), dq.data_ptr(),
                     part.data_ptr(), G, H, N, D, Dv, n_i, W,
                     MXU_METRICS.index(metric), math.sqrt(D),
                     *_dropout_args(dropout_rate), int(need_dscale))
        return dq, (part.sum((0, 2)) if need_dscale else None)


class _FlashBwdDkvKernel(_FlashBackwardKernel):
    """B3b, ``tagan_flash_geometric_bwd_dkv``: dk and dv over the
    transposed walk (ilist, icount), as a key pair walk: a block owns up
    to 64 keys of a key tile for up to 8 heads, copies each walked mask
    tile whole, lists each key's rows and computes only the mask's valid
    pairs (csrc/flash_pairwalk_two_walk.cu). Every entry of dk and dv is
    written (keys no row reaches: 0). Deterministic: no atomics."""
    name = "flash_geometric_bwd_dkv"
    source = "flash_pairwalk_two_walk"
    symbol = "tagan_flash_geometric_bwd_dkv"
    argtypes = (_P,) * 13 + (_I,) * 8 + (_F, _I, _U, _F)

    def __call__(self, q, k, v, mask, do, lse, delta, ilist, icount,
                 metric: str, scale, seed, dropout_rate: float):
        args = (q, k, v, mask, do, lse, delta, ilist, icount, scale, seed)
        dev, (G, H, N, D, Dv, n_j, W) = self._check(*args)
        dk = torch.empty((G, H, N, D), dtype=torch.float32, device=dev)
        dv = torch.empty((G, H, N, Dv), dtype=torch.float32, device=dev)
        self._launch(dev, *self._inputs(*args), dk.data_ptr(), dv.data_ptr(),
                     G, H, N, D, Dv, n_j, W, MXU_METRICS.index(metric),
                     math.sqrt(D), *_dropout_args(dropout_rate))
        return dk, dv


class _FlashBwdFusedKernel(_FlashBackwardKernel):
    """B2, ``tagan_flash_geometric_bwd_fused``: dq, dk, dv (and dscale)
    as a pair walk over the forward plan (jlist, jcount) that reads each
    mask tile once for all heads and computes only its valid pairs
    (csrc/flash_pairwalk_bwd.cu). dq is written by the lane that owns its
    row; dk, dv and dscale are summed with atomics, so their last bits
    vary from run to run."""
    name = "flash_geometric_bwd_fused"
    source = "flash_pairwalk_bwd"
    symbol = "tagan_flash_geometric_bwd_fused"
    argtypes = (_P,) * 15 + (_I,) * 8 + (_F, _I, _U, _F, _I)

    def __call__(self, q, k, v, mask, do, lse, delta, jlist, jcount,
                 metric: str, scale, seed, dropout_rate: float,
                 need_dscale: bool):
        args = (q, k, v, mask, do, lse, delta, jlist, jcount, scale, seed)
        dev, (G, H, N, D, Dv, n_i, W) = self._check(*args)
        dq = torch.empty((G, H, N, D), dtype=torch.float32, device=dev)
        dk = torch.zeros((G, H, N, D), dtype=torch.float32, device=dev)
        dv = torch.zeros((G, H, N, Dv), dtype=torch.float32, device=dev)
        part = torch.zeros((G, H) if need_dscale else (1,),
                           dtype=torch.float32, device=dev)
        self._launch(dev, *self._inputs(*args), dq.data_ptr(), dk.data_ptr(),
                     dv.data_ptr(), part.data_ptr(), G, H, N, D, Dv, n_i, W,
                     MXU_METRICS.index(metric), math.sqrt(D),
                     *_dropout_args(dropout_rate), int(need_dscale))
        return dq, dk, dv, (part.sum(0) if need_dscale else None)


class _FlashForwardBf16Kernel(_FlashForwardKernel):
    """B1's bf16 form, ``tagan_flash_geometric_fwd_bf16``: B1 with bf16
    dot operands (the TPU kernel's ``bf16=True``), the same pair walk."""
    name = "flash_geometric_fwd_bf16"
    symbol = "tagan_flash_geometric_fwd_bf16"


class _FlashBwdFusedBf16Kernel(_FlashBwdFusedKernel):
    """B2's bf16 form, ``tagan_flash_geometric_bwd_fused_bf16``: B2 with
    bf16 product operands, the same pair walk over the forward plan."""
    name = "flash_geometric_bwd_fused_bf16"
    symbol = "tagan_flash_geometric_bwd_fused_bf16"


class _FlashBwdDqBf16Kernel(_FlashBwdDqKernel):
    """B3a's bf16 form, ``tagan_flash_geometric_bwd_dq_bf16``: B3a with
    bf16 product operands, the same row pair walk."""
    name = "flash_geometric_bwd_dq_bf16"
    symbol = "tagan_flash_geometric_bwd_dq_bf16"


class _FlashBwdDkvBf16Kernel(_FlashBwdDkvKernel):
    """B3b's bf16 form, ``tagan_flash_geometric_bwd_dkv_bf16``: B3b with
    bf16 product operands, the same key pair walk."""
    name = "flash_geometric_bwd_dkv_bf16"
    symbol = "tagan_flash_geometric_bwd_dkv_bf16"


def _check_walk(name, dev, q, mask, jlist, jcount):
    """The checks B4 and B5 share: q [G, H, N, D] fp32 and the forward
    walk at the kernel's tile; returns (G, H, N, D, n_i, W)."""
    G, H, N, D = q.shape
    n_i = -(-N // BLOCK_M)
    _check_args(name, dev, (
        ("q", q, torch.float32, (G, H, N, D)),
        ("mask", mask, None, (G, N, N)),
        ("jlist", jlist, torch.int32, (G, n_i, jlist.shape[-1])),
        ("jcount", jcount, torch.int32, (G, n_i))))
    return G, H, N, D, n_i, jlist.shape[-1]


class _FlashLse1Kernel(_CudaKernel):
    """B4, ``tagan_flash_lse1``: lse1 [G, H, N] of the forward walk, as
    B1's pair walk (csrc/flash_pairwalk_fwd.cu) keeping only the running
    max and sum."""
    name = "flash_lse1"
    source = "flash_pairwalk_fwd"
    symbol = "tagan_flash_lse1"
    argtypes = (_P,) * 7 + (_I,) * 7 + (_F,)

    def __call__(self, q, k, mask, jlist, jcount, metric: str,
                 scale: torch.Tensor) -> torch.Tensor:
        dev = self._device_of(self.name, q)
        G, H, N, D, n_i, W = _check_walk(self.name, dev, q, mask, jlist,
                                         jcount)
        _check_args(self.name, dev, (
            ("k", k, torch.float32, (G, H, N, D)),
            ("scale", scale, torch.float32, (H,))))
        self._check_dims(self.name, mask, D, 1)
        lse1 = torch.empty((G, H, N), dtype=torch.float32, device=dev)
        self._launch(dev, q.data_ptr(), k.data_ptr(), mask.data_ptr(),
                     jlist.data_ptr(), jcount.data_ptr(), scale.data_ptr(),
                     lse1.data_ptr(), G, H, N, D, n_i, W,
                     MXU_METRICS.index(metric), math.sqrt(D))
        return lse1


class _FlashBiasedKernel(_CudaKernel):
    """B5, ``tagan_flash_biased_fwd``: (out, lse2) of the second softmax
    over z = drop1(exp(s - lse1)) + bias, as B1's pair walk
    (csrc/flash_pairwalk_fwd.cu), which reads the bias at the valid pairs
    only; lse1 is an input."""
    name = "flash_biased_fwd"
    source = "flash_pairwalk_fwd"
    symbol = "tagan_flash_biased_fwd"
    argtypes = (_P,) * 12 + (_I,) * 8 + (_F, _I, _U, _F)

    def __call__(self, q, k, v, mask, bias, lse1, jlist, jcount,
                 metric: str, scale: torch.Tensor, seeds: torch.Tensor,
                 dropout_rate: float) -> Tuple[torch.Tensor, torch.Tensor]:
        dev = self._device_of(self.name, q)
        G, H, N, D, n_i, W = _check_walk(self.name, dev, q, mask, jlist,
                                         jcount)
        Dv = v.shape[-1]
        _check_args(self.name, dev, (
            ("k", k, torch.float32, (G, H, N, D)),
            ("v", v, torch.float32, (G, H, N, Dv)),
            ("bias", bias, torch.float32, (G, N, N)),
            ("lse1", lse1, torch.float32, (G, H, N)),
            ("scale", scale, torch.float32, (H,)),
            ("seeds", seeds, torch.int32, (G, 2))))
        self._check_dims(self.name, mask, D, Dv)
        out = torch.empty((G, H, N, Dv), dtype=torch.float32, device=dev)
        lse2 = torch.empty((G, H, N), dtype=torch.float32, device=dev)
        self._launch(
            dev, q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
            bias.data_ptr(), lse1.data_ptr(), jlist.data_ptr(),
            jcount.data_ptr(), scale.data_ptr(), seeds.data_ptr(),
            out.data_ptr(), lse2.data_ptr(), G, H, N, D, Dv, n_i, W,
            MXU_METRICS.index(metric), math.sqrt(D),
            *_dropout_args(dropout_rate))
        return out, lse2


def _check_compact(name, dev, q, store, jlist, jcount, jslot):
    """The checks B1c, B4c and B5c share: q [G, H, N, D] fp32, the
    store at the kernels' tile (bits i64[G, S, 64] or int8
    [G, S, 64, 64], 16-byte aligned) and the walk at that tile; returns
    (G, H, N, D, n_i, W, S, packed)."""
    G, H, N, D = q.shape
    n_i = -(-N // BLOCK_M)
    packed = store_packed(store)
    if store.dim() != (3 if packed else 4):
        raise ValueError(f"{name}: the store must be [G, S, ...], got "
                         f"{tuple(store.shape)}")
    S, W = store.shape[1], jlist.shape[-1]
    _check_args(name, dev, (
        ("q", q, torch.float32, (G, H, N, D)),
        ("store", store, None, (G, S) + store.shape[2:]),
        ("jlist", jlist, torch.int32, (G, n_i, W)),
        ("jcount", jcount, torch.int32, (G, n_i)),
        ("jslot", jslot, torch.int32, (G, n_i, W))))
    if S < 1 or store.data_ptr() % 16:
        raise ValueError(f"{name}: the store needs a slot and 16-byte "
                         f"alignment")
    return G, H, N, D, n_i, W, S, int(packed)


class _FlashForwardCompactKernel(_CudaKernel):
    """B1c, ``tagan_flash_geometric_fwd_compact``: B1 over the compact
    store, (out, lse). The compact forward pair walk's OUT mode
    (csrc/flash_pairwalk_fwd_compact.cu, B5c's walk): a warp owns up to
    32 (row, head) items of a row tile, reads each walked slot's row words
    once for its heads, lists each row's keys and computes only the
    store's valid pairs. Every row of out and lse is written (dead rows: 0
    and ``LSE_DEAD``). Deterministic: no atomics."""
    name = "flash_geometric_fwd_compact"
    source = "flash_pairwalk_fwd_compact"
    symbol = "tagan_flash_geometric_fwd_compact"
    argtypes = (_P,) * 11 + (_I,) * 10 + (_F, _I, _U, _F)

    def __call__(self, q, k, v, store, jlist, jcount, jslot, metric: str,
                 scale: torch.Tensor, seed: torch.Tensor,
                 dropout_rate: float) -> Tuple[torch.Tensor, torch.Tensor]:
        dev = self._device_of(self.name, q)
        G, H, N, D, n_i, W, S, packed = _check_compact(
            self.name, dev, q, store, jlist, jcount, jslot)
        Dv = v.shape[-1]
        _check_args(self.name, dev, (
            ("k", k, torch.float32, (G, H, N, D)),
            ("v", v, torch.float32, (G, H, N, Dv)),
            ("scale", scale, torch.float32, (H,)),
            ("seed", seed, torch.int32, (G,))))
        _check_widths(self.name, D, Dv)
        out = torch.empty((G, H, N, Dv), dtype=torch.float32, device=dev)
        lse = torch.empty((G, H, N), dtype=torch.float32, device=dev)
        self._launch(dev, *(t.data_ptr() for t in (
            q, k, v, store, jlist, jcount, jslot, scale, seed, out, lse)),
            G, H, N, D, Dv, n_i, W, S, packed, MXU_METRICS.index(metric),
            math.sqrt(D), *_dropout_args(dropout_rate))
        return out, lse


class _FlashLse1CompactKernel(_CudaKernel):
    """B4c, ``tagan_flash_lse1_compact``: B4 over the compact store,
    lse1 [G, H, N]. The compact forward pair walk's LSE mode
    (csrc/flash_pairwalk_fwd_compact.cu, B1c's and B5c's walk): a warp
    owns up to 32 (row, head) items of a row tile, reads each walked
    slot's row words once for its heads, lists each row's keys and
    computes the scores of the store's valid pairs only. Every row of
    lse1 is written (dead rows: ``LSE_DEAD``). Deterministic: no
    atomics."""
    name = "flash_lse1_compact"
    source = "flash_pairwalk_fwd_compact"
    symbol = "tagan_flash_lse1_compact"
    argtypes = (_P,) * 8 + (_I,) * 9 + (_F,)

    def __call__(self, q, k, store, jlist, jcount, jslot, metric: str,
                 scale: torch.Tensor) -> torch.Tensor:
        dev = self._device_of(self.name, q)
        G, H, N, D, n_i, W, S, packed = _check_compact(
            self.name, dev, q, store, jlist, jcount, jslot)
        _check_args(self.name, dev, (
            ("k", k, torch.float32, (G, H, N, D)),
            ("scale", scale, torch.float32, (H,))))
        _check_widths(self.name, D, 1)
        lse1 = torch.empty((G, H, N), dtype=torch.float32, device=dev)
        self._launch(dev, *(t.data_ptr() for t in (
            q, k, store, jlist, jcount, jslot, scale, lse1)),
            G, H, N, D, n_i, W, S, packed, MXU_METRICS.index(metric),
            math.sqrt(D))
        return lse1


class _FlashLse1Bf16Kernel(_FlashLse1Kernel):
    """B4's bf16 form, ``tagan_flash_lse1_bf16``: q.k from bf16
    operands, the same pair walk."""
    name = "flash_lse1_bf16"
    symbol = "tagan_flash_lse1_bf16"


class _FlashBiasedBf16Kernel(_FlashBiasedKernel):
    """B5's bf16 form, ``tagan_flash_biased_fwd_bf16``: q.k and P@V from
    bf16 operands, the same pair walk."""
    name = "flash_biased_fwd_bf16"
    symbol = "tagan_flash_biased_fwd_bf16"


class _FlashBiasedCompactKernel(_CudaKernel):
    """B5c, ``tagan_flash_biased_fwd_compact``: B5 over the compact
    store, the bias in the same slots (f32[G, S, 64, 64]); (out,
    lse2). B5's pair walk over the store's slots, which reads the bias at
    the valid pairs only (csrc/flash_pairwalk_fwd_compact.cu)."""
    name = "flash_biased_fwd_compact"
    source = "flash_pairwalk_fwd_compact"
    symbol = "tagan_flash_biased_fwd_compact"
    argtypes = (_P,) * 13 + (_I,) * 10 + (_F, _I, _U, _F)

    def __call__(self, q, k, v, store, bias_store, lse1, jlist, jcount,
                 jslot, metric: str, scale: torch.Tensor,
                 seeds: torch.Tensor, dropout_rate: float
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        dev = self._device_of(self.name, q)
        G, H, N, D, n_i, W, S, packed = _check_compact(
            self.name, dev, q, store, jlist, jcount, jslot)
        Dv = v.shape[-1]
        _check_args(self.name, dev, (
            ("k", k, torch.float32, (G, H, N, D)),
            ("v", v, torch.float32, (G, H, N, Dv)),
            ("bias", bias_store, torch.float32, (G, S, BLOCK_M, BLOCK_N)),
            ("lse1", lse1, torch.float32, (G, H, N)),
            ("scale", scale, torch.float32, (H,)),
            ("seeds", seeds, torch.int32, (G, 2))))
        _check_widths(self.name, D, Dv)
        out = torch.empty((G, H, N, Dv), dtype=torch.float32, device=dev)
        lse2 = torch.empty((G, H, N), dtype=torch.float32, device=dev)
        self._launch(dev, *(t.data_ptr() for t in (
            q, k, v, store, bias_store, lse1, jlist, jcount, jslot, scale,
            seeds, out, lse2)),
            G, H, N, D, Dv, n_i, W, S, packed, MXU_METRICS.index(metric),
            math.sqrt(D), *_dropout_args(dropout_rate))
        return out, lse2


class _FlashBackwardCompactKernel(_CudaKernel):
    """Shared checks of B3a c and B3b c: `_check_compact`'s on the store
    and the walk (lst, cnt, slot) [G, ceil(N/64), W], the walk's values
    (`check_compact_plan`, one host synchronisation: a bad count or slot
    raises before any launch), and k [G, H, N, D], v, do [G, H, N, Dv],
    lse and delta [G, H, N], scale f32[H], seed i32[G]."""

    def _check(self, q, k, v, store, do, lse, delta, lst, cnt, slot, scale,
               seed):
        dev = self._device_of(self.name, q)
        G, H, N, D, n, W, S, packed = _check_compact(
            self.name, dev, q, store, lst, cnt, slot)
        Dv = v.shape[-1]
        _check_args(self.name, dev, (
            ("k", k, torch.float32, (G, H, N, D)),
            ("v", v, torch.float32, (G, H, N, Dv)),
            ("do", do, torch.float32, (G, H, N, Dv)),
            ("lse", lse, torch.float32, (G, H, N)),
            ("delta", delta, torch.float32, (G, H, N)),
            ("scale", scale, torch.float32, (H,)),
            ("seed", seed, torch.int32, (G,))))
        _check_widths(self.name, D, Dv)
        check_compact_plan(lst, cnt, slot, store, N)
        ptrs = tuple(t.data_ptr() for t in (q, k, v, store, do, lse, delta,
                                            lst, cnt, slot, scale, seed))
        return dev, (G, H, N, D, Dv, n, W, S, packed), ptrs


class _FlashBwdDqCompactKernel(_FlashBackwardCompactKernel):
    """B3a c, ``tagan_flash_geometric_bwd_dq_compact``: B3a over the
    compact store, dq (and dscale) over the forward walk (jlist, jcount,
    jslot), as a row pair walk: a warp owns up to 32 (row, head) items of
    a row tile, reads each walked slot's row words once for its heads,
    lists each row's keys and computes only the store's valid pairs. Every
    row of dq is written (dead rows and rows with an empty walk: 0), and
    with ``need_dscale`` each item's d(scale) term [G, H, N], which the
    wrapper sums. Deterministic: no atomics."""
    name = "flash_geometric_bwd_dq_compact"
    source = "flash_pairwalk_bwd_compact"
    symbol = "tagan_flash_geometric_bwd_dq_compact"
    argtypes = (_P,) * 14 + (_I,) * 10 + (_F, _I, _U, _F, _I)

    def __call__(self, q, k, v, store, do, lse, delta, jlist, jcount, jslot,
                 metric: str, scale, seed, dropout_rate: float,
                 need_dscale: bool):
        dev, (G, H, N, D, Dv, n_i, W, S, packed), ptrs = self._check(
            q, k, v, store, do, lse, delta, jlist, jcount, jslot, scale, seed)
        dq = torch.empty((G, H, N, D), dtype=torch.float32, device=dev)
        part = torch.empty((G, H, N) if need_dscale else (1,),
                           dtype=torch.float32, device=dev)
        self._launch(dev, *ptrs, dq.data_ptr(), part.data_ptr(), G, H, N, D,
                     Dv, n_i, W, S, packed, MXU_METRICS.index(metric),
                     math.sqrt(D), *_dropout_args(dropout_rate),
                     int(need_dscale))
        return dq, (part.sum((0, 2)) if need_dscale else None)


class _FlashBwdDkvCompactKernel(_FlashBackwardCompactKernel):
    """B3b c, ``tagan_flash_geometric_bwd_dkv_compact``: B3b over the
    compact store, dk and dv over the transposed walk (ilist, icount,
    islot), whose slots name the same store tiles (row = query, column =
    key), as a key pair walk: a block owns up to 64 keys of a key tile
    for up to 8 heads, copies each walked slot's row words, lists each
    key's rows and computes only the store's valid pairs. Every entry of
    dk and dv is written (keys no row reaches: 0). Deterministic: no
    atomics."""
    name = "flash_geometric_bwd_dkv_compact"
    source = "flash_pairwalk_bwd_compact"
    symbol = "tagan_flash_geometric_bwd_dkv_compact"
    argtypes = (_P,) * 14 + (_I,) * 10 + (_F, _I, _U, _F)

    def __call__(self, q, k, v, store, do, lse, delta, ilist, icount, islot,
                 metric: str, scale, seed, dropout_rate: float):
        dev, (G, H, N, D, Dv, n_j, W, S, packed), ptrs = self._check(
            q, k, v, store, do, lse, delta, ilist, icount, islot, scale, seed)
        dk = torch.empty((G, H, N, D), dtype=torch.float32, device=dev)
        dv = torch.empty((G, H, N, Dv), dtype=torch.float32, device=dev)
        self._launch(dev, *ptrs, dk.data_ptr(), dv.data_ptr(), G, H, N, D,
                     Dv, n_j, W, S, packed, MXU_METRICS.index(metric),
                     math.sqrt(D), *_dropout_args(dropout_rate))
        return dk, dv


class _FlashForwardCompactBf16Kernel(_FlashForwardCompactKernel):
    """B1c's bf16 form, ``tagan_flash_geometric_fwd_compact_bf16``: the
    same pair walk with bf16 dot operands."""
    name = "flash_geometric_fwd_compact_bf16"
    symbol = "tagan_flash_geometric_fwd_compact_bf16"


class _FlashBwdDqCompactBf16Kernel(_FlashBwdDqCompactKernel):
    """B3a c's bf16 form, ``tagan_flash_geometric_bwd_dq_compact_bf16``:
    the same row pair walk with bf16 operands."""
    name = "flash_geometric_bwd_dq_compact_bf16"
    symbol = "tagan_flash_geometric_bwd_dq_compact_bf16"


class _FlashBwdDkvCompactBf16Kernel(_FlashBwdDkvCompactKernel):
    """B3b c's bf16 form, ``tagan_flash_geometric_bwd_dkv_compact_bf16``:
    the same key pair walk with bf16 operands."""
    name = "flash_geometric_bwd_dkv_compact_bf16"
    symbol = "tagan_flash_geometric_bwd_dkv_compact_bf16"


class _FlashBiasedBackwardKernel(_CudaKernel):
    """Shared checks of the biased backward's two walks: q, k
    [G, H, N, D], v, do [G, H, N, Dv], bias [G, N, N], lse1, lse2, delta2
    (and delta1) [G, H, N], the walk (lst, cnt), scale f32[H], seeds
    i32[G, 2]."""
    source = "flash_pairwalk_biased_bwd"

    def _check(self, q, k, v, mask, bias, do, rows, lst, cnt, scale, seeds):
        dev = self._device_of(self.name, q)
        G, H, N, D, n, W = _check_walk(self.name, dev, q, mask, lst, cnt)
        Dv = v.shape[-1]
        _check_args(self.name, dev, (
            ("k", k, torch.float32, (G, H, N, D)),
            ("v", v, torch.float32, (G, H, N, Dv)),
            ("bias", bias, torch.float32, (G, N, N)),
            ("do", do, torch.float32, (G, H, N, Dv)),
            *((label, t, torch.float32, (G, H, N)) for label, t in rows),
            ("scale", scale, torch.float32, (H,)),
            ("seeds", seeds, torch.int32, (G, 2))))
        self._check_dims(self.name, mask, D, Dv)
        return dev, (G, H, N, D, Dv, n, W)


class _FlashBiasedBwdRowKernel(_FlashBiasedBackwardKernel):
    """B6 and B7a in one kernel, the row walk ``tagan_flash_biased_bwd_row``
    (csrc/flash_pairwalk_biased_bwd.cu): (delta1 [G, H, N], dB [G, N, N],
    dq, dscale or None) over the forward walk (jlist, jcount), a pair walk
    that reads each mask tile once for all heads and computes only its
    valid pairs, twice: delta1 and dB, then dq and dscale on the whole
    delta1. dB is written at the mask's valid pairs only; elsewhere it is
    left unset. No atomics: repeated calls are bit-identical."""
    name = "flash_biased_bwd_row"
    symbol = "tagan_flash_biased_bwd_row"
    argtypes = (_P,) * 17 + (_I,) * 8 + (_F, _I, _U, _F, _I)

    def __call__(self, q, k, v, mask, bias, do, lse1, lse2, delta2, jlist,
                 jcount, metric: str, scale, seeds, dropout_rate: float,
                 need_dscale: bool):
        rows = (("lse1", lse1), ("lse2", lse2), ("delta2", delta2))
        dev, (G, H, N, D, Dv, n_i, W) = self._check(
            q, k, v, mask, bias, do, rows, jlist, jcount, scale, seeds)
        delta1 = torch.empty((G, H, N), dtype=torch.float32, device=dev)
        dbias = torch.empty((G, N, N), dtype=torch.float32, device=dev)
        dq = torch.empty((G, H, N, D), dtype=torch.float32, device=dev)
        part = torch.empty((G, H, N) if need_dscale else (1,),
                           dtype=torch.float32, device=dev)
        self._launch(dev, *(t.data_ptr() for t in (
            q, k, v, mask, bias, do, lse1, lse2, delta2, jlist, jcount, scale,
            seeds, delta1, dbias, dq, part)), G, H, N, D, Dv, n_i, W,
            MXU_METRICS.index(metric), math.sqrt(D),
            *_dropout_args(dropout_rate), int(need_dscale))
        return delta1, dbias, dq, (part.sum((0, 2)) if need_dscale else None)


class _FlashBiasedBwdKeyKernel(_FlashBiasedBackwardKernel):
    """B7b, the key walk ``tagan_flash_biased_bwd_key``
    (csrc/flash_pairwalk_biased_bwd.cu): dk and dv over the transposed
    walk (ilist, icount), given the row walk's delta1; each walked mask
    tile is copied whole and transposed in shared memory, and each key's
    valid rows are summed in ascending order. No atomics: repeated calls
    are bit-identical."""
    name = "flash_biased_bwd_key"
    symbol = "tagan_flash_biased_bwd_key"
    argtypes = (_P,) * 16 + (_I,) * 8 + (_F, _I, _U, _F)

    def __call__(self, q, k, v, mask, bias, do, lse1, lse2, delta2, delta1,
                 ilist, icount, metric: str, scale, seeds,
                 dropout_rate: float):
        rows = (("lse1", lse1), ("lse2", lse2), ("delta2", delta2),
                ("delta1", delta1))
        dev, (G, H, N, D, Dv, n_j, W) = self._check(
            q, k, v, mask, bias, do, rows, ilist, icount, scale, seeds)
        dk = torch.empty((G, H, N, D), dtype=torch.float32, device=dev)
        dv = torch.empty((G, H, N, Dv), dtype=torch.float32, device=dev)
        self._launch(dev, *(t.data_ptr() for t in (
            q, k, v, mask, bias, do, lse1, lse2, delta2, delta1, ilist,
            icount, scale, seeds, dk, dv)), G, H, N, D, Dv, n_j, W,
            MXU_METRICS.index(metric), math.sqrt(D),
            *_dropout_args(dropout_rate))
        return dk, dv


class _FlashBiasedBwdRowBf16Kernel(_FlashBiasedBwdRowKernel):
    """The row walk's bf16 form, ``tagan_flash_biased_bwd_row_bf16``."""
    name = "flash_biased_bwd_row_bf16"
    symbol = "tagan_flash_biased_bwd_row_bf16"


class _FlashBiasedBwdKeyBf16Kernel(_FlashBiasedBwdKeyKernel):
    """The key walk's bf16 form, ``tagan_flash_biased_bwd_key_bf16``."""
    name = "flash_biased_bwd_key_bf16"
    symbol = "tagan_flash_biased_bwd_key_bf16"


class _FlashBiasedBackwardCompactKernel(_CudaKernel):
    """Shared checks of B6c, B7a c and B7b c: `_check_compact`'s on the
    store and the walk (lst, cnt, slot) [G, ceil(N/64), W], the walk's
    values (`check_compact_plan`, one host synchronisation: a bad count
    or slot raises before any launch), and k [G, H, N, D], v, do
    [G, H, N, Dv], the bias store f32[G, S, 64, 64] in the store's slots,
    the row statistics ``rows`` [G, H, N], scale f32[H], seeds
    i32[G, 2]."""
    source = "flash_pairwalk_biased_bwd_compact"

    def _check(self, q, k, v, store, bias_store, do, rows, lst, cnt, slot,
               scale, seeds):
        dev = self._device_of(self.name, q)
        G, H, N, D, n, W, S, packed = _check_compact(
            self.name, dev, q, store, lst, cnt, slot)
        Dv = v.shape[-1]
        _check_args(self.name, dev, (
            ("k", k, torch.float32, (G, H, N, D)),
            ("v", v, torch.float32, (G, H, N, Dv)),
            ("bias", bias_store, torch.float32, (G, S, BLOCK_M, BLOCK_N)),
            ("do", do, torch.float32, (G, H, N, Dv)),
            *((label, t, torch.float32, (G, H, N)) for label, t in rows),
            ("scale", scale, torch.float32, (H,)),
            ("seeds", seeds, torch.int32, (G, 2))))
        _check_widths(self.name, D, Dv)
        check_compact_plan(lst, cnt, slot, store, N)
        return dev, (G, H, N, D, Dv, n, W, S, packed)


class _FlashBiasedBwdRowCompactKernel(_FlashBiasedBackwardCompactKernel):
    """B6c and B7a c in one kernel, the compact row walk
    ``tagan_flash_biased_bwd_row_compact``
    (csrc/flash_pairwalk_biased_bwd_compact.cu): (delta1_U [G, H, N], dB
    f32[G, S, 64, 64] in the store's slots, dq, dscale or None) over the
    forward walk (jlist, jcount, jslot), a pair walk that reads each
    walked slot's row words once for all heads and computes only its
    valid pairs, twice: the band's delta1 and dB, then, with
    ``delta1_rest`` [G, H, N] (or None) added to delta1, dq and dscale
    on the union's delta1, which it returns. dB is written at the mask's
    valid pairs only; elsewhere, unvisited slots included, it is left
    unset. No atomics: repeated calls are bit-identical."""
    name = "flash_biased_bwd_row_compact"
    symbol = "tagan_flash_biased_bwd_row_compact"
    argtypes = (_P,) * 19 + (_I,) * 10 + (_F, _I, _U, _F, _I)

    def __call__(self, q, k, v, store, bias_store, do, lse1, lse2, delta2,
                 delta1_rest, jlist, jcount, jslot, metric: str, scale,
                 seeds, dropout_rate: float, need_dscale: bool):
        rows = (("lse1", lse1), ("lse2", lse2), ("delta2", delta2)) + (
            () if delta1_rest is None else (("delta1_rest", delta1_rest),))
        dev, (G, H, N, D, Dv, n_i, W, S, packed) = self._check(
            q, k, v, store, bias_store, do, rows, jlist, jcount, jslot,
            scale, seeds)
        delta1 = torch.empty((G, H, N), dtype=torch.float32, device=dev)
        dbias = torch.empty((G, S, BLOCK_M, BLOCK_N), dtype=torch.float32,
                            device=dev)
        dq = torch.empty((G, H, N, D), dtype=torch.float32, device=dev)
        part = torch.empty((G, H, N) if need_dscale else (1,),
                           dtype=torch.float32, device=dev)
        self._launch(dev, *(t.data_ptr() for t in (
            q, k, v, store, bias_store, do, lse1, lse2, delta2)),
            None if delta1_rest is None else delta1_rest.data_ptr(),
            *(t.data_ptr() for t in (jlist, jcount, jslot, scale, seeds,
                                     delta1, dbias, dq, part)),
            G, H, N, D, Dv, n_i, W, S, packed, MXU_METRICS.index(metric),
            math.sqrt(D), *_dropout_args(dropout_rate), int(need_dscale))
        return delta1, dbias, dq, (part.sum((0, 2)) if need_dscale else None)


class _FlashBiasedBwdKeyCompactKernel(_FlashBiasedBackwardCompactKernel):
    """B7b c, the compact key walk ``tagan_flash_biased_bwd_key_compact``
    (csrc/flash_pairwalk_biased_bwd_compact.cu): dk and dv over the
    transposed walk (ilist, icount, islot), whose slots name the same
    tiles of both stores (row = query, column = key), given the row
    walk's delta1_U; each walked slot is copied whole and each key's
    valid rows are summed in the walk's order. No atomics: repeated calls
    are bit-identical."""
    name = "flash_biased_bwd_key_compact"
    symbol = "tagan_flash_biased_bwd_key_compact"
    argtypes = (_P,) * 17 + (_I,) * 10 + (_F, _I, _U, _F)

    def __call__(self, q, k, v, store, bias_store, do, lse1, lse2, delta2,
                 delta1, ilist, icount, islot, metric: str, scale, seeds,
                 dropout_rate: float):
        rows = (("lse1", lse1), ("lse2", lse2), ("delta2", delta2),
                ("delta1", delta1))
        dev, (G, H, N, D, Dv, n_j, W, S, packed) = self._check(
            q, k, v, store, bias_store, do, rows, ilist, icount, islot,
            scale, seeds)
        dk = torch.empty((G, H, N, D), dtype=torch.float32, device=dev)
        dv = torch.empty((G, H, N, Dv), dtype=torch.float32, device=dev)
        self._launch(dev, *(t.data_ptr() for t in (
            q, k, v, store, bias_store, do, lse1, lse2, delta2, delta1, ilist,
            icount, islot, scale, seeds, dk, dv)), G, H, N, D, Dv, n_j, W, S,
            packed, MXU_METRICS.index(metric), math.sqrt(D),
            *_dropout_args(dropout_rate))
        return dk, dv


class _FlashBiasedBwdRowCompactBf16Kernel(_FlashBiasedBwdRowCompactKernel):
    """The compact row walk's bf16 form (B6c and B7a c bf16),
    ``tagan_flash_biased_bwd_row_compact_bf16``."""
    name = "flash_biased_bwd_row_compact_bf16"
    symbol = "tagan_flash_biased_bwd_row_compact_bf16"


class _FlashBiasedBwdKeyCompactBf16Kernel(_FlashBiasedBwdKeyCompactKernel):
    """The compact key walk's bf16 form (B7b c bf16),
    ``tagan_flash_biased_bwd_key_compact_bf16``."""
    name = "flash_biased_bwd_key_compact_bf16"
    symbol = "tagan_flash_biased_bwd_key_compact_bf16"


class _FlashLse1CompactBf16Kernel(_FlashLse1CompactKernel):
    """B4c's bf16 form, ``tagan_flash_lse1_compact_bf16``: the same pair
    walk with bf16 q.k operands."""
    name = "flash_lse1_compact_bf16"
    symbol = "tagan_flash_lse1_compact_bf16"


class _FlashBiasedCompactBf16Kernel(_FlashBiasedCompactKernel):
    """B5c's bf16 form, ``tagan_flash_biased_fwd_compact_bf16``: B5c with
    bf16 q.k and P@V operands."""
    name = "flash_biased_fwd_compact_bf16"
    symbol = "tagan_flash_biased_fwd_compact_bf16"


flash_geometric_fwd_kernel = _FlashForwardKernel()
flash_geometric_bwd_fused_kernel = _FlashBwdFusedKernel()
flash_geometric_bwd_dq_kernel = _FlashBwdDqKernel()
flash_geometric_bwd_dkv_kernel = _FlashBwdDkvKernel()
flash_lse1_kernel = _FlashLse1Kernel()
flash_biased_fwd_kernel = _FlashBiasedKernel()
flash_biased_bwd_row_kernel = _FlashBiasedBwdRowKernel()
flash_biased_bwd_key_kernel = _FlashBiasedBwdKeyKernel()
flash_geometric_fwd_compact_kernel = _FlashForwardCompactKernel()
flash_lse1_compact_kernel = _FlashLse1CompactKernel()
flash_biased_fwd_compact_kernel = _FlashBiasedCompactKernel()
flash_geometric_bwd_dq_compact_kernel = _FlashBwdDqCompactKernel()
flash_geometric_bwd_dkv_compact_kernel = _FlashBwdDkvCompactKernel()
flash_biased_bwd_row_compact_kernel = _FlashBiasedBwdRowCompactKernel()
flash_biased_bwd_key_compact_kernel = _FlashBiasedBwdKeyCompactKernel()
flash_geometric_fwd_bf16_kernel = _FlashForwardBf16Kernel()
flash_geometric_bwd_fused_bf16_kernel = _FlashBwdFusedBf16Kernel()
flash_geometric_bwd_dq_bf16_kernel = _FlashBwdDqBf16Kernel()
flash_geometric_bwd_dkv_bf16_kernel = _FlashBwdDkvBf16Kernel()
flash_lse1_bf16_kernel = _FlashLse1Bf16Kernel()
flash_biased_fwd_bf16_kernel = _FlashBiasedBf16Kernel()
flash_biased_bwd_row_bf16_kernel = _FlashBiasedBwdRowBf16Kernel()
flash_biased_bwd_key_bf16_kernel = _FlashBiasedBwdKeyBf16Kernel()
flash_geometric_fwd_compact_bf16_kernel = _FlashForwardCompactBf16Kernel()
flash_geometric_bwd_dq_compact_bf16_kernel = _FlashBwdDqCompactBf16Kernel()
flash_geometric_bwd_dkv_compact_bf16_kernel = _FlashBwdDkvCompactBf16Kernel()
flash_lse1_compact_bf16_kernel = _FlashLse1CompactBf16Kernel()
flash_biased_fwd_compact_bf16_kernel = _FlashBiasedCompactBf16Kernel()
flash_biased_bwd_row_compact_bf16_kernel = \
    _FlashBiasedBwdRowCompactBf16Kernel()
flash_biased_bwd_key_compact_bf16_kernel = \
    _FlashBiasedBwdKeyCompactBf16Kernel()
KERNELS = (flash_geometric_fwd_kernel, flash_geometric_bwd_fused_kernel,
           flash_geometric_bwd_dq_kernel, flash_geometric_bwd_dkv_kernel,
           flash_lse1_kernel, flash_biased_fwd_kernel,
           flash_biased_bwd_row_kernel, flash_biased_bwd_key_kernel,
           flash_geometric_fwd_compact_kernel,
           flash_lse1_compact_kernel, flash_biased_fwd_compact_kernel,
           flash_geometric_bwd_dq_compact_kernel,
           flash_geometric_bwd_dkv_compact_kernel,
           flash_biased_bwd_row_compact_kernel,
           flash_biased_bwd_key_compact_kernel,
           flash_geometric_fwd_bf16_kernel,
           flash_geometric_bwd_fused_bf16_kernel,
           flash_geometric_bwd_dq_bf16_kernel,
           flash_geometric_bwd_dkv_bf16_kernel,
           flash_lse1_bf16_kernel, flash_biased_fwd_bf16_kernel,
           flash_biased_bwd_row_bf16_kernel,
           flash_biased_bwd_key_bf16_kernel,
           flash_geometric_fwd_compact_bf16_kernel,
           flash_geometric_bwd_dq_compact_bf16_kernel,
           flash_geometric_bwd_dkv_compact_bf16_kernel,
           flash_lse1_compact_bf16_kernel,
           flash_biased_fwd_compact_bf16_kernel,
           flash_biased_bwd_row_compact_bf16_kernel,
           flash_biased_bwd_key_compact_bf16_kernel)

# The backward the picker takes on CUDA when ``fused`` is None: B2, in
# both precisions a pair walk over the forward plan that computes only the
# mask's valid pairs, dq by the lane that owns its row and dk, dv and
# dscale by atomics (csrc/flash_pairwalk_bwd.cu). It is the faster form at
# the model's shape (one snapshot, H=4, N=10,000, head dim 16): 0.21-0.24
# ms against 0.57-0.59 ms for B3a + B3b in fp32 on an NVIDIA H100 80GB
# HBM3 at 700 W (chip_smoke.py phase 5; bf16 in phase 5g; PERF.md,
# Findings).
# ``fused=False`` (B3a + B3b: a row pair walk over the forward plan and a
# key pair walk over the transposed plan, csrc/flash_pairwalk_two_walk.cu,
# no atomics) is the deterministic form in both precisions.
FUSED_BWD = True


# ---------------------------------------------------------------------------
# Dispatch: the plain versions for CPU tensors, the kernels otherwise
# ---------------------------------------------------------------------------

def _forward(q, k, v, mask, jlist, jcount, metric, scale, dropout_rate,
             seed, bf16=False):
    """(out, lse) of folded [G, H, N, .] inputs; trusts the plan. scale
    f32[H] and seed i32[G] are given. ``bf16`` takes B1's bf16 form (on
    the CPU, the plain version's, which walks the plan)."""
    if q.device.type == "cpu":
        return flash_geometric_forward_plain(q, k, v, mask, metric, scale,
                                             dropout_rate, seed, bf16,
                                             (jlist, jcount))
    kern = flash_geometric_fwd_bf16_kernel if bf16 \
        else flash_geometric_fwd_kernel
    return kern(q, k, v, mask, jlist, jcount, metric, scale, seed,
                dropout_rate)


def _transposed_plan(mask: torch.Tensor):
    occ = _occ_from_mask(mask, BLOCK_M, BLOCK_N)
    return _plan_from_occ(occ.transpose(-1, -2))


def _backward(q, k, v, mask, out, lse, do, plan, plan_t, metric, scale,
              dropout_rate, seed, need_dscale, fused, dlse, bf16=False):
    """(dq, dk, dv, dscale or None) of folded inputs; trusts the plans.
    ``plan_t`` None is built from the mask where a kernel walks it (B3b:
    B2 walks the forward plan). ``bf16`` takes the kernels' bf16 forms."""
    if q.device.type == "cpu":
        return flash_geometric_backward_plain(
            q, k, v, mask, out, lse, do, metric, scale, dropout_rate, seed,
            need_dscale, dlse, bf16)
    delta = _delta(do, out, dlse).contiguous()
    fused = FUSED_BWD if fused is None else fused
    if fused:
        kern = flash_geometric_bwd_fused_bf16_kernel if bf16 \
            else flash_geometric_bwd_fused_kernel
        return kern(q, k, v, mask, do, lse, delta, *plan, metric, scale,
                    seed, dropout_rate, need_dscale)
    if plan_t is None:
        plan_t = _transposed_plan(mask)
    dq_kern, dkv_kern = (
        (flash_geometric_bwd_dq_bf16_kernel,
         flash_geometric_bwd_dkv_bf16_kernel) if bf16 else
        (flash_geometric_bwd_dq_kernel, flash_geometric_bwd_dkv_kernel))
    dq, dscale = dq_kern(q, k, v, mask, do, lse, delta, *plan, metric,
                         scale, seed, dropout_rate, need_dscale)
    dk, dv = dkv_kern(q, k, v, mask, do, lse, delta, *plan_t, metric, scale,
                      seed, dropout_rate)
    return dq, dk, dv, dscale


def _defaults(q, scale, seed):
    G, H = q.shape[0], q.shape[1]
    if scale is None:
        scale = torch.ones(H, dtype=torch.float32, device=q.device)
    if seed is None:
        seed = torch.zeros(G, dtype=torch.int32, device=q.device)
    return scale, seed


def flash_geometric_fwd(q, k, v, mask, jlist, jcount, *, metric: str,
                        scale: Optional[torch.Tensor] = None,
                        dropout_rate: float = 0.0,
                        seed: Optional[torch.Tensor] = None,
                        bf16: bool = False):
    """(out, lse) of the batched forward: the plain version for CPU
    tensors, the CUDA kernel otherwise. Shapes as in
    `flash_geometric_forward_plain`; jlist/jcount i32[G, ceil(N/64), W]
    and [G, ceil(N/64)] at the kernel's tile, checked by `check_plan`
    (the float32 plain version does not read them). ``bf16`` takes B1's
    bf16 form, whose result depends on the walk."""
    check_plan(jlist, jcount, q.shape[2])
    scale, seed = _defaults(q, scale, seed)
    return _forward(q, k, v, mask, jlist, jcount, metric, scale,
                    dropout_rate, seed, bf16)


def flash_geometric_attention_bwd(
    q, k, v, mask, out, lse, do, *, metric: str = "scaled_dot_product",
    scale: Optional[torch.Tensor] = None, plan=None, plan_t=None,
    seed: Optional[torch.Tensor] = None, dropout_rate: float = 0.0,
    need_dscale: bool = False, fused: Optional[bool] = None,
    dlse: Optional[torch.Tensor] = None, bf16: bool = False,
):
    """The backward of the batched forward (the TPU package's
    ``flash_geometric_attention_bwd``): (dq, dk, dv), plus dscale f32[H]
    with ``need_dscale``. Folded shapes as in `flash_geometric_fwd`; out
    and lse are the forward's, do and dlse their cotangents. Cosine
    metrics expect q/k already normalised. Plans given by the caller are
    checked; missing ones are built from the mask.

    CPU tensors take the plain version. CUDA tensors take B2
    (``fused=True``: a pair walk over the forward plan that computes only
    the mask's valid pairs, dq row by row, dk, dv and dscale by atomics)
    or B3a then B3b (``fused=False``: pair walks without atomics, a row
    walk over the forward plan for dq and dscale, a key walk over the
    transposed plan for dk and dv).
    ``fused=None`` takes `FUSED_BWD`, which is B2, the faster form at the
    model's shape (chip_smoke.py phase 5). Unlike the TPU's rule (a
    scoped-VMEM budget) nothing depends on the size: both forms use
    O(N D) memory besides the mask. B2's dk, dv and dscale vary in their
    last bits from run to run; ``fused=False`` is deterministic.

    ``bf16`` takes the bf16 forms (B2, B3a and B3b with bf16 dot
    operands, or B3a c and B3b c's; the plain version on the CPU), with
    the same walks and the same determinism.

    3-tuple plans (jlist, jcount, jslot) and (ilist, icount, islot) take
    the compact form: ``mask`` is then the occupied-block store
    (`store_packed`), the plans are checked (`check_compact_plan`), and
    CUDA tensors take B3a c then B3b c (which walks ``plan_t``; without
    it the compact backward raises ValueError)."""
    N = q.shape[2]
    if plan is not None and len(plan) == 3:
        check_compact_plan(*plan, mask, N)
        if plan_t is not None:
            check_compact_plan(*plan_t, mask, N)
        scale, seed = _defaults(q, scale, seed)
        dq, dk, dv, dscale = _backward_compact(
            q, k, v, mask, out, lse, do, plan, plan_t, metric, scale,
            dropout_rate, seed, need_dscale, dlse, bf16)
        return (dq, dk, dv, dscale) if need_dscale else (dq, dk, dv)
    if plan is None:
        plan = make_block_plan(mask)
    else:
        check_plan(*plan, N)
    if plan_t is not None:
        check_plan(*plan_t, N)
    scale, seed = _defaults(q, scale, seed)
    dq, dk, dv, dscale = _backward(q, k, v, mask, out, lse, do, plan, plan_t,
                                   metric, scale, dropout_rate, seed,
                                   need_dscale, fused, dlse, bf16)
    return (dq, dk, dv, dscale) if need_dscale else (dq, dk, dv)


class _FlashAttention(torch.autograd.Function):
    """The differentiable forward of folded inputs (the TPU package's
    ``_flash_diff`` and ``_flash_diff_scaled``): B1 forward, the picked
    backward (or the plain versions on the CPU), in their bf16 forms with
    ``bf16`` (the TPU custom_vjp's static ``bf16``). Returns (out, lse);
    the cotangent of lse rides on delta. dscale is formed only when the
    scale requires grad."""

    @staticmethod
    def forward(ctx, q, k, v, scale, mask, jlist, jcount, ilist, icount,
                seed, metric, dropout_rate, bf16):
        out, lse = _forward(q, k, v, mask, jlist, jcount, metric, scale,
                            dropout_rate, seed, bf16)
        ctx.save_for_backward(q, k, v, scale, mask, out, lse, jlist, jcount,
                              ilist, icount, seed)
        ctx.args = (metric, dropout_rate, bf16)
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    def backward(ctx, dout, dlse):
        (q, k, v, scale, mask, out, lse, jlist, jcount, ilist, icount,
         seed) = ctx.saved_tensors
        metric, dropout_rate, bf16 = ctx.args
        if dout is None:
            dout = torch.zeros_like(out)
        need_dscale = ctx.needs_input_grad[3] and metric in SCALED_METRICS
        dq, dk, dv, dscale = _backward(
            q, k, v, mask, out, lse, dout.contiguous(), (jlist, jcount),
            None if ilist is None else (ilist, icount), metric, scale,
            dropout_rate, seed, need_dscale, None,
            None if dlse is None else dlse.contiguous(), bf16)
        if ctx.needs_input_grad[3] and dscale is None:
            dscale = torch.zeros_like(scale)
        return (dq, dk, dv, dscale) + (None,) * 9


def _biased_forward(q, k, v, mask, bias, jlist, jcount, metric, scale,
                    dropout_rate, seeds, bf16=False):
    """(out, lse1, lse2) of folded inputs: B4 then B5 for CUDA tensors,
    the plain versions for CPU tensors; trusts the plan. ``bf16`` takes
    their bf16 forms (on the CPU the plain B5's, which walks the
    plan)."""
    if q.device.type == "cpu":
        lse1 = flash_lse1_plain(q, k, mask, metric, scale, bf16)
        out, lse2 = flash_biased_forward_plain(q, k, v, mask, bias, lse1,
                                               metric, scale, dropout_rate,
                                               seeds, bf16, (jlist, jcount))
        return out, lse1, lse2
    lse1_kern, fwd_kern = (
        (flash_lse1_bf16_kernel, flash_biased_fwd_bf16_kernel) if bf16 else
        (flash_lse1_kernel, flash_biased_fwd_kernel))
    lse1 = lse1_kern(q, k, mask, jlist, jcount, metric, scale)
    out, lse2 = fwd_kern(q, k, v, mask, bias, lse1, jlist, jcount, metric,
                         scale, seeds, dropout_rate)
    return out, lse1, lse2


def _fold_seed(dropout_seed, G: int, device) -> torch.Tensor:
    """i32[G]: one hash seed per folded snapshot from one int32 or one
    per snapshot; zeros without a seed."""
    if dropout_seed is None:
        return torch.zeros(G, dtype=torch.int32, device=device)
    s = torch.as_tensor(dropout_seed, dtype=torch.int32,
                        device=device).reshape(-1)
    return (s.expand(G) if s.numel() == 1 else s.reshape(G)).contiguous()


def biased_seeds(dropout_seed, G: int, device) -> torch.Tensor:
    """The edge-biased variant's two hash seeds per folded snapshot,
    i32[G, 2] (the TPU package's rule): zeros without a seed, else the
    snapshot's seed s for the first dropout and s ^ 0x5BD1E995 for the
    second. ``dropout_seed`` is one int32 or one per snapshot."""
    if dropout_seed is None:
        return torch.zeros((G, 2), dtype=torch.int32, device=device)
    s = _fold_seed(dropout_seed, G, device)
    return torch.stack([s, s ^ 0x5BD1E995], dim=-1).contiguous()


def flash_biased_fwd(q, k, v, mask, bias, jlist, jcount, *, metric: str,
                     scale: Optional[torch.Tensor] = None,
                     dropout_rate: float = 0.0,
                     seeds: Optional[torch.Tensor] = None,
                     bf16: bool = False):
    """(out, lse1, lse2) of the batched edge-biased forward (the TPU
    package's ``_flash_biased_forward(..., return_lse=True)``): B4 then
    B5, or their plain versions for CPU tensors. bias f32[G, N, N],
    seeds i32[G, 2] (`biased_seeds`); the other shapes and the plan
    check as in `flash_geometric_fwd`. ``bf16`` takes their bf16 forms,
    whose out and lse2 depend on the walk."""
    check_plan(jlist, jcount, q.shape[2])
    scale, _ = _defaults(q, scale, None)
    if seeds is None:
        seeds = biased_seeds(None, q.shape[0], q.device)
    return _biased_forward(q, k, v, mask, bias, jlist, jcount, metric, scale,
                           dropout_rate, seeds, bf16)


def _biased_backward(q, k, v, mask, bias, out, lse1, lse2, do, plan, plan_t,
                     metric, scale, dropout_rate, seeds, need_dscale,
                     bf16=False):
    """(dq, dk, dv, dB, dscale or None) of folded inputs, the plain
    version for CPU tensors; trusts the plans. ``plan_t`` None is built
    from the mask. On CUDA, the two pair walks, in fp32 or with ``bf16``
    their bf16 forms: the row walk (B6 and B7a: delta1, dB, dq, dscale)
    then the key walk (B7b: dk, dv), both free of atomics. dB is the TPU
    kernels' contract, read at the mask's pairs: the row walk sets it
    there only, the plain version everywhere."""
    if q.device.type == "cpu":
        return flash_biased_backward_plain(q, k, v, mask, bias, out, lse1,
                                           lse2, do, metric, scale,
                                           dropout_rate, seeds, need_dscale,
                                           bf16)
    delta2 = (do * out).sum(-1).contiguous()
    if plan_t is None:
        plan_t = _transposed_plan(mask)
    rows = (lse1, lse2, delta2)
    row, key = ((flash_biased_bwd_row_bf16_kernel,
                 flash_biased_bwd_key_bf16_kernel) if bf16 else
                (flash_biased_bwd_row_kernel, flash_biased_bwd_key_kernel))
    delta1, dbias, dq, dscale = row(
        q, k, v, mask, bias, do, *rows, *plan, metric, scale, seeds,
        dropout_rate, need_dscale)
    dk, dv = key(q, k, v, mask, bias, do, *rows, delta1, *plan_t, metric,
                 scale, seeds, dropout_rate)
    return dq, dk, dv, dbias, dscale


def flash_biased_attention_bwd(
    q, k, v, bias, mask, out, lse1, lse2, do, *,
    metric: str = "scaled_dot_product", scale: Optional[torch.Tensor] = None,
    plan=None, plan_t=None, seeds: Optional[torch.Tensor] = None,
    dropout_rate: float = 0.0, need_dscale: bool = False, bf16: bool = False,
):
    """The backward of the batched edge-biased forward (the TPU package's
    ``flash_biased_attention_bwd``): (dq, dk, dv, dB), plus dscale f32[H]
    with ``need_dscale``. Folded shapes as in `flash_biased_fwd`; out,
    lse1 and lse2 are the forward's, do the cotangent of out. Cosine
    metrics expect q/k already normalised. Plans given by the caller are
    checked; missing ones are built from the mask. CPU tensors take the
    plain version; CUDA tensors the row walk (B6 and B7a) and the key walk
    (B7b), with ``bf16`` their bf16 forms, which sum in a fixed order. dB
    [G, N, N] is defined at the mask's pairs only (on CUDA it is left
    unset elsewhere); read it there only."""
    N = q.shape[2]
    if plan is None:
        plan, plan_t = make_block_plans_from_mask(mask)
    else:
        check_plan(*plan, N)
        if plan_t is not None:
            check_plan(*plan_t, N)
    scale, _ = _defaults(q, scale, None)
    if seeds is None:
        seeds = biased_seeds(None, q.shape[0], q.device)
    dq, dk, dv, dbias, dscale = _biased_backward(
        q, k, v, mask, bias, out, lse1, lse2, do, plan, plan_t, metric,
        scale, dropout_rate, seeds, need_dscale, bf16)
    return (dq, dk, dv, dbias) + ((dscale,) if need_dscale else ())


class _FlashBiasedAttention(torch.autograd.Function):
    """The edge-biased attention of folded inputs (the TPU package's
    ``_flash_diff_biased``): B4 then B5 forward, the row walk (B6 and
    B7a) then the key walk (B7b) backward (or the plain versions on the
    CPU); with ``bf16`` their bf16 forms. The backward
    reads the dropout seeds saved by the forward.
    dscale is formed only when the scale requires grad, dB only when the
    bias does."""

    @staticmethod
    def forward(ctx, q, k, v, scale, bias, mask, jlist, jcount, ilist, icount,
                seeds, metric, dropout_rate, bf16):
        out, lse1, lse2 = _biased_forward(q, k, v, mask, bias, jlist, jcount,
                                          metric, scale, dropout_rate, seeds,
                                          bf16)
        # the bias as given: no second copy of the [G, N, N] matrix
        ctx.save_for_backward(q, k, v, scale, bias, mask, out, lse1, lse2,
                              jlist, jcount, ilist, icount, seeds)
        ctx.args = (metric, dropout_rate, bf16)
        return out

    @staticmethod
    def backward(ctx, dout):
        (q, k, v, scale, bias, mask, out, lse1, lse2, jlist, jcount, ilist,
         icount, seeds) = ctx.saved_tensors
        metric, dropout_rate, bf16 = ctx.args
        need_dscale = ctx.needs_input_grad[3] and metric in SCALED_METRICS
        dq, dk, dv, dbias, dscale = _biased_backward(
            q, k, v, mask, bias, out, lse1, lse2, dout.contiguous(),
            (jlist, jcount), None if ilist is None else (ilist, icount),
            metric, scale, dropout_rate, seeds, need_dscale, bf16)
        if ctx.needs_input_grad[3] and dscale is None:
            dscale = torch.zeros_like(scale)
        if not ctx.needs_input_grad[4]:
            dbias = None
        return (dq, dk, dv, dscale, dbias) + (None,) * 9


def flash_geometric_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor,
    metric: str = "scaled_dot_product",
    scale_param: Optional[torch.Tensor] = None, plan=None, plan_t=None,
    dropout_rate: float = 0.0, dropout_seed: Optional[torch.Tensor] = None,
    return_lse: bool = False, bias: Optional[torch.Tensor] = None,
    bf16: bool = False,
):
    """Differentiable edge-masked attention (the TPU package's
    ``flash_geometric_attention``): the forward kernel B1 and, under
    autograd, the backward kernels (`flash_geometric_attention_bwd`).

    q, k [..., H, N, D], v [..., H, N, Dv], mask [..., N, N] (True where
    query i attends to key j). Leading dims (snapshots, sequences) fold
    into one kernel launch. ``plan`` is the forward walk (jlist, jcount)
    and ``plan_t`` the transposed walk (ilist, icount) at the kernel tile,
    [..., n_i, W] and [..., n_i], checked by `check_plan`; built from the
    mask when omitted. ``dropout_seed`` is an int32 per leading index.
    Returns out [..., H, N, Dv] (zero on rows with no valid key) and,
    with ``return_lse``, lse [..., H, N] (``LSE_DEAD`` on those rows).
    ``scale_param`` (gaussian sigma, rbf gamma) gets a gradient when it
    requires one.

    ``bias`` [..., N, N] (shared by the heads) takes the edge-biased
    variant, the dense path's double softmax: out = drop2(softmax(
    drop1(softmax(s)) + bias)) @ v over the mask, through kernels B4 and
    B5 and, under autograd, the row walk (B6 and B7a) and the key walk
    (B7b) (`flash_biased_attention_bwd`), with the two dropout seeds of
    `biased_seeds`. It returns out only; the bias gets its gradient at
    the mask's pairs, which are the only ones its result depends on
    (elsewhere it is unset on CUDA: read it there only).

    ``bf16`` takes the kernels' bf16 forms (the TPU package's ``bf16``:
    bf16 dot operands, float32 sums), forward and backward, with or
    without ``bias``."""
    if bias is not None and return_lse:
        raise ValueError("return_lse is not available with bias")
    if plan is None:
        plan, plan_t = make_block_plans_from_mask(mask)
    else:
        check_plan(*plan, q.shape[-2])
        if plan_t is not None:
            check_plan(*plan_t, q.shape[-2])
    return _flash_attention(q, k, v, mask, metric, scale_param, plan,
                            dropout_rate, dropout_seed, return_lse, plan_t,
                            bias, bf16)


def _flash_attention(q, k, v, mask, metric, scale_param, plan,
                     dropout_rate=0.0, dropout_seed=None, return_lse=False,
                     plan_t=None, bias=None, bf16=False):
    """`flash_geometric_attention` with plans from the builders above,
    taken unchecked (the model's path). The cosine normalisation and the
    folding of leading dims stay outside the autograd Function, where
    autograd pulls them back, as JAX does outside its custom_vjp."""
    if metric not in MXU_METRICS:
        raise NotImplementedError(
            f"metric {metric} is not written through q.k; use the dense path")
    if dropout_rate > 0.0 and dropout_seed is None:
        raise ValueError("dropout_rate > 0 requires dropout_seed")
    lead = q.shape[:-3]
    H, N, D = q.shape[-3:]
    Dv = v.shape[-1]
    G = math.prod(lead)
    if metric in _COSINE:
        q, k = _l2_normalize(q), _l2_normalize(k)
    scale = torch.ones(H, dtype=torch.float32, device=q.device) \
        if scale_param is None else scale_param.to(torch.float32).contiguous()

    def fold_plan(p):
        if p is None:
            return None, None
        lst, cnt = p
        return (lst.reshape(G, *lst.shape[-2:]).to(torch.int32).contiguous(),
                cnt.reshape(G, -1).to(torch.int32).contiguous())

    qf, kf = (t.reshape(G, H, N, D).contiguous() for t in (q, k))
    vf = v.reshape(G, H, N, Dv).contiguous()
    mf = mask.reshape(G, N, N).contiguous()
    if bias is not None:
        out = _FlashBiasedAttention.apply(
            qf, kf, vf, scale,
            bias.to(torch.float32).reshape(G, N, N).contiguous(), mf,
            *fold_plan(plan), *fold_plan(plan_t),
            biased_seeds(dropout_seed, G, q.device), metric, dropout_rate,
            bf16)
        return out.reshape(*lead, H, N, Dv)
    out, lse = _FlashAttention.apply(
        qf, kf, vf, scale, mf, *fold_plan(plan), *fold_plan(plan_t),
        _fold_seed(dropout_seed, G, q.device), metric, dropout_rate, bf16)
    out = out.reshape(*lead, H, N, Dv)
    if return_lse:
        return out, lse.reshape(*lead, H, N)
    return out


# ---------------------------------------------------------------------------
# The compact forms (the hybrid backend's band): B1c with its backward
# B3a c + B3b c; the edge-biased B4c and B5c with their backward B6c, B7a c
# and B7b c
# ---------------------------------------------------------------------------

def _forward_compact(q, k, v, store, plan, metric, scale, dropout_rate,
                     seed, bf16=False):
    """(out, lse) of folded inputs over the compact store: B1c (its bf16
    form with ``bf16``) for CUDA tensors, the plain version for CPU
    tensors; trusts the plan."""
    if q.device.type == "cpu":
        return flash_geometric_forward_compact_plain(
            q, k, v, store, *plan, metric, scale, dropout_rate, seed, bf16)
    kern = flash_geometric_fwd_compact_bf16_kernel if bf16 \
        else flash_geometric_fwd_compact_kernel
    return kern(q, k, v, store, *plan, metric, scale, seed, dropout_rate)


def _need_transposed(plan_t, kernel: str) -> None:
    if plan_t is None:
        raise ValueError(
            f"the compact backward ({kernel}) walks the transposed plan "
            "(ilist, icount, islot), and none was given: build the plan "
            "with the transposed walk (SnapshotSequence.with_hybrid_plan("
            "transposed=True), attach_hybrid_plans(..., transposed=True), "
            "or TemporalGraphDataLoader(plan='hybrid'))")


def _backward_compact(q, k, v, store, out, lse, do, plan, plan_t, metric,
                      scale, dropout_rate, seed, need_dscale, dlse,
                      bf16=False):
    """(dq, dk, dv, dscale or None) of folded inputs over the compact
    store: B3a c then B3b c (their bf16 forms with ``bf16``) for CUDA
    tensors, the compact plain backward for CPU tensors. Raises
    ValueError without the transposed walk ``plan_t``, which B3b c
    walks."""
    _need_transposed(plan_t, "B3b c")
    if q.device.type == "cpu":
        return flash_geometric_backward_compact_plain(
            q, k, v, store, out, lse, do, *plan, metric, scale,
            dropout_rate, seed, need_dscale, dlse, bf16)
    delta = _delta(do, out, dlse).contiguous()
    dq_kern, dkv_kern = (
        (flash_geometric_bwd_dq_compact_bf16_kernel,
         flash_geometric_bwd_dkv_compact_bf16_kernel) if bf16 else
        (flash_geometric_bwd_dq_compact_kernel,
         flash_geometric_bwd_dkv_compact_kernel))
    dq, dscale = dq_kern(q, k, v, store, do, lse, delta, *plan, metric,
                         scale, seed, dropout_rate, need_dscale)
    dk, dv = dkv_kern(q, k, v, store, do, lse, delta, *plan_t, metric, scale,
                      seed, dropout_rate)
    return dq, dk, dv, dscale


class _FlashCompactAttention(torch.autograd.Function):
    """The differentiable compact forward of folded inputs (the TPU
    package's ``_flash_diff`` with 3-tuple plans): B1c forward, B3a c then
    B3b c backward (the plain versions on the CPU), in their bf16 forms
    with ``bf16``. Returns (out, lse); the cotangent of lse (the hybrid
    merge gives one) rides on delta. dscale is formed only when the scale
    requires grad."""

    @staticmethod
    def forward(ctx, q, k, v, scale, store, jlist, jcount, jslot, ilist,
                icount, islot, seed, metric, dropout_rate, bf16):
        out, lse = _forward_compact(q, k, v, store, (jlist, jcount, jslot),
                                    metric, scale, dropout_rate, seed, bf16)
        ctx.save_for_backward(q, k, v, scale, store, out, lse, jlist, jcount,
                              jslot, ilist, icount, islot, seed)
        ctx.args = (metric, dropout_rate, bf16)
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    def backward(ctx, dout, dlse):
        (q, k, v, scale, store, out, lse, jlist, jcount, jslot, ilist,
         icount, islot, seed) = ctx.saved_tensors
        metric, dropout_rate, bf16 = ctx.args
        if dout is None:
            dout = torch.zeros_like(out)
        need_dscale = ctx.needs_input_grad[3] and metric in SCALED_METRICS
        dq, dk, dv, dscale = _backward_compact(
            q, k, v, store, out, lse, dout.contiguous(),
            (jlist, jcount, jslot),
            None if ilist is None else (ilist, icount, islot), metric, scale,
            dropout_rate, seed, need_dscale,
            None if dlse is None else dlse.contiguous(), bf16)
        if ctx.needs_input_grad[3] and dscale is None:
            dscale = torch.zeros_like(scale)
        return (dq, dk, dv, dscale) + (None,) * 11


def _lse1_compact(q, k, store, plan, metric, scale, bf16=False):
    """lse1 of folded inputs over the compact store: B4c (its bf16 form
    with ``bf16``) for CUDA tensors, the plain version for CPU tensors;
    trusts the plan."""
    if q.device.type == "cpu":
        return flash_lse1_compact_plain(q, k, store, *plan, metric, scale,
                                        bf16)
    kern = flash_lse1_compact_bf16_kernel if bf16 \
        else flash_lse1_compact_kernel
    return kern(q, k, store, *plan, metric, scale)


def _biased_forward_compact(q, k, v, store, bias_store, lse1, plan, metric,
                            scale, dropout_rate, seeds, bf16=False):
    """(out, lse2) of folded inputs over the compact store given lse1:
    B5c (its bf16 form with ``bf16``) for CUDA tensors, the plain version
    for CPU tensors; trusts the plan."""
    if q.device.type == "cpu":
        return flash_biased_forward_compact_plain(
            q, k, v, store, bias_store, lse1, *plan, metric, scale,
            dropout_rate, seeds, bf16)
    kern = flash_biased_fwd_compact_bf16_kernel if bf16 \
        else flash_biased_fwd_compact_kernel
    return kern(q, k, v, store, bias_store, lse1, *plan, metric, scale, seeds,
                dropout_rate)


def _biased_backward_compact(q, k, v, store, bias_store, do, lse1, lse2,
                             delta2, plan, plan_t, metric, scale,
                             dropout_rate, seeds, need_dscale,
                             delta1_rest=None, bf16=False):
    """(dq, dk, dv, dB, dscale or None, delta1) of folded inputs over the
    compact store, given the row statistics lse1, lse2 and delta2
    [G, H, N]. delta1 is B6c's row sums plus ``delta1_rest`` [G, H, N]
    where given (the hybrid band adds the residual's, so that B7a c and
    B7b c take the union's). CUDA tensors: the two pair walks, in both
    precisions (``bf16`` their bf16 forms), the row walk (B6c and B7a c:
    delta1, dB, dq, dscale, the residual's delta1 added between its two
    passes) then the key walk (B7b c: dk, dv), both free of atomics. CPU
    tensors: the compact plain parts, with ``delta1_rest`` added between
    B6c's and B7a c's. dB f32[G, S, 64, 64] is the TPU kernels' contract,
    read at the mask's pairs: the walks set it there only and leave every
    other entry unset (`torch.empty`); the plain parts set every pair of
    the walked slots (0 off the mask and in slots the walk does not
    visit). Raises ValueError without the transposed walk ``plan_t``,
    which B7b c walks."""
    _need_transposed(plan_t, "B7b c")
    rows = (do, lse1, lse2, delta2)
    if q.device.type == "cpu":
        delta1, dbias = flash_biased_bwd_pre_compact_plain(
            q, k, v, store, bias_store, *rows, *plan, metric, scale,
            dropout_rate, seeds, bf16)
        if delta1_rest is not None:
            delta1 = delta1 + delta1_rest
        r = _biased_bwd_compact_plain(q, k, v, store, bias_store, *rows,
                                      *plan, metric, scale, dropout_rate,
                                      seeds, delta1, need_dscale,
                                      ("dq", "dkv"), bf16)
        return r["dq"], r["dk"], r["dv"], dbias, r["dscale"], delta1
    row_k, key_k = ((flash_biased_bwd_row_compact_bf16_kernel,
                     flash_biased_bwd_key_compact_bf16_kernel) if bf16 else
                    (flash_biased_bwd_row_compact_kernel,
                     flash_biased_bwd_key_compact_kernel))
    delta1, dbias, dq, dscale = row_k(
        q, k, v, store, bias_store, *rows,
        None if delta1_rest is None else delta1_rest.contiguous(), *plan,
        metric, scale, seeds, dropout_rate, need_dscale)
    dk, dv = key_k(q, k, v, store, bias_store, *rows, delta1, *plan_t,
                   metric, scale, seeds, dropout_rate)
    return dq, dk, dv, dbias, dscale, delta1


def flash_geometric_fwd_compact(q, k, v, store, jlist, jcount, jslot, *,
                                metric: str,
                                scale: Optional[torch.Tensor] = None,
                                dropout_rate: float = 0.0,
                                seed: Optional[torch.Tensor] = None,
                                bf16: bool = False):
    """(out, lse) of the batched forward over a compact store: B1c, or
    its plain version for CPU tensors. Shapes as in
    `flash_geometric_forward_compact_plain`; the plan is checked by
    `check_compact_plan`. ``bf16`` takes B1c's bf16 form, whose result
    depends on the walk."""
    check_compact_plan(jlist, jcount, jslot, store, q.shape[2])
    scale, seed = _defaults(q, scale, seed)
    return _forward_compact(q, k, v, store, (jlist, jcount, jslot), metric,
                            scale, dropout_rate, seed, bf16)


def flash_lse1_compact(q, k, store, jlist, jcount, jslot, *, metric: str,
                       scale: Optional[torch.Tensor] = None,
                       bf16: bool = False):
    """lse1 [G, H, N] over a compact store: B4c, or its plain version for
    CPU tensors; the plan is checked. ``bf16`` takes B4c's bf16 form."""
    check_compact_plan(jlist, jcount, jslot, store, q.shape[2])
    scale, _ = _defaults(q, scale, None)
    return _lse1_compact(q, k, store, (jlist, jcount, jslot), metric, scale,
                         bf16)


def flash_biased_fwd_compact(q, k, v, store, bias_store, lse1, jlist, jcount,
                             jslot, *, metric: str,
                             scale: Optional[torch.Tensor] = None,
                             dropout_rate: float = 0.0,
                             seeds: Optional[torch.Tensor] = None,
                             bf16: bool = False):
    """(out, lse2) of the second softmax over a compact store given lse1
    (the JAX package's ``_band_biased_main``): B5c, or its plain version
    for CPU tensors; the plan is checked, seeds i32[G, 2]
    (`biased_seeds`). ``bf16`` takes B5c's bf16 form, whose result
    depends on the walk."""
    check_compact_plan(jlist, jcount, jslot, store, q.shape[2])
    scale, _ = _defaults(q, scale, None)
    if seeds is None:
        seeds = biased_seeds(None, q.shape[0], q.device)
    return _biased_forward_compact(q, k, v, store, bias_store, lse1,
                                   (jlist, jcount, jslot), metric, scale,
                                   dropout_rate, seeds, bf16)


def fold_compact(store, plan, G: int):
    """The store [..., S, BM(, BN)] and plan [..., n, W] with their
    leading dims folded into G, int32 and contiguous."""
    lead = store.dim() - (2 if store_packed(store) else 3)
    return (store.reshape(G, *store.shape[lead:]).contiguous(),
            tuple(p.reshape(G, *p.shape[lead:]).to(torch.int32).contiguous()
                  for p in plan))


def _flash_compact(q, k, v, store, plan, metric, scale_param,
                   dropout_rate=0.0, dropout_seed=None, plan_t=None,
                   bf16=False):
    """(out, lse) of the differentiable compact attention with leading
    dims, the plans taken unchecked (the model's path): the cosine
    normalisation and the folding stay outside the autograd Function,
    where autograd pulls them back, as in `_flash_attention`. The
    backward needs the transposed walk ``plan_t`` (ilist, icount, islot)
    and raises ValueError without it. ``bf16`` takes the kernels' bf16
    forms, forward and backward."""
    if metric not in MXU_METRICS:
        raise NotImplementedError(
            f"metric {metric} is not written through q.k; use the dense path")
    if dropout_rate > 0.0 and dropout_seed is None:
        raise ValueError("dropout_rate > 0 requires dropout_seed")
    lead = q.shape[:-3]
    H, N, D = q.shape[-3:]
    Dv = v.shape[-1]
    G = math.prod(lead)
    if metric in _COSINE:
        q, k = _l2_normalize(q), _l2_normalize(k)
    scale = torch.ones(H, dtype=torch.float32, device=q.device) \
        if scale_param is None else scale_param.to(torch.float32).contiguous()
    st, pl = fold_compact(store, plan, G)
    pl_t = (None,) * 3 if plan_t is None else fold_compact(store, plan_t,
                                                           G)[1]
    out, lse = _FlashCompactAttention.apply(
        q.reshape(G, H, N, D).contiguous(), k.reshape(G, H, N, D).contiguous(),
        v.reshape(G, H, N, Dv).contiguous(), scale, st, *pl, *pl_t,
        _fold_seed(dropout_seed, G, q.device), metric, dropout_rate, bf16)
    return out.reshape(*lead, H, N, Dv), lse.reshape(*lead, H, N)


def flash_geometric_attention_lse(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor,
    metric: str = "scaled_dot_product",
    scale_param: Optional[torch.Tensor] = None, plan=None, plan_t=None,
    dropout_rate: float = 0.0, dropout_seed: Optional[torch.Tensor] = None,
    bf16: bool = False,
):
    """(out, lse) of the edge-masked attention (the TPU package's
    ``flash_geometric_attention_lse``), leading dims folded into one
    launch, differentiable in q, k, v and the scale. A 3-tuple ``plan``
    (jlist, jcount, jslot) takes the compact form: ``mask`` is then the
    occupied-block store (`store_packed`), the forward runs B1c and the
    backward B3a c then B3b c, which walk the 3-tuple transposed plan
    ``plan_t`` (ilist, icount, islot): a backward without it raises
    ValueError. Both plans are checked (`check_compact_plan`); the
    cotangent of lse (the hybrid merge's) joins the backward through
    delta. Otherwise the dense `flash_geometric_attention` with
    ``return_lse``. ``bf16`` takes the kernels' bf16 forms."""
    if plan is None or len(plan) != 3:
        return flash_geometric_attention(
            q, k, v, mask, metric, scale_param, plan, plan_t, dropout_rate,
            dropout_seed, return_lse=True, bf16=bf16)
    G = math.prod(q.shape[:-3])
    st, pl = fold_compact(mask, plan, G)
    check_compact_plan(*pl, st, q.shape[-2])
    if plan_t is not None:
        check_compact_plan(*fold_compact(mask, plan_t, G)[1], st,
                           q.shape[-2])
    return _flash_compact(q, k, v, mask, plan, metric, scale_param,
                          dropout_rate, dropout_seed, plan_t, bf16)
