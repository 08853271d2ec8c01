"""Block-sparse edge-masked geometric attention, forward.

Counterpart of the forward half of
``tagan_tpu/ops/pallas/flash_geometric.py``: the score helpers, the
dropout hash, the block-plan builders, the plain PyTorch version of the
forward and the wrapper of its CUDA kernel (``csrc/flash_geometric_fwd.cu``,
the port of the Pallas ``_flash_kernel``).

Supported metrics are those written through the cross term q.k and the
row norms (``MXU_METRICS``); cosine metrics run on L2-normalised q/k;
gaussian/rbf take a per-head scale. Squared distances use the norm
expansion ``max(|q|^2 + |k|^2 - 2 q.k, 0)``, as the TPU kernel does (the
dense path in ``ops.distances`` subtracts then squares).

Dispatch: `flash_geometric_fwd` runs the plain version for CPU tensors
and the CUDA kernel for CUDA tensors; there is no fallback between the
two. The kernel trusts the block plan it walks; the public entry points
check a plan given by their caller (`check_plan`), and only the model's
own plans, built here, reach the kernel unchecked. The kernel has no
backward yet, so on CUDA it refuses inputs that require grad.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from ..ops import build

NEG_INF = -1e30
LSE_DEAD = 1e30   # lse of a row with no valid key

# The CUDA kernel's tile (csrc/flash_geometric_fwd.cu: BM, BN). Plans fed
# to the kernel are built at this tile.
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


def _qk_sq(metric: str, q, k):
    """Cross term ``q @ k^T`` and, for the squared-distance metrics, the
    squared distance by the norm expansion."""
    qk = q @ k.transpose(-1, -2)
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


def make_block_plan_from_edges(edge_src, edge_dst, edge_mask, node_mask,
                               n: int, block_m: int = BLOCK_M,
                               block_n: int = BLOCK_N):
    """The forward walk plan from the edge list (+ self loops of live
    nodes), never touching a dense mask. Equals `make_block_plan` of the
    densified edges."""
    return _plan_from_occ(_occ_from_edges(edge_src, edge_dst, edge_mask,
                                          node_mask, n, block_m, block_n))


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
# The forward: plain version and CUDA kernel
# ---------------------------------------------------------------------------

def flash_geometric_forward_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor,
    metric: str, scale: Optional[torch.Tensor] = None,
    dropout_rate: float = 0.0, seed: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """What the kernel computes, as a dense masked softmax over row
    chunks. q, k [G, H, N, D], v [G, H, N, Dv], mask [G, N, N], scale
    f32[H], seed i32[G] -> (out f32[G, H, N, Dv], lse f32[G, H, N]).
    Cosine metrics expect q/k already normalised, as the kernel does."""
    G, H, N, D = q.shape
    if scale is None:
        scale = torch.ones(H, dtype=q.dtype, device=q.device)
    sc = scale.reshape(1, H, 1, 1)
    thresh = _keep_thresh(dropout_rate)
    inv_keep = 1.0 / (1.0 - dropout_rate) if dropout_rate > 0 else 1.0
    outs, lses = [], []
    for r0 in range(0, N, _ROW_CHUNK):
        r1 = min(N, r0 + _ROW_CHUNK)
        qk, sq = _qk_sq(metric, q[:, :, r0:r1], k)
        s = _scores_from(metric, qk, sq, sc, D)
        valid = (mask[:, None, r0:r1, :] != 0)
        s = torch.where(valid, s, torch.full_like(s, NEG_INF))
        m = s.amax(-1, keepdim=True)
        p = torch.exp(s - m)
        l = p.sum(-1, keepdim=True)
        if dropout_rate > 0.0:
            dev = q.device
            keep = _keep_bits(
                seed.to(dev, torch.int64).reshape(G, 1, 1, 1),
                torch.arange(H, device=dev).reshape(1, H, 1, 1),
                torch.arange(r0, r1, device=dev).reshape(1, 1, -1, 1),
                torch.arange(N, device=dev).reshape(1, 1, 1, -1)) < thresh
            p = torch.where(keep, p * inv_keep, torch.zeros_like(p))
        acc = p @ v
        dead = m <= NEG_INF
        safe = torch.where(dead, torch.ones_like(l), l)
        outs.append(torch.where(dead, torch.zeros_like(acc), acc / safe))
        lses.append(torch.where(dead, torch.full_like(m, LSE_DEAD),
                                m + torch.log(safe))[..., 0])
    return torch.cat(outs, dim=2), torch.cat(lses, dim=2)


class _FlashForwardKernel:
    """ctypes wrapper of ``tagan_flash_geometric_fwd``; ``launches``
    counts the launches it made. It checks devices, dtypes and shapes
    but trusts the plan's values: pass plans from the builders here or
    through `check_plan`."""
    name = "flash_geometric_fwd"

    def __init__(self):
        self.launches = 0
        self._fn = None

    def _function(self):
        if self._fn is None:
            fn = build.load(self.name).tagan_flash_geometric_fwd
            p, i = ctypes.c_void_p, ctypes.c_int
            fn.argtypes = [p] * 10 + [i] * 8 + [ctypes.c_float, i,
                                                 ctypes.c_uint, ctypes.c_float,
                                                 p]
            fn.restype = i
            self._fn = fn
        return self._fn

    def __call__(self, q, k, v, mask, jlist, jcount, metric: str,
                 scale: torch.Tensor, seed: torch.Tensor,
                 dropout_rate: float) -> Tuple[torch.Tensor, torch.Tensor]:
        G, H, N, D = q.shape
        Dv = v.shape[-1]
        n_i = -(-N // BLOCK_M)
        dev = q.device
        if dev.type != "cuda":
            raise ValueError(f"{self.name}: tensors must be on CUDA, got {dev}")
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (q, k, v, scale)):
            raise NotImplementedError(
                f"{self.name} has no backward kernel yet; run under "
                "torch.no_grad() or on the CPU")
        for name, t, dtype, shape in (
                ("q", q, torch.float32, (G, H, N, D)),
                ("k", k, torch.float32, (G, H, N, D)),
                ("v", v, torch.float32, (G, H, N, Dv)),
                ("mask", mask, None, (G, N, N)),
                ("jlist", jlist, torch.int32, (G, n_i, jlist.shape[-1])),
                ("jcount", jcount, torch.int32, (G, n_i)),
                ("scale", scale, torch.float32, (H,)),
                ("seed", seed, torch.int32, (G,))):
            if t.device != dev:
                raise ValueError(f"{self.name}: {name} on {t.device}, q on {dev}")
            if dtype is not None and t.dtype != dtype:
                raise ValueError(f"{self.name}: {name} must be {dtype}, got {t.dtype}")
            if tuple(t.shape) != shape:
                raise ValueError(f"{self.name}: {name} shape {tuple(t.shape)} != {shape}")
            if not t.is_contiguous():
                raise ValueError(f"{self.name}: {name} must be contiguous")
        if mask.dtype not in (torch.int8, torch.uint8, torch.bool):
            raise ValueError(f"{self.name}: mask must be int8/uint8/bool")
        if not (1 <= D <= 128 and 1 <= Dv <= 128):
            raise ValueError(f"{self.name}: needs 1 <= D, Dv <= 128, "
                             f"got D={D}, Dv={Dv}")
        out = torch.empty((G, H, N, Dv), dtype=torch.float32, device=dev)
        lse = torch.empty((G, H, N), dtype=torch.float32, device=dev)
        inv_keep = 1.0 / (1.0 - dropout_rate) if dropout_rate > 0 else 1.0
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = self._function()(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
                jlist.data_ptr(), jcount.data_ptr(), scale.data_ptr(),
                seed.data_ptr(), out.data_ptr(), lse.data_ptr(),
                G, H, N, D, Dv, n_i, jlist.shape[-1],
                MXU_METRICS.index(metric), math.sqrt(D),
                int(dropout_rate > 0.0), _keep_thresh(dropout_rate),
                inv_keep, stream)
        if err != 0:
            raise RuntimeError(f"{self.name}: CUDA launch failed with "
                               f"cudaError {err}")
        self.launches += 1
        return out, lse


flash_geometric_fwd_kernel = _FlashForwardKernel()


def _forward(q, k, v, mask, jlist, jcount, metric, scale, dropout_rate,
             seed):
    """The dispatch: the plain version for CPU tensors, the CUDA kernel
    otherwise. Trusts the plan."""
    G, H = q.shape[0], q.shape[1]
    if scale is None:
        scale = torch.ones(H, dtype=torch.float32, device=q.device)
    if seed is None:
        seed = torch.zeros(G, dtype=torch.int32, device=q.device)
    if q.device.type == "cpu":
        return flash_geometric_forward_plain(q, k, v, mask, metric, scale,
                                             dropout_rate, seed)
    return flash_geometric_fwd_kernel(q, k, v, mask, jlist, jcount, metric,
                                      scale, seed, dropout_rate)


def flash_geometric_fwd(q, k, v, mask, jlist, jcount, *, metric: str,
                        scale: Optional[torch.Tensor] = None,
                        dropout_rate: float = 0.0,
                        seed: Optional[torch.Tensor] = None):
    """(out, lse) of the batched forward: the plain version for CPU
    tensors, the CUDA kernel otherwise. Shapes as in
    `flash_geometric_forward_plain`; jlist/jcount i32[G, ceil(N/64), W]
    and [G, ceil(N/64)] at the kernel's tile, checked by `check_plan`
    (the plain version does not read them)."""
    check_plan(jlist, jcount, q.shape[2])
    return _forward(q, k, v, mask, jlist, jcount, metric, scale,
                    dropout_rate, seed)


def flash_geometric_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor,
    metric: str = "scaled_dot_product",
    scale_param: Optional[torch.Tensor] = None, plan=None,
    dropout_rate: float = 0.0, dropout_seed: Optional[torch.Tensor] = None,
    return_lse: bool = False,
):
    """Edge-masked attention forward (the TPU package's
    ``flash_geometric_attention`` forward and ``_flash_forward``).

    q, k [..., H, N, D], v [..., H, N, Dv], mask [..., N, N] (True where
    query i attends to key j). Leading dims (snapshots, sequences) fold
    into one kernel launch. ``plan`` is the forward walk (jlist, jcount)
    at the kernel tile, [..., n_i, W] and [..., n_i], checked by
    `check_plan`; built from the mask when omitted. ``dropout_seed`` is
    an int32 per leading index. Returns out [..., H, N, Dv] (zero on rows
    with no valid key) and, with ``return_lse``, lse [..., H, N]
    (``LSE_DEAD`` on those rows)."""
    if plan is None:
        plan = make_block_plan(mask)
    else:
        check_plan(*plan, q.shape[-2])
    return _flash_attention(q, k, v, mask, metric, scale_param, plan,
                            dropout_rate, dropout_seed, return_lse)


def _flash_attention(q, k, v, mask, metric, scale_param, plan,
                     dropout_rate=0.0, dropout_seed=None, return_lse=False):
    """`flash_geometric_attention` with a plan from the builders above,
    taken unchecked (the model's path)."""
    if metric not in MXU_METRICS:
        raise NotImplementedError(
            f"metric {metric} is not written through q.k; use the dense path")
    if dropout_rate > 0.0 and dropout_seed is None:
        raise ValueError("dropout_rate > 0 requires dropout_seed")
    lead = q.shape[:-3]
    H, N, D = q.shape[-3:]
    G = math.prod(lead)
    if metric in _COSINE:
        q, k = _l2_normalize(q), _l2_normalize(k)
    jlist, jcount = plan
    seed = None
    if dropout_seed is not None:
        s = torch.as_tensor(dropout_seed, dtype=torch.int32,
                            device=q.device).reshape(-1)
        seed = (s.expand(G) if s.numel() == 1 else s.reshape(G)).contiguous()
    scale = None if scale_param is None else \
        scale_param.to(torch.float32).contiguous()
    out, lse = _forward(
        q.reshape(G, H, N, D).contiguous(), k.reshape(G, H, N, D).contiguous(),
        v.reshape(G, H, N, v.shape[-1]).contiguous(),
        mask.reshape(G, N, N).contiguous(),
        jlist.reshape(G, *jlist.shape[-2:]).to(torch.int32).contiguous(),
        jcount.reshape(G, -1).to(torch.int32).contiguous(),
        metric, scale, dropout_rate, seed)
    out = out.reshape(*lead, H, N, v.shape[-1])
    if return_lse:
        return out, lse.reshape(*lead, H, N)
    return out
