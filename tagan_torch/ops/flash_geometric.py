"""Block-sparse edge-masked geometric attention, forward and backward.

Counterpart of ``tagan_tpu/ops/pallas/flash_geometric.py``: the score
helpers, the dropout hash, the block-plan builders, the plain PyTorch
versions of the forward and the backward, the wrappers of the CUDA
kernels that port the Pallas ones, and the differentiable entry point:

    B1   _flash_kernel            csrc/flash_geometric_fwd.cu
    B2   _flash_bwd_fused_kernel  csrc/flash_geometric_bwd_fused.cu
    B3a  _flash_bwd_dq_kernel     csrc/flash_geometric_bwd.cu
    B3b  _flash_bwd_dkv_kernel    csrc/flash_geometric_bwd.cu

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


def flash_geometric_backward_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor,
    out: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, metric: str,
    scale: Optional[torch.Tensor] = None, dropout_rate: float = 0.0,
    seed: Optional[torch.Tensor] = None, need_dscale: bool = False,
    dlse: Optional[torch.Tensor] = None,
):
    """What the backward kernels compute (the TPU package's
    ``flash_geometric_attention_bwd``), written out over the same row
    chunks as the plain forward: per pair p = exp(s - lse) on the mask,
    dp = drop(do v^T), ds = p (dp - delta) with delta = rowsum(do out)
    (- dlse), then the metric chain (`_chain_weight`) to dq and dk, dv =
    drop(p)^T do, and for gaussian/rbf d(scale) = sum ds s sq / sigma^3
    or -sum ds s sq. Shapes as in `flash_geometric_forward_plain`; do
    like out, dlse like lse. Returns (dq, dk, dv, dscale f32[H] or
    None). Cosine metrics expect q/k already normalised."""
    G, H, N, D = q.shape
    if scale is None:
        scale = torch.ones(H, dtype=q.dtype, device=q.device)
    sc = scale.reshape(1, H, 1, 1)
    thresh = _keep_thresh(dropout_rate)
    inv_keep = 1.0 / (1.0 - dropout_rate) if dropout_rate > 0 else 1.0
    delta = (do * out).sum(-1)
    if dlse is not None:
        delta = delta - dlse
    sq_metric = metric in _SQ_METRICS
    dq = torch.empty_like(q)
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    wcol = torch.zeros(G, H, N, dtype=q.dtype, device=q.device)
    dsc = torch.zeros(H, dtype=q.dtype, device=q.device)
    for r0 in range(0, N, _ROW_CHUNK):
        r1 = min(N, r0 + _ROW_CHUNK)
        qc, doc = q[:, :, r0:r1], do[:, :, r0:r1]
        qk, sq = _qk_sq(metric, qc, k)
        s = _scores_from(metric, qk, sq, sc, D)
        valid = mask[:, None, r0:r1, :] != 0
        p = torch.exp(torch.where(valid, s - lse[:, :, r0:r1, None],
                                  torch.full_like(s, NEG_INF)))
        dp = doc @ v.transpose(-1, -2)
        pd = p
        if dropout_rate > 0.0:
            keep = _keep_rows(seed, H, r0, r1, N, q.device) < thresh
            dp = torch.where(keep, dp * inv_keep, torch.zeros_like(dp))
            pd = torch.where(keep, p * inv_keep, torch.zeros_like(p))
        ds = p * (dp - delta[:, :, r0:r1, None])
        w = _chain_weight(metric, ds, s, sq, qk, sc, D)
        dqc = w @ k
        if sq_metric:
            dqc = dqc - w.sum(-1, keepdim=True) * qc
            wcol += w.sum(-2)
        dq[:, :, r0:r1] = dqc
        dk += w.transpose(-1, -2) @ qc
        dv += pd.transpose(-1, -2) @ doc
        if need_dscale:
            dsc += (ds * s * sq).sum((0, 2, 3))
    if sq_metric:
        dk -= wcol[..., None] * k
    dscale = None
    if need_dscale:
        dscale = dsc / scale ** 3 if metric == "gaussian_kernel" else -dsc
    return dq, dk, dv, dscale


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

    def _launch(self, dev: torch.device, *args) -> None:
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = self._function()(*args, stream)
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
        if not (1 <= D <= 128 and 1 <= Dv <= 128):
            raise ValueError(f"{name}: needs 1 <= D, Dv <= 128, "
                             f"got D={D}, Dv={Dv}")


def _dropout_args(dropout_rate: float):
    """(use_dropout, keep threshold, 1 / keep) for the kernels."""
    inv_keep = 1.0 / (1.0 - dropout_rate) if dropout_rate > 0 else 1.0
    return int(dropout_rate > 0.0), _keep_thresh(dropout_rate), inv_keep


class _FlashForwardKernel(_CudaKernel):
    """B1, ``tagan_flash_geometric_fwd``: (out, lse) of the forward walk."""
    name = source = "flash_geometric_fwd"
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
    forward walk (jlist, jcount). Deterministic."""
    name = "flash_geometric_bwd_dq"
    source = "flash_geometric_bwd"
    symbol = "tagan_flash_geometric_bwd_dq"
    argtypes = (_P,) * 13 + (_I,) * 8 + (_F, _I, _U, _F, _I)

    def __call__(self, q, k, v, mask, do, lse, delta, jlist, jcount,
                 metric: str, scale, seed, dropout_rate: float,
                 need_dscale: bool):
        args = (q, k, v, mask, do, lse, delta, jlist, jcount, scale, seed)
        dev, (G, H, N, D, Dv, n_i, W) = self._check(*args)
        dq = torch.empty((G, H, N, D), dtype=torch.float32, device=dev)
        part = torch.empty((G, H, n_i) if need_dscale else (1,),
                           dtype=torch.float32, device=dev)
        self._launch(dev, *self._inputs(*args), dq.data_ptr(),
                     part.data_ptr(), G, H, N, D, Dv, n_i, W,
                     MXU_METRICS.index(metric), math.sqrt(D),
                     *_dropout_args(dropout_rate), int(need_dscale))
        return dq, (part.sum((0, 2)) if need_dscale else None)


class _FlashBwdDkvKernel(_FlashBackwardKernel):
    """B3b, ``tagan_flash_geometric_bwd_dkv``: dk and dv over the
    transposed walk (ilist, icount). Deterministic."""
    name = "flash_geometric_bwd_dkv"
    source = "flash_geometric_bwd"
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
    from one walk over the transposed plan (ilist, icount). dq is summed
    with atomics, so its last bits vary from run to run."""
    name = source = "flash_geometric_bwd_fused"
    symbol = "tagan_flash_geometric_bwd_fused"
    argtypes = (_P,) * 15 + (_I,) * 8 + (_F, _I, _U, _F, _I)

    def __call__(self, q, k, v, mask, do, lse, delta, ilist, icount,
                 metric: str, scale, seed, dropout_rate: float,
                 need_dscale: bool):
        args = (q, k, v, mask, do, lse, delta, ilist, icount, scale, seed)
        dev, (G, H, N, D, Dv, n_j, W) = self._check(*args)
        dq = torch.zeros((G, H, N, D), dtype=torch.float32, device=dev)
        dk = torch.empty((G, H, N, D), dtype=torch.float32, device=dev)
        dv = torch.empty((G, H, N, Dv), dtype=torch.float32, device=dev)
        part = torch.empty((G, H, n_j) if need_dscale else (1,),
                           dtype=torch.float32, device=dev)
        self._launch(dev, *self._inputs(*args), dq.data_ptr(), dk.data_ptr(),
                     dv.data_ptr(), part.data_ptr(), G, H, N, D, Dv, n_j, W,
                     MXU_METRICS.index(metric), math.sqrt(D),
                     *_dropout_args(dropout_rate), int(need_dscale))
        return dq, dk, dv, (part.sum((0, 2)) if need_dscale else None)


flash_geometric_fwd_kernel = _FlashForwardKernel()
flash_geometric_bwd_fused_kernel = _FlashBwdFusedKernel()
flash_geometric_bwd_dq_kernel = _FlashBwdDqKernel()
flash_geometric_bwd_dkv_kernel = _FlashBwdDkvKernel()
KERNELS = (flash_geometric_fwd_kernel, flash_geometric_bwd_fused_kernel,
           flash_geometric_bwd_dq_kernel, flash_geometric_bwd_dkv_kernel)

# The backward the picker takes on CUDA when ``fused`` is None: B2
# (single walk, dq by atomics), the faster form at the model's shape (one
# snapshot, H=4, N=10,000, head dim 16): 6.2 ms against 10.4 ms for
# B3a + B3b on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py phase 5;
# PERF.md, Findings).
FUSED_BWD = True


# ---------------------------------------------------------------------------
# Dispatch: the plain versions for CPU tensors, the kernels otherwise
# ---------------------------------------------------------------------------

def _forward(q, k, v, mask, jlist, jcount, metric, scale, dropout_rate,
             seed):
    """(out, lse) of folded [G, H, N, .] inputs; trusts the plan. scale
    f32[H] and seed i32[G] are given."""
    if q.device.type == "cpu":
        return flash_geometric_forward_plain(q, k, v, mask, metric, scale,
                                             dropout_rate, seed)
    return flash_geometric_fwd_kernel(q, k, v, mask, jlist, jcount, metric,
                                      scale, seed, dropout_rate)


def _transposed_plan(mask: torch.Tensor):
    occ = _occ_from_mask(mask, BLOCK_M, BLOCK_N)
    return _plan_from_occ(occ.transpose(-1, -2))


def _backward(q, k, v, mask, out, lse, do, plan, plan_t, metric, scale,
              dropout_rate, seed, need_dscale, fused, dlse):
    """(dq, dk, dv, dscale or None) of folded inputs; trusts the plans.
    ``plan_t`` None is built from the mask where a kernel walks it."""
    if q.device.type == "cpu":
        return flash_geometric_backward_plain(
            q, k, v, mask, out, lse, do, metric, scale, dropout_rate, seed,
            need_dscale, dlse)
    delta = (do * out).sum(-1)
    if dlse is not None:
        delta = delta - dlse
    delta = delta.contiguous()
    fused = FUSED_BWD if fused is None else fused
    if plan_t is None:
        plan_t = _transposed_plan(mask)
    if fused:
        return flash_geometric_bwd_fused_kernel(
            q, k, v, mask, do, lse, delta, *plan_t, metric, scale, seed,
            dropout_rate, need_dscale)
    dq, dscale = flash_geometric_bwd_dq_kernel(
        q, k, v, mask, do, lse, delta, *plan, metric, scale, seed,
        dropout_rate, need_dscale)
    dk, dv = flash_geometric_bwd_dkv_kernel(
        q, k, v, mask, do, lse, delta, *plan_t, metric, scale, seed,
        dropout_rate)
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
                        seed: Optional[torch.Tensor] = None):
    """(out, lse) of the batched forward: the plain version for CPU
    tensors, the CUDA kernel otherwise. Shapes as in
    `flash_geometric_forward_plain`; jlist/jcount i32[G, ceil(N/64), W]
    and [G, ceil(N/64)] at the kernel's tile, checked by `check_plan`
    (the plain version does not read them)."""
    check_plan(jlist, jcount, q.shape[2])
    scale, seed = _defaults(q, scale, seed)
    return _forward(q, k, v, mask, jlist, jcount, metric, scale,
                    dropout_rate, seed)


def flash_geometric_attention_bwd(
    q, k, v, mask, out, lse, do, *, metric: str = "scaled_dot_product",
    scale: Optional[torch.Tensor] = None, plan=None, plan_t=None,
    seed: Optional[torch.Tensor] = None, dropout_rate: float = 0.0,
    need_dscale: bool = False, fused: Optional[bool] = None,
    dlse: Optional[torch.Tensor] = None,
):
    """The backward of the batched forward (the TPU package's
    ``flash_geometric_attention_bwd``): (dq, dk, dv), plus dscale f32[H]
    with ``need_dscale``. Folded shapes as in `flash_geometric_fwd`; out
    and lse are the forward's, do and dlse their cotangents. Cosine
    metrics expect q/k already normalised. Plans given by the caller are
    checked; missing ones are built from the mask.

    CPU tensors take the plain version. CUDA tensors take B2
    (``fused=True``: one walk over the transposed plan, dq by atomics) or
    B3a then B3b (``fused=False``: the forward walk for dq and dscale, the
    transposed walk for dk and dv). ``fused=None`` takes `FUSED_BWD`,
    which is B2: at the model's shape B2 took 6.2 ms and B3a + B3b 10.4
    ms on the H100, and one recompute of each pair should keep B2 ahead
    at any shape whose walk visits many pairs. Unlike the TPU's rule (a
    scoped-VMEM budget) nothing depends on the size: both forms use
    fixed 64 x 64 tiles and O(N D) memory besides the mask. B2 sums dq
    with atomics, so its last bits vary from run to run; ``fused=False``
    is deterministic."""
    N = q.shape[2]
    if plan is None:
        plan, plan_t = make_block_plans_from_mask(mask)
    else:
        check_plan(*plan, N)
        if plan_t is not None:
            check_plan(*plan_t, N)
    scale, seed = _defaults(q, scale, seed)
    dq, dk, dv, dscale = _backward(q, k, v, mask, out, lse, do, plan, plan_t,
                                   metric, scale, dropout_rate, seed,
                                   need_dscale, fused, dlse)
    return (dq, dk, dv, dscale) if need_dscale else (dq, dk, dv)


class _FlashAttention(torch.autograd.Function):
    """The differentiable forward of folded inputs (the TPU package's
    ``_flash_diff`` and ``_flash_diff_scaled``): B1 forward, the picked
    backward (or the plain versions on the CPU). Returns (out, lse); the
    cotangent of lse rides on delta. dscale is formed only when the scale
    requires grad."""

    @staticmethod
    def forward(ctx, q, k, v, scale, mask, jlist, jcount, ilist, icount,
                seed, metric, dropout_rate):
        out, lse = _forward(q, k, v, mask, jlist, jcount, metric, scale,
                            dropout_rate, seed)
        ctx.save_for_backward(q, k, v, scale, mask, out, lse, jlist, jcount,
                              ilist, icount, seed)
        ctx.args = (metric, dropout_rate)
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    def backward(ctx, dout, dlse):
        (q, k, v, scale, mask, out, lse, jlist, jcount, ilist, icount,
         seed) = ctx.saved_tensors
        metric, dropout_rate = ctx.args
        if dout is None:
            dout = torch.zeros_like(out)
        need_dscale = ctx.needs_input_grad[3] and metric in SCALED_METRICS
        dq, dk, dv, dscale = _backward(
            q, k, v, mask, out, lse, dout.contiguous(), (jlist, jcount),
            None if ilist is None else (ilist, icount), metric, scale,
            dropout_rate, seed, need_dscale, None,
            None if dlse is None else dlse.contiguous())
        if ctx.needs_input_grad[3] and dscale is None:
            dscale = torch.zeros_like(scale)
        return (dq, dk, dv, dscale) + (None,) * 8


def flash_geometric_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor,
    metric: str = "scaled_dot_product",
    scale_param: Optional[torch.Tensor] = None, plan=None, plan_t=None,
    dropout_rate: float = 0.0, dropout_seed: Optional[torch.Tensor] = None,
    return_lse: bool = False,
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
    requires one."""
    if plan is None:
        plan, plan_t = make_block_plans_from_mask(mask)
    else:
        check_plan(*plan, q.shape[-2])
        if plan_t is not None:
            check_plan(*plan_t, q.shape[-2])
    return _flash_attention(q, k, v, mask, metric, scale_param, plan,
                            dropout_rate, dropout_seed, return_lse, plan_t)


def _flash_attention(q, k, v, mask, metric, scale_param, plan,
                     dropout_rate=0.0, dropout_seed=None, return_lse=False,
                     plan_t=None):
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
    seed = torch.zeros(G, dtype=torch.int32, device=q.device)
    if dropout_seed is not None:
        s = torch.as_tensor(dropout_seed, dtype=torch.int32,
                            device=q.device).reshape(-1)
        seed = (s.expand(G) if s.numel() == 1 else s.reshape(G)).contiguous()
    scale = torch.ones(H, dtype=torch.float32, device=q.device) \
        if scale_param is None else scale_param.to(torch.float32).contiguous()

    def fold_plan(p):
        if p is None:
            return None, None
        lst, cnt = p
        return (lst.reshape(G, *lst.shape[-2:]).to(torch.int32).contiguous(),
                cnt.reshape(G, -1).to(torch.int32).contiguous())

    out, lse = _FlashAttention.apply(
        q.reshape(G, H, N, D).contiguous(), k.reshape(G, H, N, D).contiguous(),
        v.reshape(G, H, N, Dv).contiguous(), scale,
        mask.reshape(G, N, N).contiguous(), *fold_plan(plan),
        *fold_plan(plan_t), seed, metric, dropout_rate)
    out = out.reshape(*lead, H, N, Dv)
    if return_lse:
        return out, lse.reshape(*lead, H, N)
    return out
