"""Ring flash attention over the graph axis of a mesh (B9).

Counterpart of ``tagan_tpu/ops/pallas/ring_flash.py``: the rows of q, k,
v [H, N, D] and of the mask [N, N] are sharded over the ranks of the
axis; each rank's K/V chunk circulates around the ring while every rank
folds the chunk it holds into a flash (online-softmax) recurrence for its
own queries, scored with the metric expansion of the flash kernels
(``MXU_METRICS``) and masked by the column block of its mask rows that
the chunk's keys own. At hop s rank ``my`` holds rank (my - s) mod g's
chunk. Rows that no key reaches give exactly 0. Forward only, as on the
TPU. The TPU kernel is block-dense by design: it scores every pair of
every [per, per] block. The port's fold is a pair walk: it lists the
valid columns of the hop's block from the mask rows and scores only
those pairs (``csrc/ring_flash.cu``).

The TPU kernel ``_ring_flash_kernel`` circulates the chunks with remote
DMAs and folds them in one Pallas call. Here each rank of a `Mesh` (often
virtual ranks of one card) has a compute stream and a copy stream: at hop
s the rank's copy stream sends the resident chunk to the right
neighbour's slot (s + 1) mod 3 with the copy kernel ``ring_copy``
(``ops.ring_gather``, ``csrc/ring_gather.cu``), started before hop s's
fold, while its compute stream runs the fold kernel
(``csrc/ring_flash.cu``) on the resident chunk. Unlike the all-gather,
whose output holds every chunk and so takes each one straight into its
rows, a rank here holds three chunks at a time, as on the TPU: its
memory stays three K/V chunks whatever g is, and the slots are reused.
CUDA events order them: a fold or a send of a slot waits for the left
neighbour's send into it, and a send into the right neighbour's slot
waits for that neighbour's hop s - 2 fold and send, the slot's last
reads. Each rank's fold order is fixed, so the result is the same on
every run. The running max, sum and accumulator stay in global memory
between hops.

``bf16=True`` is the TPU kernel's bf16 form: q.k and p.v take bf16
operands with fp32 sums, and p = exp(sc - m_new) is rounded against
m_new, the running max after the whole chunk, so the result depends on
the walk: the plain version and the kernel both take each hop's
chunk-wide row max before forming p, in each rank's own ring order (the
kernel walks the hop's block twice in one launch, first for that max).

CPU tensors take the plain version (`ring_flash_attention_local_plain`,
per rank); CUDA tensors launch the kernels or raise.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import torch

from ..dist.mesh import GRAPH_AXIS, Mesh, gather_rows, shard_rows
from .flash_geometric import (_COSINE, MXU_METRICS, NEG_INF, _F, _I, _P,
                              _check_args, _check_widths, _CudaKernel,
                              _l2_normalize, _mm, _qk_sq, _scores_from)
from .ring_gather import _check_shards, fork, join, record, ring_copy_kernel

# K/V chunks a rank holds: with three, a slot's last reads (hop s - 2's
# fold and send) come one hop before its next write, as on the TPU
SLOTS = 3


def ring_flash_attention_local_plain(
    q: torch.Tensor, ks: Sequence[torch.Tensor], vs: Sequence[torch.Tensor],
    mask: torch.Tensor, rank: int, metric: str,
    scale: Optional[torch.Tensor] = None, bf16: bool = False,
) -> torch.Tensor:
    """What rank ``rank`` of the ring computes: q [H, per, D] (cosine
    metrics: L2-normalised), the chunks ks, vs (g of [H, per, D], rank
    order), its mask rows [per, N]; hop s folds chunk (rank - s) mod g
    against mask columns of that chunk, as the TPU kernel does, the
    whole chunk at once. -> [H, per, D]."""
    g = len(ks)
    H, per, D = q.shape
    if scale is None:
        scale = torch.ones(H, dtype=q.dtype, device=q.device)
    sc = scale.reshape(H, 1, 1)
    m = torch.full((H, per, 1), NEG_INF, dtype=q.dtype, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(q)
    for s in range(g):
        src = (rank - s) % g
        qk, sq = _qk_sq(metric, q, ks[src], bf16)
        z = _scores_from(metric, qk, sq, sc, D)
        valid = mask[None, :, src * per:(src + 1) * per] != 0
        z = torch.where(valid, z, torch.full_like(z, NEG_INF))
        m_new = torch.maximum(m, z.amax(-1, keepdim=True))
        p = torch.exp(z - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + _mm(p, vs[src], bf16)
        m = m_new
    dead = m <= NEG_INF
    safe = torch.where(dead, torch.ones_like(l), l)
    return torch.where(dead, torch.zeros_like(acc), acc / safe)


class _RingFlashFoldKernel(_CudaKernel):
    """B9, ``tagan_ring_flash_fold``: one hop of one rank, a pair walk
    over the hop's column block of the rank's mask rows."""
    name = "ring_flash"
    source = "ring_flash"
    symbol = "tagan_ring_flash_fold"
    argtypes = (_P,) * 9 + (_I,) * 6 + (_F, _I, _I)

    def __call__(self, q, k, v, mask, scale, state, out, col0: int,
                 metric: str, first: bool, last: bool,
                 stream: torch.cuda.Stream) -> None:
        """q, k, v [H, per, D] f32 (k, v the resident chunk), mask [per,
        N] bytes, scale f32[H], state (m, l [H, per], acc [H, per, D]) or
        None when the hop is both first and last, out [H, per, D]."""
        H, per, D = q.shape
        N = mask.shape[-1]
        dev = self._device_of(self.name, q)
        specs = [("q", q, torch.float32, (H, per, D)),
                 ("k", k, torch.float32, (H, per, D)),
                 ("v", v, torch.float32, (H, per, D)),
                 ("mask", mask, None, (per, N)),
                 ("scale", scale, torch.float32, (H,)),
                 ("out", out, torch.float32, (H, per, D))]
        if state is not None:
            specs += [("m", state[0], torch.float32, (H, per)),
                      ("l", state[1], torch.float32, (H, per)),
                      ("acc", state[2], torch.float32, (H, per, D))]
        elif not (first and last):
            raise ValueError(f"{self.name}: a hop of a ring of more than "
                             "one rank needs the state")
        _check_args(self.name, dev, specs)
        if mask.element_size() != 1:
            raise ValueError(f"{self.name}: mask must be int8/uint8/bool")
        _check_widths(self.name, D, D)
        if not 0 <= col0 <= N - per:
            raise ValueError(f"{self.name}: column block {col0} + {per} "
                             f"past N = {N}")
        m, l, acc = (None, None, None) if state is None else \
            (t.data_ptr() for t in state)
        self._launch(dev, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     mask.data_ptr(), scale.data_ptr(), m, l, acc,
                     out.data_ptr(), H, per, N, D, col0,
                     MXU_METRICS.index(metric), math.sqrt(D), int(first),
                     int(last), stream=stream)


class _RingFlashFoldBf16Kernel(_RingFlashFoldKernel):
    """B9's bf16 form, ``tagan_ring_flash_fold_bf16``."""
    name = "ring_flash_bf16"
    symbol = "tagan_ring_flash_fold_bf16"


ring_flash_fold_kernel = _RingFlashFoldKernel()
ring_flash_fold_bf16_kernel = _RingFlashFoldBf16Kernel()
KERNELS = (ring_flash_fold_kernel, ring_flash_fold_bf16_kernel)


def _ring_cuda(mesh, axis, qs, ks, vs, masks, metric, scales, bf16):
    """The ring on the ranks' streams (module docstring)."""
    comp, copy = mesh.ring_streams(axis)
    fold = ring_flash_fold_bf16_kernel if bf16 else ring_flash_fold_kernel
    g = len(qs)
    H, per, D = qs[0].shape
    outs = [torch.empty_like(q) for q in qs]
    state = [None] * g
    kslots = vslots = None
    if g > 1:
        state = [(torch.empty((H, per), device=q.device),
                  torch.empty((H, per), device=q.device),
                  torch.empty_like(q)) for q in qs]
        kslots = [[torch.empty_like(k) for _ in range(SLOTS)] for k in ks]
        vslots = [[torch.empty_like(v) for _ in range(SLOTS)] for v in vs]
    sent = [[None] * g for _ in range(g)]       # [rank][hop], copy streams
    folded = [[None] * g for _ in range(g)]     # [rank][hop], compute
    fork(comp + copy)
    for s in range(g):
        for r in range(g):
            left, right = (r - 1) % g, (r + 1) % g
            # hop 0 folds the rank's own chunk, in place of slot 0
            kc = ks[r] if s == 0 else kslots[r][s % SLOTS]
            vc = vs[r] if s == 0 else vslots[r][s % SLOTS]
            if s < g - 1:
                cs = copy[r]
                if s >= 1:
                    cs.wait_event(sent[left][s - 1])
                if s >= 2:
                    cs.wait_event(folded[right][s - 2])
                    cs.wait_event(sent[right][s - 2])
                ring_copy_kernel(kslots[right][(s + 1) % SLOTS], kc, cs)
                ring_copy_kernel(vslots[right][(s + 1) % SLOTS], vc, cs)
                sent[r][s] = record(cs)
            if s >= 1:
                comp[r].wait_event(sent[left][s - 1])
            fold(qs[r], kc, vc, masks[r], scales[r], state[r], outs[r],
                 ((r - s) % g) * per, metric, s == 0, s == g - 1, comp[r])
            folded[r][s] = record(comp[r])
    join(comp + copy)
    return outs


def ring_flash_attention_local(
    mesh: Mesh, qs: Sequence[torch.Tensor], ks: Sequence[torch.Tensor],
    vs: Sequence[torch.Tensor], masks: Sequence[torch.Tensor],
    axis: str = GRAPH_AXIS, *, metric: str = "scaled_dot_product",
    scale_param: Optional[torch.Tensor] = None, bf16: bool = False,
) -> List[torch.Tensor]:
    """The ring over the ranks of ``axis``, from the ranks' shards: qs,
    ks, vs (rank r's [H, per, D] on its device) and masks (rank r's
    rows [per, N]) -> each rank's [H, per, D] context. The TPU
    function of the same name is one rank's body under ``shard_map``;
    here one call runs every rank."""
    if metric not in MXU_METRICS:
        raise NotImplementedError(metric)
    devs = mesh.ring(axis)
    kind = _check_shards(ring_flash_fold_kernel.name, qs, devs)
    for label, xs in (("k", ks), ("v", vs)):
        if kind != _check_shards(f"{ring_flash_fold_kernel.name} {label}",
                                 xs, devs) or xs[0].shape != qs[0].shape:
            raise ValueError(f"{ring_flash_fold_kernel.name}: {label} "
                             f"shards unlike q's")
    _check_shards(f"{ring_flash_fold_kernel.name} mask", masks, devs)
    H, per, D = qs[0].shape
    _check_widths(ring_flash_fold_kernel.name, D, D)
    rows = (per, per * len(devs))
    if tuple(masks[0].shape) != rows:
        raise ValueError(f"{ring_flash_fold_kernel.name}: mask rows "
                         f"{tuple(masks[0].shape)} != {rows}")
    if metric in _COSINE:
        qs = [_l2_normalize(q) for q in qs]
        ks = [_l2_normalize(k) for k in ks]
    if scale_param is None:
        scale_param = torch.ones(H)
    scales = [scale_param.to(d, torch.float32) for d in devs]
    if kind != "cuda":
        return [ring_flash_attention_local_plain(
            q, ks, vs, m, r, metric, s, bf16)
            for r, (q, m, s) in enumerate(zip(qs, masks, scales))]
    return _ring_cuda(mesh, axis, qs, ks, vs, masks, metric, scales, bf16)


def ring_flash_attention(
    mesh: Mesh, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    mask: torch.Tensor, axis: str = GRAPH_AXIS, *,
    metric: str = "scaled_dot_product",
    scale_param: Optional[torch.Tensor] = None, bf16: bool = False,
) -> torch.Tensor:
    """q, k, v [H, N, D] and mask [N, N] (self loops and validity
    included) sharded by rows over ``axis``, the ring run, and the
    [H, N, D] context gathered back in rank order on q's device."""
    g = mesh.shape[axis]
    H, N, D = q.shape
    if N % g:
        raise ValueError(f"N = {N} rows do not split over {g} ranks")
    if mask.dtype not in (torch.int8, torch.uint8, torch.bool):
        mask = (mask != 0).to(torch.int8)
    outs = ring_flash_attention_local(
        mesh, *(shard_rows(mesh, t, axis, 1) for t in (q, k, v)),
        shard_rows(mesh, mask, axis, 0), axis, metric=metric,
        scale_param=scale_param, bf16=bf16)
    return gather_rows(outs, 1, q.device)
