#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``tagan_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:

1. the card's name and power limit; build the CUDA kernels from
   ``tagan_torch/csrc`` (all ``nvcc`` processes at once) and print each
   kernel's registers and spill from ptxas;
2. the forward kernel B1 against its plain PyTorch version on the card at
   small shapes: every metric, dead rows and an empty query tile, N not a
   multiple of the tile, D != Dv, per-head scales, dropout 0 and 0.1;
   (2b) the backward kernels, B2 and B3a + B3b, against the plain
   backward on the same grid plus learnable scales (dscale), an empty key
   strip, an lse cotangent and (D, Dv) of (7, 3), (40, 72), (128, 128);
3. the serving path: ``Predictor`` serving 3 requests of 2 sequences at
   the width ``bench.py`` runs (10,000 nodes, 160,000 random edges per
   snapshot, 8 snapshots, hidden 64, 4 heads, 2 flash layers) with random
   weights from a seed; launch counts set to 0 just before and read just
   after; the forward alone, and one layer's B1 launch over the request's
   folded snapshots, timed; then the first layer's B1 output on one
   snapshot against the plain version at full width;
4. end to end at 1,000 nodes: the same Predictor's probabilities on the
   card (kernels) and on the CPU (plain versions), and the per-node
   features after the attention layers (``encode_spatial``);
5. times at the main path's shape (one snapshot, 4 heads, 10,000 nodes,
   head dim 16) with CUDA events, in turns: B1, B2, B3a, B3b and
   B3a + B3b against the plain versions, and ``scaled_dot_product_attention``
   (forward; backward = forward+backward - forward) with the boolean mask
   as the library yardstick; each kernel's bound from this run's inputs;
6. the training path at the same width: ``TAGANTrainer.train`` on one
   sequence per batch, one warm-up step, then 3 steps with the picker's
   default backward and 3 with the other form, launch counts set to 0
   just before each and read just after; step times (host clock around a
   synchronising step), the forward / backward / optimizer split (CUDA
   events), one layer's B1 and backward launches over the 8 folded
   snapshots and their share of the step, finite losses, finite non-zero
   gradients and parameters moved after the warm-up; then one snapshot
   at full width, both backward forms against the plain backward;
7. training at 1,000 nodes on the card and on the CPU from the same
   weights and batches: the first step's gradients and the losses and
   parameters of 3 AdamW steps.

The last two lines are the ``{"kernels": [...]}`` record and
``{"ok": true, "device": {...}}``. A copy of the measurements goes to
``chiprun_out/chip_smoke.json``. Exits non-zero without CUDA.
"""

import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

DEV = "cuda"
PEAK_FP32_FLOPS = 67e12     # H100 SXM, fp32 outside the tensor cores
PEAK_BYTES = 3.35e12        # H100 SXM HBM3
# fp32 kernel vs plain version, sums in another order (and dq by atomics
# under B2): max abs error, taken over the largest entry (at least 1)
# where gradients span many scales
TOL = 1e-4

N_FULL, E_FULL, T_FULL, F_NODE = 10_000, 160_000, 8, 16
REQUESTS, SEQS_PER_REQUEST = 3, 2
N_MID = 1_000
TRAIN_STEPS = 3
# gradients that are zero in exact arithmetic (a bias that adds one
# constant to every score of a softmax row): fp32 noise on the card
ZERO_GRAD = ("temporal_attention.k.b",
             "temporal_attention.time_encoding.basis_proj.b",
             "temporal_attention.time_q_proj.b")
FG_SRC = "tagan_tpu/ops/pallas/flash_geometric.py"


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def sync():
    torch.cuda.synchronize()


def cuda_ms(fn, iters):
    fn()
    sync()
    t0, t1 = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    sync()
    return t0.elapsed_time(t1) / iters


def reset_counts(FG):
    for k in FG.KERNELS:
        k.launches = 0


def counts(FG):
    return {k.name: k.launches for k in FG.KERNELS}


def rel_err(got, want):
    return ((got - want).abs().max()
            / want.abs().max().clamp(min=1.0)).item()


# -- phase 1 ------------------------------------------------------------------

def phase_build(build, FG):
    t0 = time.perf_counter()
    build.build([k.source for k in FG.KERNELS])
    log(f"[1] kernels built in {time.perf_counter() - t0:.3f} s")
    for name, text in build.build_logs.items():
        fn = "?"
        for line in text.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                k = re.search(r"(\w+_kernel)(I(?:Li\d+E)+E)?", m.group(1))
                fn = k.group(1) if k else m.group(1)
                if k and k.group(2):
                    fn += "<" + ",".join(re.findall(r"Li(\d+)E",
                                                    k.group(2))) + ">"
            elif "registers" in line or "spill" in line:
                log(f"[1] {name} {fn}: {line.strip()}")


# -- phase 2 ------------------------------------------------------------------

def small_inputs(FG, G, H, N, D, Dv, metric, seed):
    """Random q, k, v, cotangents do and dlse, and an int8 mask with
    dead rows (one of them the last row), an empty query tile and an
    empty key strip where N and G allow. The cotangents are 0.25 x
    N(0, 1), so that the gradients are of order 1 and an absolute
    error means what it says (with N(0, 1) cotangents the squared
    metrics give gradients near 20, whose fp32 resolution is ~1e-5)."""
    g = torch.Generator(device=DEV).manual_seed(seed)
    q = torch.randn(G, H, N, D, device=DEV, generator=g)
    k = torch.randn(G, H, N, D, device=DEV, generator=g)
    v = torch.randn(G, H, N, Dv, device=DEV, generator=g)
    do = 0.25 * torch.randn(G, H, N, Dv, device=DEV, generator=g)
    dlse = 0.25 * torch.randn(G, H, N, device=DEV, generator=g)
    if metric in FG._COSINE:
        q, k = FG._l2_normalize(q), FG._l2_normalize(k)
    mask = (torch.rand(G, N, N, device=DEV, generator=g) < 0.1).to(torch.int8)
    mask[0, 5] = 0
    mask[0, N - 1] = 0
    if N > 2 * FG.BLOCK_M:
        mask[0, :, FG.BLOCK_N:2 * FG.BLOCK_N] = 0   # a key strip, no queries
        if G > 1:
            mask[1, FG.BLOCK_M:2 * FG.BLOCK_M] = 0  # a query tile, no keys
    scale = torch.linspace(0.7, 2.0, H, device=DEV) \
        if metric in FG.SCALED_METRICS else torch.ones(H, device=DEV)
    seeds = torch.tensor([12345, -7, 2 ** 31 - 1, 0][:G], dtype=torch.int32,
                         device=DEV)
    return q, k, v, do, dlse, mask, scale, seeds


def kernel_vs_plain(FG, G, H, N, D, Dv, metric, rate, seed=0):
    """B1 against the plain forward; returns the max abs error of out and
    lse over live rows after checking dead rows exactly."""
    q, k, v, _, _, mask, scale, seeds = small_inputs(FG, G, H, N, D, Dv,
                                                     metric, seed)
    jlist, jcount = FG.make_block_plan(mask)
    out, lse = FG.flash_geometric_fwd_kernel(
        q, k, v, mask, jlist, jcount, metric, scale, seeds, rate)
    sync()
    p_out, p_lse = FG.flash_geometric_forward_plain(
        q, k, v, mask, metric, scale, rate, seeds)
    sync()
    dead = (mask == 0).all(-1)[:, None, :].expand(G, H, N)
    if not (torch.all(out[dead] == 0) and torch.all(lse[dead] == FG.LSE_DEAD)
            and torch.all(p_out[dead] == 0)
            and torch.all(p_lse[dead] == FG.LSE_DEAD)):
        raise AssertionError(f"{metric} rate={rate}: dead rows differ")
    err = max((out - p_out)[~dead].abs().max().item(),
              (lse - p_lse)[~dead].abs().max().item())
    if not err <= TOL:
        raise AssertionError(f"{metric} rate={rate} D={D} Dv={Dv}: "
                             f"max abs err {err} > {TOL}")
    return err


def phase_small(FG):
    errs = []
    for metric in FG.MXU_METRICS:
        for rate in (0.0, 0.1):
            errs.append(kernel_vs_plain(FG, 2, 3, 150, 16, 8, metric, rate))
    for metric, D, Dv in (("euclidean", 40, 72), ("gaussian_kernel", 128, 128),
                          ("dot_product", 7, 3)):
        errs.append(kernel_vs_plain(FG, 2, 2, 200, D, Dv, metric, 0.1, 1))
    log(f"[2] B1 vs plain: {len(errs)} cases, max abs err {max(errs):.3e}"
        f" (tol {TOL})")
    return max(errs)


def check_backward(label, got, want, fused):
    """{output: error} of one backward form against the plain backward:
    the max abs error of dq, dk and dv, and of dscale over its largest
    entry (at least 1); raises where an output's error over its largest
    entry (at least 1) passes TOL."""
    errs, rel = {}, {}
    for name, g, w in zip(("dq", "dk", "dv"), got[:3], want[:3]):
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{label} fused={fused}: non-finite {name}")
        errs[name], rel[name] = (g - w).abs().max().item(), rel_err(g, w)
    errs["dscale"] = rel["dscale"] = \
        rel_err(got[3], want[3]) if want[3] is not None else 0.0
    if not max(rel.values()) <= TOL:
        raise AssertionError(f"{label} fused={fused}: errors {rel} > {TOL}")
    return errs


def kernel_errors(res):
    """Each kernel's error from its own outputs, given {fused: {output:
    error}}: B2 all of them, B3a dq and dscale, B3b dk and dv."""
    return {"B2": max(res[True].values()),
            "B3a": max(res[False]["dq"], res[False]["dscale"]),
            "B3b": max(res[False]["dk"], res[False]["dv"])}


def backward_vs_plain(FG, G, H, N, D, Dv, metric, rate, seed=0):
    """B2 and B3a + B3b against the plain backward on one input; returns
    {fused: {output: error}} (`check_backward`)."""
    q, k, v, do, dlse, mask, scale, seeds = small_inputs(
        FG, G, H, N, D, Dv, metric, seed)
    need = metric in FG.SCALED_METRICS
    out, lse = FG.flash_geometric_forward_plain(q, k, v, mask, metric, scale,
                                                rate, seeds)
    plan, plan_t = FG.make_block_plans_from_mask(mask)
    want = FG.flash_geometric_backward_plain(q, k, v, mask, out, lse, do,
                                             metric, scale, rate, seeds,
                                             need, dlse)
    res = {}
    for fused in (True, False):
        got = FG._backward(q, k, v, mask, out, lse, do, plan, plan_t, metric,
                           scale, rate, seeds, need, fused, dlse)
        sync()
        res[fused] = check_backward(f"{metric} rate={rate} D={D} Dv={Dv}",
                                    got, want, fused)
    return res


def phase_small_bwd(FG):
    errs = []
    for metric in FG.MXU_METRICS:
        for rate in (0.0, 0.1):
            errs.append(backward_vs_plain(FG, 2, 3, 150, 16, 8, metric, rate))
    for D, Dv in ((7, 3), (40, 72), (128, 128)):
        errs.append(backward_vs_plain(FG, 2, 2, 200, D, Dv, "gaussian_kernel",
                                      0.1, 1))
    out = {name: max(kernel_errors(e)[name] for e in errs)
           for name in ("B2", "B3a", "B3b")}
    log(f"[2b] backward vs plain: {len(errs)} cases; max err B2 (dq, dk, dv, "
        f"dscale) {out['B2']:.3e}, B3a (dq, dscale) {out['B3a']:.3e}, B3b "
        f"(dk, dv) {out['B3b']:.3e} (tol {TOL})")
    return out


# -- phase 3 ------------------------------------------------------------------

def make_sequence(rng, n, e, t_len):
    return [{"x": rng.standard_normal((n, F_NODE)).astype(np.float32),
             "edge_index": np.stack([rng.integers(0, n, e),
                                     rng.integers(0, n, e)]),
             "node_ids": np.arange(n), "timestep": float(t)}
            for t in range(t_len)]


def model_config(tt):
    return tt.TAGANConfig(hidden_dim=64, num_heads=4, num_layers=2,
                          node_feature_dim=F_NODE, output_dim=1,
                          loss_type="bce", dropout=0.0,
                          spatial_backend="flash")


def layer0_inputs(FG, model, batch, n):
    """Layer 0's kernel inputs of a packed batch, its B*T snapshots folded
    as the model folds them: (q, k, v, mask, jlist, jcount, ilist,
    icount)."""
    from tagan_torch.nn.model import flash_structures
    attn = model.geometric_layers["layer_0"].attn
    with torch.no_grad():
        q, k, v = attn._qkv(model.node_embedding(batch.x))   # [B, T, H, N, Dh]
        mask, plan, plan_t = flash_structures(
            batch.edge_src, batch.edge_dst, batch.edge_mask, batch.node_mask,
            n)
    G = q.shape[0] * q.shape[1]
    return tuple(t.reshape(G, *t.shape[2:]).contiguous()
                 for t in (q, k, v, mask, *plan, *plan_t))


def phase_serve(tt, FG):
    cfg = model_config(tt)
    model = tt.TAGAN(cfg, device=DEV,
                     generator=torch.Generator().manual_seed(0))
    dims = (T_FULL, N_FULL, E_FULL, 0)
    pred = tt.Predictor(model, dims=dims, batch_size=SEQS_PER_REQUEST)
    rng = np.random.default_rng(0)
    requests = [[make_sequence(rng, N_FULL, E_FULL, T_FULL)
                 for _ in range(SEQS_PER_REQUEST)] for _ in range(REQUESTS)]
    pred.warmup()
    sync()

    reset_counts(FG)
    lat, probs = [], []
    for req in requests:
        t0 = time.perf_counter()
        probs.append(pred.predict_proba(req))   # host copy: synchronises
        lat.append((time.perf_counter() - t0) * 1e3)
    launched = counts(FG)
    launches = launched[FG.flash_geometric_fwd_kernel.name]
    expected = cfg.num_layers * REQUESTS      # one launch per layer per batch
    probs = np.concatenate(probs)
    finite = bool(np.isfinite(probs).all())
    log(f"[3] request latency ms: {[round(x, 3) for x in lat]}; "
        f"sequences/s {REQUESTS * SEQS_PER_REQUEST / (sum(lat) / 1e3):.3f}; "
        f"kernel launches {launched} (expected B1 {expected}, no backward); "
        f"probabilities finite: {finite}, shape {probs.shape}")
    if launches != expected or launches == 0 or \
            sum(launched.values()) != launches:
        raise AssertionError(f"launches {launched}, expected B1 {expected}")
    if not finite or probs.shape != (REQUESTS * SEQS_PER_REQUEST, 1):
        raise AssertionError("bad probabilities")

    # forward alone on a packed batch (no host packing)
    batch = tt.batch_sequences(pred._pack(requests[0])).to(DEV)
    with torch.inference_mode():
        model(batch)
        sync()
        t0 = time.perf_counter()
        model(batch)
        sync()
        fwd_ms = (time.perf_counter() - t0) * 1e3
    log(f"[3] forward on a packed request: {fwd_ms:.3f} ms")

    H = cfg.num_heads
    folded = layer0_inputs(FG, model, batch, N_FULL)
    G = folded[0].shape[0]
    ones = torch.ones(H, device=DEV)
    seeds = torch.zeros(G, dtype=torch.int32, device=DEV)
    with torch.inference_mode():
        layer_ms = cuda_ms(lambda: FG.flash_geometric_fwd_kernel(
            *folded[:6], "euclidean", ones, seeds, 0.0), 3)
        # one snapshot at full width against the plain version
        args = tuple(t[:1].contiguous() for t in folded)
        out, lse = FG.flash_geometric_fwd_kernel(
            *args[:6], "euclidean", ones, seeds[:1], 0.0)
        p_out, p_lse = FG.flash_geometric_forward_plain(
            *args[:4], "euclidean", ones, 0.0, seeds[:1])
        sync()
    share = cfg.num_layers * layer_ms / fwd_ms
    log(f"[3] one layer's launch over the {G} folded snapshots: "
        f"{layer_ms:.3f} ms; {cfg.num_layers} layers = {share:.3f} of the "
        f"forward")
    err = max((out - p_out).abs().max().item(),
              (lse - p_lse).abs().max().item())
    log(f"[3] layer-0 kernel vs plain at N={N_FULL}: max abs err {err:.3e}")
    if not err <= TOL:
        raise AssertionError(f"full-width kernel error {err} > {TOL}")
    return dict(latency_ms=lat, launches=launches, expected=expected,
                forward_ms=fwd_ms, layer_launch_ms=layer_ms,
                kernel_share_of_forward=share, full_err=err, args=args,
                sequences_per_s=REQUESTS * SEQS_PER_REQUEST / (sum(lat) / 1e3))


# -- phase 4 ------------------------------------------------------------------

def phase_mid(tt, FG):
    cfg = model_config(tt)
    rng = np.random.default_rng(1)
    req = [make_sequence(rng, N_MID, 16 * N_MID, T_FULL)
           for _ in range(SEQS_PER_REQUEST)]
    dims = (T_FULL, N_MID, 16 * N_MID, 0)
    got, launched, nodes = {}, {}, {}
    for side, dev in (("card", DEV), ("cpu", "cpu")):
        model = tt.TAGAN(cfg, device=dev,
                         generator=torch.Generator().manual_seed(0))
        pred = tt.Predictor(model, dims=dims)
        before = FG.flash_geometric_fwd_kernel.launches
        got[side] = pred.predict_proba(req)
        launched[side] = FG.flash_geometric_fwd_kernel.launches - before
        # the per-node features before pooling, where a fault in one row
        # tile of the kernel is not averaged away
        batch = tt.batch_sequences(pred._pack(req)).to(dev)
        with torch.inference_mode():
            nodes[side] = model.encode_spatial(batch).cpu()
    err = float(np.abs(got["card"] - got["cpu"]).max())
    node_err = (nodes["card"] - nodes["cpu"]).abs().max().item()
    log(f"[4] N={N_MID} probabilities card vs cpu: "
        f"{got['card'].ravel().tolist()} vs {got['cpu'].ravel().tolist()}; "
        f"max abs err {err:.3e}; per-node features after the attention "
        f"layers {tuple(nodes['cpu'].shape)}: max abs err {node_err:.3e}; "
        f"kernel launches card {launched['card']}, cpu {launched['cpu']}")
    if launched != {"card": cfg.num_layers, "cpu": 0}:
        raise AssertionError(f"launches {launched}")
    if not (err <= TOL and node_err <= TOL):
        raise AssertionError(f"end-to-end error {err}, per-node error "
                             f"{node_err} > {TOL}")
    return dict(prob_err=err, node_err=node_err)


# -- phase 5 ------------------------------------------------------------------

def bound(nbytes, flops):
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_flops = flops / PEAK_FP32_FLOPS * 1e3
    return dict(bound_ms=max(t_bytes, t_flops),
                bound_by="bytes" if t_bytes >= t_flops else "operations",
                bytes=nbytes, flops=flops)


def phase_times(FG, args):
    q, k, v, mask, jlist, jcount, ilist, icount = args
    G, H, N, D = q.shape
    Dv = v.shape[-1]
    ones = torch.ones(H, device=DEV)
    seed0 = torch.zeros(G, dtype=torch.int32, device=DEV)
    fwd = FG.flash_geometric_fwd_kernel

    def kernel():
        fwd(q, k, v, mask, jlist, jcount, "euclidean", ones, seed0, 0.0)

    def kernel_sdp():
        fwd(q, k, v, mask, jlist, jcount, "scaled_dot_product", ones, seed0,
            0.0)

    def plain():
        FG.flash_geometric_forward_plain(q, k, v, mask, "euclidean", ones,
                                         0.0, seed0)
    bmask = (mask[:, None] != 0)

    def library():
        torch.nn.functional.scaled_dot_product_attention(
            q, k, v, attn_mask=bmask)

    with torch.inference_mode():
        p1 = cuda_ms(plain, 5)
        k1 = cuda_ms(kernel, 20)
        k2 = cuda_ms(kernel, 20)
        p2 = cuda_ms(plain, 5)
        lib = cuda_ms(library, 20)
        k_sdp = cuda_ms(kernel_sdp, 20)
    with torch.no_grad():
        out, lse = fwd(q, k, v, mask, jlist, jcount, "euclidean", ones,
                       seed0, 0.0)
    pairs = int((mask != 0).sum().item())                 # valid (i, j)
    walk_pairs = int(jcount.sum().item()) * FG.BLOCK_M * FG.BLOCK_N
    qkv = 4 * G * H * N * (2 * D + Dv)
    nbytes = (qkv + mask.numel() + 4 * (jlist.numel() + jcount.numel() + H + G)
              + 4 * G * H * N * (Dv + 1))                   # out, lse
    res = dict(kernel_ms=[k1, k2], plain_ms=[p1, p2], library_ms=lib,
               kernel_sdp_ms=k_sdp, valid_pairs=pairs, walk_pairs=walk_pairs,
               walk_flops_ms=2 * H * walk_pairs * (D + Dv)
               / PEAK_FP32_FLOPS * 1e3,
               **bound(nbytes, 2 * H * pairs * (D + Dv)))   # q.k and p.v
    log(f"[5] H={H} N={N} D={D} Dv={Dv}, one snapshot: B1 ms {k1:.4f} "
        f"{k2:.4f}; plain ms {p1:.4f} {p2:.4f}; sdpa ms {lib:.4f} (B1 at "
        f"the same metric {k_sdp:.4f})")
    log(f"[5] B1 bound {res['bound_ms']:.5f} ms by {res['bound_by']} "
        f"({nbytes} bytes, {res['flops']} flops over {pairs} valid pairs); "
        f"the walk visits {walk_pairs} pairs = {res['walk_flops_ms']:.5f} ms "
        f"of fp32 math at peak")
    res["bwd"] = backward_times(FG, args, out, lse, pairs)
    return res


def backward_times(FG, args, out, lse, pairs):
    """B2, B3a, B3b and B3a + B3b against the plain backward and the
    backward of ``scaled_dot_product_attention``, with their bounds."""
    q, k, v, mask, jlist, jcount, ilist, icount = args
    G, H, N, D = q.shape
    Dv = v.shape[-1]
    ones = torch.ones(H, device=DEV)
    seed0 = torch.zeros(G, dtype=torch.int32, device=DEV)
    do = torch.randn(out.shape, device=DEV,
                     generator=torch.Generator(device=DEV).manual_seed(5))
    delta = (do * out).sum(-1)
    common = (q, k, v, mask, do, lse, delta)

    def b2():
        FG.flash_geometric_bwd_fused_kernel(*common, ilist, icount,
                                            "euclidean", ones, seed0, 0.0,
                                            False)

    def b3a():
        FG.flash_geometric_bwd_dq_kernel(*common, jlist, jcount, "euclidean",
                                         ones, seed0, 0.0, False)

    def b3b():
        FG.flash_geometric_bwd_dkv_kernel(*common, ilist, icount,
                                          "euclidean", ones, seed0, 0.0)

    def b3():
        b3a()
        b3b()

    def plain():
        FG.flash_geometric_backward_plain(q, k, v, mask, out, lse, do,
                                          "euclidean", ones, 0.0, seed0)

    bmask = (mask[:, None] != 0)
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def lib_fb():
        o = sdpa(*leaves, attn_mask=bmask)
        torch.autograd.grad(o, leaves, do)

    def lib_f():
        with torch.no_grad():
            sdpa(*leaves, attn_mask=bmask)

    p1 = cuda_ms(plain, 3)
    f1, s1 = cuda_ms(b2, 10), cuda_ms(b3, 10)
    s2, f2 = cuda_ms(b3, 10), cuda_ms(b2, 10)
    p2 = cuda_ms(plain, 3)
    ta, tb = cuda_ms(b3a, 10), cuda_ms(b3b, 10)
    lib = cuda_ms(lib_fb, 5) - cuda_ms(lib_f, 5)
    HN = G * H * N
    reads = (4 * HN * (2 * D + 2 * Dv) + 8 * HN          # q k v do lse delta
             + mask.numel() + 4 * (H + G))
    plan_b = 4 * (jlist.numel() + jcount.numel())
    plan_tb = 4 * (ilist.numel() + icount.numel())
    res = {
        "B2": dict(ms=[f1, f2], **bound(
            reads + plan_tb + 4 * HN * (2 * D + Dv),
            2 * H * pairs * (3 * D + 2 * Dv))),
        "B3a": dict(ms=[ta], **bound(reads + plan_b + 4 * HN * D,
                                     2 * H * pairs * (2 * D + Dv))),
        "B3b": dict(ms=[tb], **bound(reads + plan_tb + 4 * HN * (D + Dv),
                                     2 * H * pairs * (2 * D + 2 * Dv))),
        "B3a+B3b_ms": [s1, s2], "plain_ms": [p1, p2], "library_ms": lib}
    log(f"[5] backward, one snapshot: B2 ms {f1:.4f} {f2:.4f}; B3a+B3b ms "
        f"{s1:.4f} {s2:.4f} (B3a {ta:.4f}, B3b {tb:.4f}); plain ms {p1:.4f} "
        f"{p2:.4f}; sdpa backward ms {lib:.4f}")
    for name in ("B2", "B3a", "B3b"):
        r = res[name]
        log(f"[5] {name} bound {r['bound_ms']:.5f} ms by {r['bound_by']} "
            f"({r['bytes']} bytes, {r['flops']} flops)")
    return res


# -- phase 6 ------------------------------------------------------------------

def phase_train(tt, FG):
    cfg = model_config(tt)
    model = tt.TAGAN(cfg, device=DEV,
                     generator=torch.Generator().manual_seed(0))
    exp = tt.ExperimentConfig(model=cfg, batch_size=1, num_epochs=1, seed=0,
                              checkpoint_dir="", shuffle=False)
    rng = np.random.default_rng(2)
    ds = tt.TemporalGraphDataset(
        [make_sequence(rng, N_FULL, E_FULL, T_FULL)
         for _ in range(TRAIN_STEPS + 1)], [1.0, 0.0, 1.0, 0.0])
    kw = dict(batch_size=1, dense_adj=False, max_time=T_FULL,
              max_nodes=N_FULL, max_edges=E_FULL)
    warm = tt.TemporalGraphDataLoader(ds.subset([0]), **kw)
    loader = tt.TemporalGraphDataLoader(
        ds.subset(list(range(1, TRAIN_STEPS + 1))), **kw)
    t0 = time.perf_counter()
    batches = list(loader)                  # packs and caches the sequences
    pack_s = time.perf_counter() - t0
    trainer = tt.TAGANTrainer(model, exp)
    trainer.train(warm, verbose=False)
    sync()
    before = {n: p.detach().clone() for n, p in model.named_parameters()}

    default = FG.FUSED_BWD
    runs = {}
    for fused in (default, not default):
        FG.FUSED_BWD = fused
        reset_counts(FG)
        t0 = time.perf_counter()
        res = trainer.train(loader, verbose=False)
        sync()
        epoch_ms = (time.perf_counter() - t0) * 1e3
        launched = counts(FG)
        want = {k.name: 0 for k in FG.KERNELS}
        want[FG.flash_geometric_fwd_kernel.name] = 2 * TRAIN_STEPS
        for kern in ((FG.flash_geometric_bwd_fused_kernel,) if fused else
                     (FG.flash_geometric_bwd_dq_kernel,
                      FG.flash_geometric_bwd_dkv_kernel)):
            want[kern.name] = cfg.num_layers * TRAIN_STEPS
        losses = res["history"]["train_loss"]
        step_ms = []
        for b, y, m in batches:
            sync()
            t0 = time.perf_counter()
            trainer._train_step(b, y, m)
            sync()
            step_ms.append((time.perf_counter() - t0) * 1e3)
        # the last step's (clipped) gradients: every one finite, and every
        # one non-zero but those that are zero in exact arithmetic
        grads = {n: p.grad for n, p in model.named_parameters()}
        no_grad = [n for n, g in grads.items() if g is None
                   or not bool(torch.isfinite(g).all())
                   or (n not in ZERO_GRAD and not bool((g != 0).any()))]
        log(f"[6] {'B2' if fused else 'B3a+B3b'} backward: {TRAIN_STEPS} "
            f"steps of TAGANTrainer.train in {epoch_ms:.3f} ms; mean loss "
            f"{losses}; launches {launched} (expected {want}); step ms "
            f"(host clock, synchronised) {[round(x, 3) for x in step_ms]}; "
            f"{len(grads) - len(no_grad)} of {len(grads)} gradients finite "
            f"and non-zero where not zero in exact arithmetic")
        if launched != want:
            raise AssertionError(f"launches {launched} != {want}")
        if not np.all(np.isfinite(losses)):
            raise AssertionError(f"loss not finite: {losses}")
        if no_grad:
            raise AssertionError(f"no finite non-zero gradient: {no_grad}")
        runs[fused] = dict(epoch_ms=epoch_ms, step_ms=step_ms,
                           launches=launched, loss=losses)
    FG.FUSED_BWD = default
    moved = sum(int(not torch.equal(p.detach(), before[n]))
                for n, p in model.named_parameters())
    log(f"[6] parameters moved by the measured steps: {moved} of "
        f"{len(before)} tensors")
    if moved != len(before):
        raise AssertionError(f"only {moved} of {len(before)} parameters moved")

    # the step split with CUDA events, the picker's default backward
    b, y, m = batches[0]
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    splits = []
    for _ in range(2):
        trainer.optimizer.zero_grad()
        sync()
        ev[0].record()
        loss, _ = trainer._loss(b, y, m, True)
        ev[1].record()
        loss.backward()
        ev[2].record()
        trainer.optimizer.step()
        ev[3].record()
        sync()
        splits.append([ev[i].elapsed_time(ev[i + 1]) for i in range(3)])
    log(f"[6] step split (CUDA events) forward / backward / optimizer ms: "
        f"{[[round(x, 3) for x in s] for s in splits]}")

    # one layer's backward launch over the batch's 8 folded snapshots
    args = layer0_inputs(FG, model, b.to(DEV), N_FULL)
    q, k, v, mask, jlist, jcount, ilist, icount = args
    G, H = q.shape[:2]
    ones = torch.ones(H, device=DEV)
    seeds = torch.zeros(G, dtype=torch.int32, device=DEV)
    with torch.no_grad():
        out, lse = FG.flash_geometric_fwd_kernel(
            q, k, v, mask, jlist, jcount, "euclidean", ones, seeds, 0.0)
        fold_b1 = cuda_ms(lambda: FG.flash_geometric_fwd_kernel(
            q, k, v, mask, jlist, jcount, "euclidean", ones, seeds, 0.0), 3)
        do = torch.randn(out.shape, device=DEV,
                         generator=torch.Generator(device=DEV).manual_seed(6))
        delta = (do * out).sum(-1)
        common = (q, k, v, mask, do, lse, delta)
        fold_b2 = cuda_ms(lambda: FG.flash_geometric_bwd_fused_kernel(
            *common, ilist, icount, "euclidean", ones, seeds, 0.0, False), 3)
        fold_b3 = cuda_ms(lambda: (
            FG.flash_geometric_bwd_dq_kernel(*common, jlist, jcount,
                                             "euclidean", ones, seeds, 0.0,
                                             False),
            FG.flash_geometric_bwd_dkv_kernel(*common, ilist, icount,
                                              "euclidean", ones, seeds,
                                              0.0)), 3)
    fold = {True: fold_b2, False: fold_b3}[default]
    step = min(runs[default]["step_ms"])
    share = cfg.num_layers * (fold_b1 + fold) / step
    log(f"[6] one layer's launches over the {G} folded snapshots: B1 "
        f"{fold_b1:.3f} ms; backward B2 {fold_b2:.3f} ms, B3a+B3b "
        f"{fold_b3:.3f} ms; {cfg.num_layers} layers' B1 and "
        f"{'B2' if default else 'B3a+B3b'} = {share:.3f} of the fastest step "
        f"({step:.3f} ms)")

    # one snapshot at full width: both forms against the plain backward
    one = tuple(t[:1].contiguous() for t in (q, k, v, mask, out, lse, do))
    plan = tuple(t[:1].contiguous() for t in (jlist, jcount))
    plan_t = tuple(t[:1].contiguous() for t in (ilist, icount))
    want = FG.flash_geometric_backward_plain(*one, "euclidean", ones, 0.0,
                                             seeds[:1])
    full = {}
    for fused in (True, False):
        got = FG._backward(*one, plan, plan_t, "euclidean", ones, 0.0,
                           seeds[:1], False, fused, None)
        sync()
        full[fused] = check_backward(f"N={N_FULL}", got, want, fused)
    full = kernel_errors(full)
    log(f"[6] backward at N={N_FULL}, one snapshot, vs plain: max abs err "
        f"B2 {full['B2']:.3e}, B3a {full['B3a']:.3e}, B3b {full['B3b']:.3e}")
    return dict(pack_s=pack_s, runs={str(k): v for k, v in runs.items()},
                default_fused=default, moved=moved, split_ms=splits,
                fold_b1_ms=fold_b1, fold_b2_ms=fold_b2, fold_b3_ms=fold_b3,
                kernel_share_of_step=share, full_err=full,
                launches={f: runs[f]["launches"] for f in runs})


# -- phase 7 ------------------------------------------------------------------

def grad_errors(got, want):
    """(max over tensors of the max abs error over the tensor's largest
    entry, names of the tensors at fp32 noise). A tensor whose largest
    entry is below 1e-6 of the model's largest gradient is zero in exact
    arithmetic (a bias that adds a constant to every score of a softmax
    row comes out as +-1e-9 on either side): there both sides must stay
    below that noise level instead."""
    noise = 1e-6 * max(g.abs().max().item() for g in want.values())
    worst, zero = 0.0, []
    for n, w in want.items():
        m = w.abs().max().item()
        if m < noise:
            zero.append(n)
            if not got[n].abs().max().item() < noise:
                raise AssertionError(f"{n}: gradient {got[n].abs().max()} "
                                     f"where the CPU's is noise ({m})")
        else:
            worst = max(worst, (got[n] - w).abs().max().item() / m)
    return worst, zero


def phase_train_mid(tt, FG):
    cfg = model_config(tt)
    rng = np.random.default_rng(3)
    ds = tt.TemporalGraphDataset(
        [make_sequence(rng, N_MID, 16 * N_MID, T_FULL) for _ in range(3)],
        [1.0, 0.0, 1.0])
    runs = {}
    for side, dev in (("card", DEV), ("cpu", "cpu")):
        model = tt.TAGAN(cfg, device=dev,
                         generator=torch.Generator().manual_seed(0))
        trainer = tt.TAGANTrainer(model, tt.ExperimentConfig(
            model=cfg, batch_size=1, seed=0))
        loader = tt.TemporalGraphDataLoader(ds, batch_size=1,
                                            dense_adj=False)
        losses, grads = [], None
        for b, y, m in loader:
            trainer.optimizer.zero_grad()
            loss, _ = trainer._loss(b, y, m, True)
            loss.backward()
            if grads is None:
                grads = {n: p.grad.detach().cpu().clone()
                         for n, p in model.named_parameters()}
            trainer.optimizer.step()
            losses.append(loss.item())
        runs[side] = dict(losses=losses, grads=grads, params={
            n: p.detach().cpu() for n, p in model.named_parameters()})
    card, cpu = runs["card"], runs["cpu"]
    grad_err, zero = grad_errors(card["grads"], cpu["grads"])
    loss_err = max(abs(a - b) for a, b in zip(card["losses"], cpu["losses"]))
    # parameters only where the first gradient stands above fp32 noise:
    # an exactly-zero gradient comes out as +-1e-9 on either side, and
    # Adam's first step turns its sign into a full +-lr step
    param_err = 0.0
    for n, p in cpu["params"].items():
        g = cpu["grads"][n].abs()
        sel = g > 1e-4 * g.max().clamp(min=1e-30)
        if sel.any():
            param_err = max(param_err,
                            (card["params"][n] - p)[sel].abs().max().item())
    log(f"[7] training at N={N_MID}, card vs cpu: losses "
        f"{card['losses']} vs {cpu['losses']} (max abs err {loss_err:.3e}); "
        f"first-step gradients max err over each tensor's largest entry "
        f"{grad_err:.3e} ({len(cpu['grads']) - len(zero)} tensors; "
        f"{len(zero)} at fp32 noise, zero in exact arithmetic: {zero}); "
        f"parameters after 3 steps max abs err {param_err:.3e}")
    if not (grad_err <= TOL and loss_err <= TOL and param_err <= TOL):
        raise AssertionError(f"card vs cpu training: grads {grad_err}, "
                             f"losses {loss_err}, params {param_err}")
    return dict(losses={"card": card["losses"], "cpu": cpu["losses"]},
                grad_err=grad_err, noise_tensors=zero, loss_err=loss_err,
                param_err=param_err)


def kernel_record(FG, kern, source, replaces, launches, err, ms, plain_ms,
                  plain_of, b, library_ms):
    """One kernel's entry of the ``{"kernels": [...]}`` line; ``plain_of``
    says which plain function ``plain_ms`` timed."""
    return {"name": kern.name, "route": "cuda",
            "source": f"tagan_torch/csrc/{source}",
            "replaces": f"{FG_SRC}:{replaces}", "launches": launches,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "plain_of": plain_of,
            "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
            "library_ms": library_ms}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "test needs an NVIDIA GPU", file=sys.stderr)
        return 1
    import tagan_torch as tt
    from tagan_torch.ops import build
    from tagan_torch.ops import flash_geometric as FG

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"[1] card: {card}")
    phase_build(build, FG)

    small_err = phase_small(FG)
    small_bwd = phase_small_bwd(FG)
    serve = phase_serve(tt, FG)
    mid = phase_mid(tt, FG)
    times = phase_times(FG, serve.pop("args"))
    train = phase_train(tt, FG)
    train_mid = phase_train_mid(tt, FG)

    bwd = times["bwd"]
    plain_bwd = min(bwd["plain_ms"])
    launches = {**train["launches"][False], **{
        k: v for k, v in train["launches"][True].items() if v}}
    # the plain backward forms dq, dk and dv in one pass over row chunks:
    # it is the plain version of each backward kernel, and its time is
    # that of the whole backward, not of B3a's or B3b's share
    plain_of = "flash_geometric_backward_plain (dq, dk and dv)"
    kernels = [
        kernel_record(FG, FG.flash_geometric_fwd_kernel,
                      "flash_geometric_fwd.cu", 259, serve["launches"],
                      max(small_err, serve["full_err"]),
                      min(times["kernel_ms"]), min(times["plain_ms"]),
                      "flash_geometric_forward_plain", times,
                      times["library_ms"]),
    ] + [
        kernel_record(FG, kern, source, line, launches[kern.name],
                      max(small_bwd[name], train["full_err"][name]),
                      min(bwd[name]["ms"]), plain_bwd, plain_of, bwd[name],
                      bwd["library_ms"])
        for name, kern, source, line in (
            ("B2", FG.flash_geometric_bwd_fused_kernel,
             "flash_geometric_bwd_fused.cu", 1590),
            ("B3a", FG.flash_geometric_bwd_dq_kernel,
             "flash_geometric_bwd.cu", 1455),
            ("B3b", FG.flash_geometric_bwd_dkv_kernel,
             "flash_geometric_bwd.cu", 1534))]
    out = Path(__file__).resolve().parent / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(dict(
        card=card, small_err=small_err, small_bwd_err=small_bwd, mid=mid,
        serve=serve, times=times, train=train, train_mid=train_mid,
        kernels=kernels), indent=1, default=str))
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
