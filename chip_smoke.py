#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``tagan_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:

1. the card's name and power limit; build the CUDA kernels from
   ``tagan_torch/csrc`` (all ``nvcc`` processes at once);
2. each kernel against its plain PyTorch version on the card at small
   shapes: every metric, dead rows and an empty query tile, N not a
   multiple of the tile, D != Dv, per-head scales, dropout 0 and 0.1;
3. the main path: ``Predictor`` serving 3 requests of 2 sequences at the
   width ``bench.py`` runs (10,000 nodes, 160,000 random edges per
   snapshot, 8 snapshots, hidden 64, 4 heads, 2 flash layers) with random
   weights from a seed; launch counts set to 0 just before and read just
   after; the forward alone, and one layer's kernel launch over the
   request's folded snapshots, timed; then the first layer's kernel
   output on one snapshot against the plain version at full width;
4. end to end at 1,000 nodes: the same Predictor's probabilities on the
   card (kernel) and on the CPU (plain version), and the per-node
   features after the attention layers (``encode_spatial``);
5. times at the main path's shape (one snapshot, 4 heads, 10,000 nodes,
   head dim 16) with CUDA events, in turns plain, kernel, kernel, plain,
   and ``scaled_dot_product_attention`` with the boolean mask as the
   library yardstick; the kernel's bound from this run's inputs.

The last two lines are the ``{"kernels": [...]}`` record and
``{"ok": true, "device": {...}}``. A copy of the measurements goes to
``chiprun_out/chip_smoke.json``. Exits non-zero without CUDA.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

PEAK_FP32_FLOPS = 67e12     # H100 SXM, fp32 outside the tensor cores
PEAK_BYTES = 3.35e12        # H100 SXM HBM3
TOL = 1e-4                  # fp32 kernel vs plain, other summation order

N_FULL, E_FULL, T_FULL, F_NODE = 10_000, 160_000, 8, 16
REQUESTS, SEQS_PER_REQUEST = 3, 2
N_MID = 1_000


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def sync():
    torch.cuda.synchronize()


# -- phase 2 ------------------------------------------------------------------

def kernel_vs_plain(FG, G, H, N, D, Dv, metric, rate, seed=0):
    """Random inputs with dead rows and an empty query tile; returns the
    max abs error of out and lse over live rows after checking dead rows
    exactly."""
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(G, H, N, D, device=dev, generator=g)
    k = torch.randn(G, H, N, D, device=dev, generator=g)
    v = torch.randn(G, H, N, Dv, device=dev, generator=g)
    if metric in FG._COSINE:
        q, k = FG._l2_normalize(q), FG._l2_normalize(k)
    mask = (torch.rand(G, N, N, device=dev, generator=g) < 0.1).to(torch.int8)
    mask[0, 5] = 0
    mask[0, N - 1] = 0
    if G > 1 and N > 2 * FG.BLOCK_M:
        mask[1, FG.BLOCK_M:2 * FG.BLOCK_M] = 0      # a query tile with no keys
    scale = torch.linspace(0.7, 2.0, H, device=dev) \
        if metric in FG.SCALED_METRICS else torch.ones(H, device=dev)
    seeds = torch.tensor([12345, -7, 2 ** 31 - 1, 0][:G], dtype=torch.int32,
                         device=dev)
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
    log(f"[2] kernel vs plain: {len(errs)} cases, max abs err {max(errs):.3e}"
        f" (tol {TOL})")
    return max(errs)


# -- phase 3 ------------------------------------------------------------------

def make_sequence(rng, n, e, t_len):
    return [{"x": rng.standard_normal((n, F_NODE)).astype(np.float32),
             "edge_index": np.stack([rng.integers(0, n, e),
                                     rng.integers(0, n, e)]),
             "node_ids": np.arange(n), "timestep": float(t)}
            for t in range(t_len)]


def serving_config(tt):
    return tt.TAGANConfig(hidden_dim=64, num_heads=4, num_layers=2,
                          node_feature_dim=F_NODE, output_dim=1,
                          loss_type="bce", dropout=0.0,
                          spatial_backend="flash")


def phase_serve(tt, FG):
    cfg = serving_config(tt)
    model = tt.TAGAN(cfg, device="cuda",
                     generator=torch.Generator().manual_seed(0))
    dims = (T_FULL, N_FULL, E_FULL, 0)
    pred = tt.Predictor(model, dims=dims, batch_size=SEQS_PER_REQUEST)
    rng = np.random.default_rng(0)
    requests = [[make_sequence(rng, N_FULL, E_FULL, T_FULL)
                 for _ in range(SEQS_PER_REQUEST)] for _ in range(REQUESTS)]
    pred.warmup()
    sync()

    FG.flash_geometric_fwd_kernel.launches = 0
    lat, probs = [], []
    for req in requests:
        t0 = time.perf_counter()
        probs.append(pred.predict_proba(req))   # host copy: synchronises
        lat.append((time.perf_counter() - t0) * 1e3)
    launches = FG.flash_geometric_fwd_kernel.launches
    expected = cfg.num_layers * REQUESTS      # one launch per layer per batch
    probs = np.concatenate(probs)
    finite = bool(np.isfinite(probs).all())
    log(f"[3] request latency ms: {[round(x, 3) for x in lat]}; "
        f"sequences/s {REQUESTS * SEQS_PER_REQUEST / (sum(lat) / 1e3):.3f}; "
        f"kernel launches {launches} (expected {expected}); "
        f"probabilities finite: {finite}, shape {probs.shape}")
    if launches != expected or launches == 0:
        raise AssertionError(f"launches {launches} != {expected}")
    if not finite or probs.shape != (REQUESTS * SEQS_PER_REQUEST, 1):
        raise AssertionError("bad probabilities")

    # forward alone on a packed batch (no host packing)
    batch = tt.batch_sequences(pred._pack(requests[0])).to("cuda")
    with torch.inference_mode():
        model(batch)
        sync()
        t0 = time.perf_counter()
        model(batch)
        sync()
        fwd_ms = (time.perf_counter() - t0) * 1e3
    log(f"[3] forward on a packed request: {fwd_ms:.3f} ms")

    # the first layer's kernel inputs, the request's B*T snapshots folded
    # as the model folds them
    from tagan_torch.nn.model import flash_structures
    attn = model.geometric_layers["layer_0"].attn
    H = cfg.num_heads
    with torch.inference_mode():
        q, k, v = attn._qkv(model.node_embedding(batch.x))   # [B, T, H, N, Dh]
        mask, (jlist, jcount) = flash_structures(
            batch.edge_src, batch.edge_dst, batch.edge_mask, batch.node_mask,
            N_FULL)
        G = q.shape[0] * q.shape[1]
        folded = tuple(t.reshape(G, *t.shape[2:]).contiguous()
                       for t in (q, k, v, mask, jlist, jcount))
        ones = torch.ones(H, device="cuda")
        seeds = torch.zeros(G, dtype=torch.int32, device="cuda")
        layer_ms = cuda_ms(lambda: FG.flash_geometric_fwd_kernel(
            *folded, "euclidean", ones, seeds, 0.0), 3)
        # one snapshot at full width against the plain version
        args = tuple(t[:1].contiguous() for t in folded)
        out, lse = FG.flash_geometric_fwd_kernel(
            *args, "euclidean", ones, seeds[:1], 0.0)
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
    cfg = serving_config(tt)
    rng = np.random.default_rng(1)
    req = [make_sequence(rng, N_MID, 16 * N_MID, T_FULL)
           for _ in range(SEQS_PER_REQUEST)]
    dims = (T_FULL, N_MID, 16 * N_MID, 0)
    got, launched, nodes = {}, {}, {}
    for dev in ("cuda", "cpu"):
        model = tt.TAGAN(cfg, device=dev,
                         generator=torch.Generator().manual_seed(0))
        pred = tt.Predictor(model, dims=dims)
        before = FG.flash_geometric_fwd_kernel.launches
        got[dev] = pred.predict_proba(req)
        launched[dev] = FG.flash_geometric_fwd_kernel.launches - before
        # the per-node features before pooling, where a fault in one row
        # tile of the kernel is not averaged away
        batch = tt.batch_sequences(pred._pack(req)).to(dev)
        with torch.inference_mode():
            nodes[dev] = model.encode_spatial(batch).cpu()
    err = float(np.abs(got["cuda"] - got["cpu"]).max())
    node_err = (nodes["cuda"] - nodes["cpu"]).abs().max().item()
    log(f"[4] N={N_MID} probabilities card vs cpu: "
        f"{got['cuda'].ravel().tolist()} vs {got['cpu'].ravel().tolist()}; "
        f"max abs err {err:.3e}; per-node features after the attention "
        f"layers {tuple(nodes['cpu'].shape)}: max abs err {node_err:.3e}; "
        f"kernel launches card {launched['cuda']}, cpu {launched['cpu']}")
    if launched != {"cuda": cfg.num_layers, "cpu": 0}:
        raise AssertionError(f"launches {launched}")
    if not (err <= TOL and node_err <= TOL):
        raise AssertionError(f"end-to-end error {err}, per-node error "
                             f"{node_err} > {TOL}")
    return dict(prob_err=err, node_err=node_err)


# -- phase 5 ------------------------------------------------------------------

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


def phase_times(FG, args):
    q, k, v, mask, jlist, jcount = args
    G, H, N, D = q.shape
    Dv = v.shape[-1]
    ones = torch.ones(H, device="cuda")
    seed0 = torch.zeros(G, dtype=torch.int32, device="cuda")

    def kernel():
        FG.flash_geometric_fwd_kernel(q, k, v, mask, jlist, jcount,
                                      "euclidean", ones, seed0, 0.0)

    def kernel_sdp():
        FG.flash_geometric_fwd_kernel(q, k, v, mask, jlist, jcount,
                                      "scaled_dot_product", ones, seed0, 0.0)

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
    pairs = int((mask != 0).sum().item())                 # valid (i, j)
    walk_pairs = int(jcount.sum().item()) * FG.BLOCK_M * FG.BLOCK_N
    nbytes = (4 * G * H * N * (2 * D + Dv)                 # q, k, v
              + mask.numel() + 4 * (jlist.numel() + jcount.numel() + H + G)
              + 4 * G * H * N * (Dv + 1))                   # out, lse
    flops = 2 * H * pairs * (D + Dv)                       # q.k and p.v
    t_bytes, t_flops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_FP32_FLOPS * 1e3
    walk_ms = 2 * H * walk_pairs * (D + Dv) / PEAK_FP32_FLOPS * 1e3
    res = dict(kernel_ms=[k1, k2], plain_ms=[p1, p2], library_ms=lib,
               kernel_sdp_ms=k_sdp,
               bound_ms=max(t_bytes, t_flops),
               bound_by="bytes" if t_bytes >= t_flops else "operations",
               bytes=nbytes, flops=flops, valid_pairs=pairs,
               walk_pairs=walk_pairs, walk_flops_ms=walk_ms)
    log(f"[5] H={H} N={N} D={D} Dv={Dv}, one snapshot: kernel ms {k1:.4f} "
        f"{k2:.4f}; plain ms {p1:.4f} {p2:.4f}; sdpa ms {lib:.4f} (kernel at "
        f"the same metric {k_sdp:.4f})")
    log(f"[5] bound {res['bound_ms']:.5f} ms by {res['bound_by']} "
        f"({nbytes} bytes, {flops} flops over {pairs} valid pairs); "
        f"the walk visits {walk_pairs} pairs = {walk_ms:.5f} ms of fp32 "
        f"math at peak")
    return res


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
    t0 = time.perf_counter()
    build.build([FG.flash_geometric_fwd_kernel.name])
    log(f"[1] kernels built in {time.perf_counter() - t0:.3f} s")
    for name, text in build.build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[1] {name}: {line.strip()}")

    small_err = phase_small(FG)
    serve = phase_serve(tt, FG)
    mid = phase_mid(tt, FG)
    times = phase_times(FG, serve.pop("args"))

    kern = {"name": FG.flash_geometric_fwd_kernel.name, "route": "cuda",
            "source": "tagan_torch/csrc/flash_geometric_fwd.cu",
            "replaces": "tagan_tpu/ops/pallas/flash_geometric.py:259",
            "launches": serve["launches"],
            "max_abs_err": max(small_err, serve["full_err"]),
            "ms": min(times["kernel_ms"]), "plain_ms": min(times["plain_ms"]),
            "bound_ms": times["bound_ms"], "bound_by": times["bound_by"],
            "library_ms": times["library_ms"]}
    out = Path(__file__).resolve().parent / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(dict(
        card=card, small_err=small_err, mid=mid, serve=serve,
        times=times, kernels=[kern]), indent=1))
    log(card)
    log(json.dumps({"kernels": [kern]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
