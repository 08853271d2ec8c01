#!/usr/bin/env python3
"""Time B1's bf16 pair walk (``tagan_torch/csrc/flash_pairwalk_fwd.cu``)
against copies of its source with one design constant changed, on one
NVIDIA GPU, to see what bounds it:

    python3 pairwalk_variants.py

Each variant is the source with one edit: the flush's gathers 1 or 4
entries a lane at a time (UNROLL), a 2- or 8-stage mask ring (NST), and
the flush removed (the walk then only
streams the mask and lists the pairs; its output is not the function).
The copies are built beside the
source into ``tagan_torch/_build/`` and timed in turns (base first and
last) with CUDA events, per snapshot, on uniform random graphs of
10,000 nodes: degree 16 (the model's) at one snapshot and over a
16-snapshot fold, degree 256, and a diagonal-only mask walked over every
key tile. Prints one line a graph; writes nothing else. Exits non-zero
without CUDA.
"""

import sys
from pathlib import Path

import torch

from tagan_torch.ops import build
from tagan_torch.ops import flash_geometric as FG

N, H, D = 10_000, 4, 16


def variants(src: str):
    edits = {
        "unroll1": ("constexpr int UNROLL = 2;", "constexpr int UNROLL = 1;"),
        "unroll4": ("constexpr int UNROLL = 2;", "constexpr int UNROLL = 4;"),
        "nst2": ("constexpr int NST = 4;", "constexpr int NST = 2;"),
        "nst8": ("constexpr int NST = 4;", "constexpr int NST = 8;"),
        "noflush": ("    flush<kBiased>(a, it, lists + rl * CAPR, "
                    "it.on ? rowcnt[rl] : 0, zbuf);\n", ""),
    }
    for name, (old, new) in edits.items():
        if old not in src:
            raise SystemExit(f"{name}: {old!r} not in the source")
        yield name, src.replace(old, new)


def graph(G, deg, gen):
    mask = torch.zeros(G, N, N, dtype=torch.int8, device="cuda")
    rows = torch.arange(N, device="cuda").repeat_interleave(max(deg, 1))
    for g in range(G):
        if deg:
            mask[g, rows, torch.randint(0, N, (rows.numel(),),
                                        device="cuda", generator=gen)] = 1
        mask[g].fill_diagonal_(1)
    jlist, jcount = FG.make_block_plan(mask)
    if deg == 0:     # every key tile of every row tile, as a dense graph
        n_i = jlist.shape[1]
        jlist = torch.arange(n_i, dtype=torch.int32, device="cuda").expand(
            G, n_i, n_i).contiguous()
        jcount = torch.full((G, n_i), n_i, dtype=torch.int32, device="cuda")
    return mask, jlist, jcount


def ms(fn, iters=10):
    fn()
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def main() -> int:
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU with CUDA", file=sys.stderr)
        return 1
    csrc = Path(FG.__file__).resolve().parent.parent / "csrc"
    src = (csrc / "flash_pairwalk_fwd.cu").read_text()
    kernels = {"base": FG.flash_geometric_fwd_bf16_kernel}
    made = []
    try:
        for name, text in variants(src):
            path = csrc / f"pairwalk_variant_{name}.cu"
            path.write_text(text)
            made.append(path)
            kernels[name] = FG._FlashForwardBf16Kernel()
            kernels[name].source = path.stem
        build.build(k.source for k in kernels.values())
        for k in kernels.values():
            k._function()
    finally:
        for path in made:
            path.unlink()
    print(torch.cuda.get_device_name(0), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(1)
    for label, G, deg in (("degree 16", 1, 16), ("degree 16, fold", 16, 16),
                          ("degree 256", 1, 256),
                          ("diagonal, every tile walked", 1, 0)):
        q, k, v = (0.5 * torch.randn(G, H, N, D, device="cuda",
                                     generator=gen) for _ in range(3))
        mask, jlist, jcount = graph(G, deg, gen)
        ones = torch.ones(H, device="cuda")
        seed = torch.zeros(G, dtype=torch.int32, device="cuda")
        order = list(kernels) + list(kernels)[::-1]
        res = {}
        with torch.inference_mode():
            for name in order:
                kern = kernels[name]
                res.setdefault(name, []).append(round(ms(
                    lambda: kern(q, k, v, mask, jlist, jcount, "euclidean",
                                 ones, seed, 0.0)) / G, 5))
        print(f"{label}: ms a snapshot {res}", flush=True)
        del q, k, v, mask
    return 0


if __name__ == "__main__":
    sys.exit(main())
