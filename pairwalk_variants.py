#!/usr/bin/env python3
"""Time the pair walks, B1 and B1 bf16
(``tagan_torch/csrc/flash_pairwalk_fwd.cu``), B2 and B2 bf16
(``flash_pairwalk_bwd.cu``) and the bf16 biased backward's
row walk and key walk (``flash_pairwalk_biased_bwd.cu``), against copies
of their sources with one design constant changed, on one NVIDIA GPU, to
see what bounds them:

    python3 pairwalk_variants.py

Each variant is the source, with the walk's header
(``flash_pairwalk.cuh``) inlined, under one edit: the flush's gathers 1,
2 or 4 entries a lane at a time (UNROLL; B1's walk takes 2, B2's 1), a
2- or 8-stage mask ring (NST),
the flush removed (the walk then only streams the mask and lists the
pairs; its output is not the function), for B2 its dk and dv
atomics removed (likewise), and for the key walk each warp reading its
keys' R-byte pieces of the mask tile's 64 rows instead of the block
copying the whole tile (KEY_PIECES). The fp32 walks, B1 and B2, take
the flush's removal (their split into the mask stream and the pairs'
work) and for B2 the atomics' removal. The copies are built beside the
source into
``tagan_torch/_build/`` and timed in turns (base first and last) with
CUDA events, per snapshot, on uniform random graphs of 10,000 nodes:
degree 16 (the model's) at one snapshot and over a 16-snapshot fold,
degree 256, and a diagonal-only mask walked over every key tile. Prints
one line a graph and walk; writes nothing else. Exits non-zero without
CUDA.
"""

import sys
from pathlib import Path

import torch

from tagan_torch.ops import build
from tagan_torch.ops import flash_geometric as FG

N, H, D = 10_000, 4, 16


NST = {
    "nst2": ("constexpr int NST = 4;", "constexpr int NST = 2;"),
    "nst8": ("constexpr int NST = 4;", "constexpr int NST = 8;"),
}
EDITS = {
    "flash_pairwalk_fwd": dict(
        unroll1=("constexpr int UNROLL = 2;", "constexpr int UNROLL = 1;"),
        unroll4=("constexpr int UNROLL = 2;", "constexpr int UNROLL = 4;"),
        **NST, noflush=(
            "    flush<kMode, kBf16>(a, it, sm.lists + rl * CAPR,\n"
            "                        it.on ? sm.rowcnt[rl] : 0, zbuf);\n",
            "")),
    "flash_pairwalk_bwd": dict(
        unroll2=("constexpr int UNROLL = 1;", "constexpr int UNROLL = 2;"),
        unroll4=("constexpr int UNROLL = 1;", "constexpr int UNROLL = 4;"),
        **NST, noflush=(
            "    flush<kBf16>(a, it, sm.lists + rl * CAPR, it.on ? "
            "sm.rowcnt[rl] : 0);\n", ""),
        noatomics=("float w, bool vec) {\n",
                   "float w, bool vec) {\n  return;\n")),
    "flash_pairwalk_biased_bwd": dict(
        noflush_row=("constexpr bool ROW_FLUSH = true;",
                     "constexpr bool ROW_FLUSH = false;"),
        noflush_key=("constexpr bool KEY_FLUSH = true;",
                     "constexpr bool KEY_FLUSH = false;"),
        pieces=("constexpr bool KEY_PIECES = false;",
                "constexpr bool KEY_PIECES = true;")),
}
# the variants timed for each walk (all of its source's by default)
WALK_VARIANTS = {"B1": ("noflush",), "B2": ("noflush", "noatomics"),
                 "row walk": ("noflush_row",),
                 "key walk": ("noflush_key", "pieces")}


def variants(name: str, src: str, header: str):
    """(variant, source): ``src`` with the walk's header inlined, under
    each of ``EDITS[name]``."""
    inline = '#include "flash_pairwalk.cuh"'
    if inline not in src:
        raise SystemExit(f"{name}: {inline!r} not in the source")
    src = src.replace(inline, header.replace("#pragma once\n", ""))
    for variant, (old, new) in EDITS[name].items():
        if src.count(old) != 1:
            raise SystemExit(f"{name} {variant}: {old!r} not once in the "
                             f"source")
        yield variant, src.replace(old, new)


def graph(G, deg, gen):
    """(mask, jlist, jcount, ilist, icount): ``deg`` uniform random keys
    a row and the diagonal, or (deg 0) the diagonal walked over every
    tile."""
    mask = torch.zeros(G, N, N, dtype=torch.int8, device="cuda")
    rows = torch.arange(N, device="cuda").repeat_interleave(max(deg, 1))
    for g in range(G):
        if deg:
            mask[g, rows, torch.randint(0, N, (rows.numel(),),
                                        device="cuda", generator=gen)] = 1
        mask[g].fill_diagonal_(1)
    jlist, jcount = FG.make_block_plan(mask)
    ilist, icount = FG._transposed_plan(mask)
    if deg == 0:     # every key tile of every row tile, as a dense graph
        n_i = jlist.shape[1]
        jlist = torch.arange(n_i, dtype=torch.int32, device="cuda").expand(
            G, n_i, n_i).contiguous()
        jcount = torch.full((G, n_i), n_i, dtype=torch.int32, device="cuda")
        ilist, icount = jlist, jcount
    return mask, jlist, jcount, ilist, icount


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
    header = (csrc / "flash_pairwalk.cuh").read_text()
    walks = {"B1": FG.flash_geometric_fwd_kernel,
             "B1 bf16": FG.flash_geometric_fwd_bf16_kernel,
             "B2": FG.flash_geometric_bwd_fused_kernel,
             "B2 bf16": FG.flash_geometric_bwd_fused_bf16_kernel,
             "row walk": FG.flash_biased_bwd_row_bf16_kernel,
             "key walk": FG.flash_biased_bwd_key_bf16_kernel}
    kernels = {w: {"base": kern} for w, kern in walks.items()}
    made = {}
    try:
        for w, base in walks.items():
            if base.source not in made:
                src = (csrc / f"{base.source}.cu").read_text()
                made[base.source] = {}
                for name, text in variants(base.source, src, header):
                    path = csrc / f"pairwalk_variant_{base.source}_{name}.cu"
                    path.write_text(text)
                    made[base.source][name] = path
            for name, path in made[base.source].items():
                if name in WALK_VARIANTS.get(w, (name,)):
                    kernels[w][name] = type(base)()
                    kernels[w][name].source = path.stem
        build.build(k.source for ks in kernels.values() for k in ks.values())
        for ks in kernels.values():
            for k in ks.values():
                k._function()
    finally:
        for paths in made.values():
            for path in paths.values():
                path.unlink()
    print(torch.cuda.get_device_name(0), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(1)
    for label, G, deg in (("degree 16", 1, 16), ("degree 16, fold", 16, 16),
                          ("degree 256", 1, 256),
                          ("diagonal, every tile walked", 1, 0)):
        q, k, v, do = (0.5 * torch.randn(G, H, N, D, device="cuda",
                                         generator=gen) for _ in range(4))
        mask, jlist, jcount, ilist, icount = graph(G, deg, gen)
        ones = torch.ones(H, device="cuda")
        seed = torch.zeros(G, dtype=torch.int32, device="cuda")
        seeds = torch.zeros(G, 2, dtype=torch.int32, device="cuda")
        with torch.inference_mode():
            out, lse = walks["B1 bf16"](q, k, v, mask, jlist, jcount,
                                        "euclidean", ones, seed, 0.0)
            delta = (do * out).sum(-1)
            # the biased backward's inputs: B4 and B5 bf16's statistics
            # with a N(0, 1) bias at the mask's pairs
            bias = torch.where(mask != 0, torch.randn(
                mask.shape, device="cuda", generator=gen), 0.0)
            lse1 = FG.flash_lse1_bf16_kernel(q, k, mask, jlist, jcount,
                                             "euclidean", ones)
            out2, lse2 = FG.flash_biased_fwd_bf16_kernel(
                q, k, v, mask, bias, lse1, jlist, jcount, "euclidean", ones,
                seeds, 0.0)
            common = (q, k, v, mask, bias, do, lse1, lse2,
                      (do * out2).sum(-1))
            delta1 = walks["row walk"](*common, jlist, jcount, "euclidean",
                                       ones, seeds, 0.0, False)[0]
        fwd = (q, k, v, mask, jlist, jcount, "euclidean", ones, seed, 0.0)
        bwd = (q, k, v, mask, do, lse, delta, jlist, jcount, "euclidean",
               ones, seed, 0.0, False)
        args = {"B1": fwd, "B1 bf16": fwd, "B2": bwd, "B2 bf16": bwd,
                "row walk": (*common, jlist, jcount, "euclidean", ones,
                             seeds, 0.0, False),
                "key walk": (*common, delta1, ilist, icount, "euclidean",
                             ones, seeds, 0.0)}
        for w, ks in kernels.items():
            order = list(ks) + list(ks)[::-1]
            res = {}
            with torch.inference_mode():
                for name in order:
                    kern = ks[name]
                    res.setdefault(name, []).append(round(ms(
                        lambda: kern(*args[w])) / G, 5))
            print(f"{w}, {label}: ms a snapshot {res}", flush=True)
        del q, k, v, do, mask, out, lse, delta, bias, lse1, out2, lse2
        del common, delta1, args, fwd, bwd
    return 0


if __name__ == "__main__":
    sys.exit(main())
