#!/usr/bin/env python3
"""Time the pair walks, B1 and B1 bf16
(``tagan_torch/csrc/flash_pairwalk_fwd.cu``), B2 and B2 bf16
(``flash_pairwalk_bwd.cu``), the biased backward's row walk and key
walk, fp32 and bf16 (``flash_pairwalk_biased_bwd.cu``), their compact
forms over the hybrid band's store, fp32 and bf16
(``flash_pairwalk_biased_bwd_compact.cu``), the compact forward walk in
its three modes, B5c ("compact fwd walk"), B1c ("compact out walk") and
B4c ("compact lse walk"), fp32 and bf16
(``flash_pairwalk_fwd_compact.cu``), and the unbiased backward's compact
walks, B3a c's row walk ("compact plain row walk") and B3b c's key walk
("compact plain key walk"), fp32 and bf16
(``flash_pairwalk_bwd_compact.cu``), against copies of their sources
with one design constant changed, on one NVIDIA GPU, to see what bounds
them:

    python3 pairwalk_variants.py

Each variant is the source, with the walks' headers
(``flash_pairwalk.cuh``, for the forward walks ``flash_pairwalk_fwd.cuh``,
for the biased backward ``flash_pairwalk_biased_bwd.cuh``, and for the
compact walks ``flash_pairwalk_slots.cuh``) inlined, under one edit: the
flush's gathers 1,
2 or 4 entries a lane at a time (UNROLL; B1's walk takes 2, B2's 1), a
2- or 8-stage mask ring (NST),
the flush removed (the walk then only streams the mask and lists the
pairs; its output is not the function), for B2 its dk and dv
atomics removed (likewise), and for the key walk each warp reading its
keys' R-byte pieces of the mask tile's 64 rows instead of the block
copying the whole tile (KEY_PIECES). The fp32 walks B1 and B2 take the
flush's removal (their split into the mask stream and the pairs' work)
and for B2 the atomics' removal; the row and key walks take the same
variants in both precisions. The copies are built beside the
source into
``tagan_torch/_build/`` and timed in turns (base first and last) with
CUDA events, per snapshot, on uniform random graphs of 10,000 nodes:
degree 16 (the model's) at one snapshot and over a 16-snapshot fold,
degree 256, and a diagonal-only mask walked over every key tile. The
compact walks take the flush's removal (the row walk and the forward walk
then only walk their slots and list each row's pairs, the key walks only
copy the walked slots and list each key's rows): they are timed on one
snapshot of the
hybrid model's band (131,072 nodes, 16 edges a node, 95% of them within
+-512 of their source, the band those within the 95% quantile of the
distance; ``benchmarks/bench_partition_stress.py`` part C's graph), with
a N(0, 1) bias at the band's pairs and a residual delta1 that is not 0.
Prints one line a graph and walk; writes nothing else. Exits non-zero
without CUDA.
"""

import sys
from pathlib import Path

import numpy as np
import torch

from tagan_torch.core import graph as TGR
from tagan_torch.ops import build
from tagan_torch.ops import flash_geometric as FG

N, H, D = 10_000, 4, 16
# the hybrid model's band (bench_partition_stress.py part C)
N_BAND, DEG_BAND = 131_072, 16


NST = {
    "nst2": ("constexpr int NST = 4;", "constexpr int NST = 2;"),
    "nst8": ("constexpr int NST = 4;", "constexpr int NST = 8;"),
}
EDITS = {
    "flash_pairwalk_fwd": dict(
        unroll1=("constexpr int UNROLL = 2;", "constexpr int UNROLL = 1;"),
        unroll4=("constexpr int UNROLL = 2;", "constexpr int UNROLL = 4;"),
        **NST, noflush=(
            "    flush<kMode, kBf16>(a, it, pairs, sm.lists + rl * CAPR,\n"
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
    "flash_pairwalk_biased_bwd_compact": dict(
        noflush_row=("constexpr bool ROW_FLUSH = true;",
                     "constexpr bool ROW_FLUSH = false;"),
        noflush_key=("constexpr bool KEY_FLUSH = true;",
                     "constexpr bool KEY_FLUSH = false;")),
    "flash_pairwalk_fwd_compact": dict(
        noflush=("constexpr bool FWD_FLUSH = true;",
                 "constexpr bool FWD_FLUSH = false;")),
    "flash_pairwalk_bwd_compact": dict(
        noflush_row=("constexpr bool ROW_FLUSH = true;",
                     "constexpr bool ROW_FLUSH = false;"),
        noflush_key=("constexpr bool KEY_FLUSH = true;",
                     "constexpr bool KEY_FLUSH = false;")),
}
# the variants timed for each walk (all of its source's by default)
WALK_VARIANTS = {"B1": ("noflush",), "B2": ("noflush", "noatomics"),
                 "row walk": ("noflush_row",),
                 "row walk bf16": ("noflush_row",),
                 "key walk": ("noflush_key", "pieces"),
                 "key walk bf16": ("noflush_key", "pieces"),
                 "compact row walk": ("noflush_row",),
                 "compact row walk bf16": ("noflush_row",),
                 "compact key walk": ("noflush_key",),
                 "compact key walk bf16": ("noflush_key",),
                 "compact fwd walk": ("noflush",),
                 "compact fwd walk bf16": ("noflush",),
                 "compact out walk": ("noflush",),
                 "compact out walk bf16": ("noflush",),
                 "compact lse walk": ("noflush",),
                 "compact lse walk bf16": ("noflush",),
                 "compact plain row walk": ("noflush_row",),
                 "compact plain row walk bf16": ("noflush_row",),
                 "compact plain key walk": ("noflush_key",),
                 "compact plain key walk bf16": ("noflush_key",)}
COMPACT = ("compact row walk", "compact row walk bf16", "compact key walk",
           "compact key walk bf16", "compact fwd walk",
           "compact fwd walk bf16", "compact out walk",
           "compact out walk bf16", "compact lse walk",
           "compact lse walk bf16", "compact plain row walk",
           "compact plain row walk bf16", "compact plain key walk",
           "compact plain key walk bf16")


def inlined(src: str, csrc: Path) -> str:
    """``src`` with the walks' headers inlined: the forward walks'
    (``flash_pairwalk_fwd.cuh``), the biased backward's
    (``flash_pairwalk_biased_bwd.cuh``) and the compact walks'
    (``flash_pairwalk_slots.cuh``), where the source includes them, and
    the walk's (``flash_pairwalk.cuh``), once."""
    for header in ("flash_pairwalk_fwd.cuh", "flash_pairwalk_biased_bwd.cuh",
                   "flash_pairwalk_slots.cuh", "flash_pairwalk.cuh"):
        text = (csrc / header).read_text().replace("#pragma once\n", "")
        inline = f'#include "{header}"'
        src = src.replace(inline, text, 1).replace(inline, "")
    return src


def variants(name: str, src: str, csrc: Path):
    """(variant, source): ``src`` with the walks' headers inlined
    (`inlined`), under each of ``EDITS[name]``."""
    if '#include "flash_pairwalk' not in src:
        raise SystemExit(f"{name}: the walk's header is not included")
    src = inlined(src, csrc)
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


def band_graph(seed):
    """(store, plan, plan_t) of one snapshot of the hybrid model's band,
    the bit store, built as ``SnapshotSequence.with_hybrid_plan`` builds
    it (host-side numpy), on the card."""
    rng = np.random.default_rng(seed)
    n, e = N_BAND, N_BAND * DEG_BAND
    w = max(n // 256, 8)
    src = rng.integers(0, n, e)
    dst = np.where(rng.random(e) < 0.95,
                   np.clip(src + rng.integers(-w, w + 1, e), 0, n - 1),
                   rng.integers(0, n, e))
    src, dst = src[None], dst[None]
    em, nm = np.ones(src.shape, bool), np.ones((1, n), bool)
    band, res = TGR._hybrid_split(src, dst, em, None, 0.95)
    layout = (src, dst, nm, band, res,
              TGR._band_occupancy(src, dst, band, nm, n))
    dims = TGR._plan_dims(layout, transposed=True)
    built = TGR._build_hybrid(*layout, True, dims["S"], dims["Wj"],
                              dims["Er"], dims["Wi"])
    return (built["hyb_mask_blocks"].cuda(),
            *(tuple(t.cuda() for t in built[k])
              for k in ("hyb_plan", "hyb_plan_t")))


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
    walks = {"B1": FG.flash_geometric_fwd_kernel,
             "B1 bf16": FG.flash_geometric_fwd_bf16_kernel,
             "B2": FG.flash_geometric_bwd_fused_kernel,
             "B2 bf16": FG.flash_geometric_bwd_fused_bf16_kernel,
             "row walk": FG.flash_biased_bwd_row_kernel,
             "row walk bf16": FG.flash_biased_bwd_row_bf16_kernel,
             "key walk": FG.flash_biased_bwd_key_kernel,
             "key walk bf16": FG.flash_biased_bwd_key_bf16_kernel,
             "compact row walk": FG.flash_biased_bwd_row_compact_kernel,
             "compact row walk bf16":
                 FG.flash_biased_bwd_row_compact_bf16_kernel,
             "compact key walk": FG.flash_biased_bwd_key_compact_kernel,
             "compact key walk bf16":
                 FG.flash_biased_bwd_key_compact_bf16_kernel,
             "compact fwd walk": FG.flash_biased_fwd_compact_kernel,
             "compact fwd walk bf16":
                 FG.flash_biased_fwd_compact_bf16_kernel,
             "compact out walk": FG.flash_geometric_fwd_compact_kernel,
             "compact out walk bf16":
                 FG.flash_geometric_fwd_compact_bf16_kernel,
             "compact lse walk": FG.flash_lse1_compact_kernel,
             "compact lse walk bf16": FG.flash_lse1_compact_bf16_kernel,
             "compact plain row walk":
                 FG.flash_geometric_bwd_dq_compact_kernel,
             "compact plain row walk bf16":
                 FG.flash_geometric_bwd_dq_compact_bf16_kernel,
             "compact plain key walk":
                 FG.flash_geometric_bwd_dkv_compact_kernel,
             "compact plain key walk bf16":
                 FG.flash_geometric_bwd_dkv_compact_bf16_kernel}
    kernels = {w: {"base": kern} for w, kern in walks.items()}
    made = {}
    try:
        for w, base in walks.items():
            if base.source not in made:
                src = (csrc / f"{base.source}.cu").read_text()
                made[base.source] = {}
                for name, text in variants(base.source, src, csrc):
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
            delta1 = walks["row walk bf16"](*common, jlist, jcount,
                                            "euclidean", ones, seeds, 0.0,
                                            False)[0]
        fwd = (q, k, v, mask, jlist, jcount, "euclidean", ones, seed, 0.0)
        bwd = (q, k, v, mask, do, lse, delta, jlist, jcount, "euclidean",
               ones, seed, 0.0, False)
        row = (*common, jlist, jcount, "euclidean", ones, seeds, 0.0, False)
        key = (*common, delta1, ilist, icount, "euclidean", ones, seeds, 0.0)
        args = {"B1": fwd, "B1 bf16": fwd, "B2": bwd, "B2 bf16": bwd,
                "row walk": row, "row walk bf16": row, "key walk": key,
                "key walk bf16": key}
        for w, ks in kernels.items():
            if w in COMPACT:
                continue
            order = list(ks) + list(ks)[::-1]
            res = {}
            with torch.inference_mode():
                for name in order:
                    kern = ks[name]
                    res.setdefault(name, []).append(round(ms(
                        lambda: kern(*args[w])) / G, 5))
            print(f"{w}, {label}: ms a snapshot {res}", flush=True)
        del q, k, v, do, mask, out, lse, delta, bias, lse1, out2, lse2
        del common, delta1, args, fwd, bwd, row, key
    compact_times(kernels, gen)
    return 0


def compact_times(kernels, gen):
    """The compact walks and their variants on one snapshot of the band,
    each precision's key walk on its own row walk's delta1, the forward
    walk on B4c's lse1 (B5c), without it (B1c) and forming it (B4c), the
    plain row and key walks (B3a c, B3b c) on B1c's lse and delta =
    rowsum(dO out)."""
    store, plan, plan_t = band_graph(7)
    S = store.shape[1]
    q, k, v, do = (0.5 * torch.randn(1, H, N_BAND, D, device="cuda",
                                     generator=gen) for _ in range(4))
    bias = torch.randn(1, S, FG.BLOCK_M, FG.BLOCK_N, device="cuda",
                       generator=gen)
    rest = torch.randn(1, H, N_BAND, device="cuda", generator=gen)
    ones = torch.ones(H, device="cuda")
    seeds = torch.zeros(1, 2, dtype=torch.int32, device="cuda")
    pairs = int(FG.unpack_bits(store).sum())
    with torch.inference_mode():
        lse1 = FG.flash_lse1_compact_kernel(q, k, store, *plan, "euclidean",
                                            ones)
        out, lse2 = FG.flash_biased_fwd_compact_kernel(
            q, k, v, store, bias, lse1, *plan, "euclidean", ones, seeds, 0.0)
        fwd = (q, k, v, store, bias, lse1, *plan, "euclidean", ones, seeds,
               0.0)
        common = (q, k, v, store, bias, do, lse1, lse2, (do * out).sum(-1))
        row = (*common, rest, *plan, "euclidean", ones, seeds, 0.0, False)
        args = {"compact fwd walk": fwd, "compact fwd walk bf16": fwd,
                "compact lse walk": (q, k, store, *plan, "euclidean", ones),
                "compact lse walk bf16": (q, k, store, *plan, "euclidean",
                                          ones)}
        for prec in ("", " bf16"):
            d1 = kernels[f"compact row walk{prec}"]["base"](*row)[0]
            args[f"compact row walk{prec}"] = row
            args[f"compact key walk{prec}"] = (*common, d1, *plan_t,
                                              "euclidean", ones, seeds, 0.0)
        seed = torch.zeros(1, dtype=torch.int32, device="cuda")
        args["compact out walk"] = args["compact out walk bf16"] = (
            q, k, v, store, *plan, "euclidean", ones, seed, 0.0)
        out1, lse = FG.flash_geometric_fwd_compact_kernel(
            *args["compact out walk"])
        delta = (do * out1).sum(-1)
        dq = (q, k, v, store, do, lse, delta, *plan, "euclidean", ones, seed,
              0.0, False)
        dkv = (q, k, v, store, do, lse, delta, *plan_t, "euclidean", ones,
               seed, 0.0)
        args["compact plain row walk"] = args[
            "compact plain row walk bf16"] = dq
        args["compact plain key walk"] = args[
            "compact plain key walk bf16"] = dkv
    label = (f"hybrid band, N={N_BAND}, one snapshot: {S} walked slots, "
             f"{pairs} valid pairs")
    for w in COMPACT:
        ks = kernels[w]
        order = list(ks) + list(ks)[::-1]
        res = {}
        with torch.inference_mode():
            for name in order:
                kern = ks[name]
                res.setdefault(name, []).append(round(ms(
                    lambda: kern(*args[w])), 5))
        print(f"{w}, {label}: ms {res}", flush=True)


if __name__ == "__main__":
    sys.exit(main())
