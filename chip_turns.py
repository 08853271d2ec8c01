#!/usr/bin/env python3
"""Time the hybrid model's phases of two source trees in turns on one GPU.

    python3 chip_turns.py A_DIR B_DIR [--train]

Each directory holds a tree of this repository (say, the parent commit
unpacked by ``git archive`` beside the working tree). The script runs its
own process for each turn, A, B, B, A, from that tree's root: the card's
name and power limit, the build of the tree's kernels (its
``chip_smoke.py`` phase 1, with ptxas's registers and spills), then that
tree's hybrid phases 3c, 3d, 5d, 3g, 6c, 6g and 5i, and the edge-feature
ones 3h, 6d, 6h and 5j (serving and training the 131,072-node model in
fp32 and bf16, without and with edge features, one layer's band kernels
over the fold, each band kernel at one snapshot beside its plain
version, its bound, ``flex_attention`` and csr). Then it runs each tree's
``pairwalk_variants.py`` once, A then B. So two versions are compared on
one card in one call, as chip_smoke.py measures them. Each turn's output
goes to ``chiprun_out/turn_<n>_<A or B>.log`` (the variants' to
``variants_<A or B>.log``) and its results to
``chiprun_out/turn_<n>_<A or B>.json``; a failed turn stops the script
with its exit code. Exits non-zero without CUDA.

With ``--train`` it runs the training phases 6c and 6d alone (the
kernels built, no ptxas report), in six turns, A, B, B, A, A, B, and no
variants: the training steps are host-bound and vary by +-10 ms from
run to run, so they take more turns than one call of all phases gives.
Its files are ``chiprun_out/train_<n>_<A or B>.log`` and ``.json``.
"""

import subprocess
import sys
from pathlib import Path

import torch

TURN = r"""
import json, sys, torch
import chip_smoke as C
import tagan_torch as tt
from tagan_torch.ops import build, flash_geometric as FG
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
C.log(f"[1] card: {C.card_line()}")
C.phase_build(build, FG)
serve = C.phase_serve_hybrid(tt, FG, edge=False)
edge = C.phase_serve_hybrid(tt, FG, edge=True)
edge_reqs = edge.pop("reqs")
times = C.phase_times_hybrid(FG, serve.pop("args"), edge.pop("args"))
serve16 = C.phase_serve_hybrid(tt, FG, edge=False, bf16=True,
                               reqs=serve.pop("reqs"))
del serve16["reqs"], serve16["args"]
train = C.phase_train_hybrid(tt, FG)
del train["args"]
train16 = C.phase_train_hybrid(tt, FG, bf16=True, data=train.pop("data"))
del train16["data"]
times16 = C.phase_times_hybrid_bf16(FG, train16.pop("args"))
edge16 = C.phase_serve_hybrid(tt, FG, edge=True, bf16=True, reqs=edge_reqs)
del edge16["reqs"], edge16["args"], edge_reqs
train_e = C.phase_train_hybrid_edge(tt, FG)
del train_e["args"]
train_e16 = C.phase_train_hybrid_edge(tt, FG, bf16=True,
                                      data=train_e.pop("data"))
del train_e16["data"]
times_e16 = C.phase_times_hybrid_edge_bf16(FG, train_e16.pop("args"))
with open(sys.argv[1], "w") as f:
    json.dump({"3c": serve, "3d": edge, "5d": times, "3g": serve16,
               "6c": train, "6g": train16, "5i": times16, "3h": edge16,
               "6d": train_e, "6h": train_e16, "5j": times_e16}, f,
              indent=1, default=str)
"""

TRAIN = r"""
import json, sys, torch
import chip_smoke as C
import tagan_torch as tt
from tagan_torch.ops import build, flash_geometric as FG
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
C.log(f"[1] card: {C.card_line()}")
build.build([k.source for k in FG.KERNELS])
train = C.phase_train_hybrid(tt, FG)
del train["args"], train["data"]
train_e = C.phase_train_hybrid_edge(tt, FG)
del train_e["args"], train_e["data"]
with open(sys.argv[1], "w") as f:
    json.dump({"6c": train, "6d": train_e}, f, indent=1, default=str)
"""


def run(cmd, cwd, log):
    with open(log, "w") as f:
        rc = subprocess.call(cmd, cwd=cwd, stdout=f, stderr=subprocess.STDOUT)
    print(f"{' '.join(cmd[:2])} in {cwd}: exit {rc}, log {log}", flush=True)
    if rc:
        sys.exit(rc)


def main() -> int:
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU with CUDA", file=sys.stderr)
        return 1
    trees = {"A": Path(sys.argv[1]).resolve(),
             "B": Path(sys.argv[2]).resolve()}
    out = Path(__file__).resolve().parent / "chiprun_out"
    out.mkdir(exist_ok=True)
    train = "--train" in sys.argv[3:]
    for n, name in enumerate("ABBAAB" if train else "ABBA", 1):
        stem = out / f"{'train' if train else 'turn'}_{n}_{name}"
        run([sys.executable, "-c", TRAIN if train else TURN,
             f"{stem}.json"], trees[name], f"{stem}.log")
    if train:
        return 0
    for name, tree in trees.items():
        run([sys.executable, "pairwalk_variants.py"], tree,
            out / f"variants_{name}.log")
    return 0


if __name__ == "__main__":
    sys.exit(main())
