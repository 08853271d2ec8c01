#!/usr/bin/env python3
"""Time the hybrid model's phases of two source trees in turns on one GPU.

    python3 chip_turns.py A_DIR B_DIR

Each directory holds a tree of this repository (say, the parent commit
unpacked by ``git archive`` beside the working tree). The script runs its
own process for each turn, A, B, B, A, from that tree's root: the card's
name and power limit, the build of the tree's kernels (its
``chip_smoke.py`` phase 1, with ptxas's registers and spills), then that
tree's hybrid phases 3c, 3d, 5d, 3g, 6c, 6g and 5i (serving and training
the 131,072-node model in fp32 and bf16, one layer's band kernels over the
fold, each band kernel at one snapshot beside its plain version, its
bound, ``flex_attention`` and csr). Then it runs each tree's
``pairwalk_variants.py`` once, A then B. So two versions are compared on
one card in one call, as chip_smoke.py measures them. Each turn's output
goes to ``chiprun_out/turn_<n>_<A or B>.log`` (the variants' to
``variants_<A or B>.log``) and its results to
``chiprun_out/turn_<n>_<A or B>.json``; a failed turn stops the script
with its exit code. Exits non-zero without CUDA.
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
del edge["reqs"]
times = C.phase_times_hybrid(FG, serve.pop("args"), edge.pop("args"))
serve16 = C.phase_serve_hybrid(tt, FG, edge=False, bf16=True,
                               reqs=serve.pop("reqs"))
del serve16["reqs"], serve16["args"]
train = C.phase_train_hybrid(tt, FG)
del train["args"]
train16 = C.phase_train_hybrid(tt, FG, bf16=True, data=train.pop("data"))
del train16["data"]
times16 = C.phase_times_hybrid_bf16(FG, train16.pop("args"))
with open(sys.argv[1], "w") as f:
    json.dump({"3c": serve, "3d": edge, "5d": times, "3g": serve16,
               "6c": train, "6g": train16, "5i": times16}, f, indent=1,
              default=str)
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
    for n, name in enumerate("ABBA", 1):
        stem = out / f"turn_{n}_{name}"
        run([sys.executable, "-c", TURN, f"{stem}.json"], trees[name],
            f"{stem}.log")
    for name, tree in trees.items():
        run([sys.executable, "pairwalk_variants.py"], tree,
            out / f"variants_{name}.log")
    return 0


if __name__ == "__main__":
    sys.exit(main())
