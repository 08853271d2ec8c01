#!/usr/bin/env python3
"""Time chip_smoke.py's phases of two source trees in turns on one GPU.

    python3 chip_turns.py A_DIR B_DIR [--train | --ring | --flash]

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

With ``--ring`` each turn, A, B, B, A, runs the build with ptxas's
report, the 10K flash model's serving phase 3 (whose layer-0 q, k, v and
snapshot mask the ring takes) and the ring's phase 8 (B8 and B9 over 2, 4
and 8 virtual ranks, B9's fold alone and its issue time, the density
sample 8d where the tree has it), B9 at 4 ranks as both trees can time
it (the ring, its issue and one fold launch alone), then each tree's
``pairwalk_variants.py`` (the other walks' times, B1 and B1c among them).
Its files are ``chiprun_out/ring_<n>_<A or B>.log`` and ``.json`` and
``variants_<A or B>.log``.

With ``--flash`` each turn, A, B, B, A, runs the build with ptxas's
report and the 10K flash model's phases: serving 3 and 3e (whose layer-0
inputs 5 and 5g take), the kernels at one snapshot 5 and 5g (B1, B2, B3a,
B3b and B3a + B3b, fp32 and bf16, beside the plain versions, SDPA and
their bounds; 5g's density sweep), and training 6 and 6e (3 steps with
B3a + B3b, then 3 with B2, each layer's backward over the 8-snapshot
fold, the full-width checks), then each tree's ``pairwalk_variants.py``.
Its files are ``chiprun_out/flash_<n>_<A or B>.log`` and ``.json`` and
``variants_<A or B>.log``.
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


RING = r"""
import json, sys, torch
import chip_smoke as C
import tagan_torch as tt
from tagan_torch.ops import build, flash_geometric as FG
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
C.log(f"[1] card: {C.card_line()}")
C.phase_build(build, FG)
serve = C.phase_serve(tt, FG)
args = serve.pop("args")
ring = C.phase_ring(FG, args)
# B9 at 4 ranks as either tree can time it: the ring, the host's time to
# issue it, and one fold launch alone (rank 0's hop 0, the state written)
TM, TF = C.ring_modules()[0], C.ring_modules()[3]
q, k, v = (t[0].contiguous() for t in args[:3])
H, N, _ = q.shape
mesh = TM.make_mesh(graph=4, devices=[C.DEV] * 4)
qs, ks, vs = (TM.shard_rows(mesh, t, dim=1) for t in (q, k, v))
masks = TM.shard_rows(mesh, args[3][0])
ones = torch.ones(H, device=C.DEV)
state = (torch.empty(H, N // 4, device=C.DEV),
         torch.empty(H, N // 4, device=C.DEV), torch.empty_like(qs[0]))
out = torch.empty_like(qs[0])
b9 = {}
with torch.inference_mode():
    for bf16 in (False, True):
        fold = TF.KERNELS[int(bf16)]
        def ring9():
            TF.ring_flash_attention_local(mesh, qs, ks, vs, masks,
                                          metric="euclidean", bf16=bf16)
        def one():
            fold(qs[0], ks[0], vs[0], masks[0], ones, state, out, 0,
                 "euclidean", True, False, torch.cuda.current_stream())
        b9["bf16" if bf16 else "fp32"] = r = dict(
            ring_ms=[C.cuda_ms(ring9, 10) for _ in range(2)],
            host_issue_ms=[C.host_ms(ring9, 10) for _ in range(2)],
            fold_ms=[C.cuda_ms(one, 20) for _ in range(2)])
        C.log(f"[turn] B9{' bf16' if bf16 else ''} g=4: {r}")
with open(sys.argv[1], "w") as f:
    json.dump({"3": serve, "8": ring, "b9": b9}, f, indent=1, default=str)
"""

FLASH = r"""
import json, sys, torch
import chip_smoke as C
import tagan_torch as tt
from tagan_torch.ops import build, flash_geometric as FG
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
C.log(f"[1] card: {C.card_line()}")
C.phase_build(build, FG)
serve = C.phase_serve(tt, FG)
times = C.phase_times(FG, serve.pop("args"))
serve16 = C.phase_serve(tt, FG, bf16=True)
times16 = C.phase_times_bf16(FG, serve16.pop("args"))
train = C.phase_train(tt, FG)
train16 = C.phase_train(tt, FG, bf16=True)
with open(sys.argv[1], "w") as f:
    json.dump({"3": serve, "5": times, "3e": serve16, "5g": times16,
               "6": train, "6e": train16}, f, indent=1, default=str)
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
    mode = "train" if train else "ring" if "--ring" in sys.argv[3:] \
        else "flash" if "--flash" in sys.argv[3:] else "turn"
    script = {"train": TRAIN, "ring": RING, "flash": FLASH,
              "turn": TURN}[mode]
    for n, name in enumerate("ABBAAB" if train else "ABBA", 1):
        stem = out / f"{mode}_{n}_{name}"
        run([sys.executable, "-c", script, f"{stem}.json"], trees[name],
            f"{stem}.log")
    if train:
        return 0
    for name, tree in trees.items():
        run([sys.executable, "pairwalk_variants.py"], tree,
            out / f"variants_{name}.log")
    return 0


if __name__ == "__main__":
    sys.exit(main())
