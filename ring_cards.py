#!/usr/bin/env python3
"""Run B8, the ring all-gather, over ranks on several cards.

    python3 ring_cards.py [--rows 131072] [--D 64] [--rings 50]

Uses every visible card; needs at least two. The ranks are laid on the
cards four ways: one a card on the first two cards, one a card on all of
them, and two a card on all of them, in blocks (0, 0, 1, 1, ...) and
interleaved (0, 1, ..., 0, 1, ...). For each layout and dtype (fp32,
bf16) it shards [rows, D] by rows, runs ``--rings`` rings of
``tagan_torch.ops.ring_gather.ring_all_gather`` in a row and holds every
rank's out of every ring bit for bit against ``ring_all_gather_plain``
(each rank's ``torch.cat`` of the shards moved to its card), and counts
one launch a card a ring. Then it times ten runs of 20 rings, and of 20
plain gathers, in turns, each on the host's clock from a synchronise of
every card to the next. Prints the cards' names and power limits, a line
per case and, last, a JSON object of the results. Exits non-zero without
two cards, on a mismatch or on a wrong launch count.
"""

import argparse
import json
import subprocess
import sys
import time

import torch


def sync_all():
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def batch_ms(fn, n=20):
    sync_all()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    sync_all()
    return (time.perf_counter() - t0) * 1e3 / n


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=131_072)
    ap.add_argument("--D", type=int, default=64)
    ap.add_argument("--rings", type=int, default=50)
    a = ap.parse_args()
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        sys.exit("ring_cards.py: needs two CUDA cards or more")
    from tagan_torch.dist import make_mesh, shard_rows
    from tagan_torch.ops import ring_gather as TG

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    n = torch.cuda.device_count()
    layouts = {"1 a card, 2 cards": [0, 1],
               f"1 a card, {n} cards": list(range(n)),
               f"2 a card, {n} cards, blocks": [c for c in range(n)
                                                for _ in range(2)],
               f"2 a card, {n} cards, interleaved": list(range(n)) * 2}
    results, ok = [], True
    for name, cards in layouts.items():
        g = len(cards)
        mesh = make_mesh(graph=g, devices=[torch.device("cuda", c)
                                           for c in cards])
        rows = a.rows // g * g
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(rows, a.D, generator=torch.Generator()
                            .manual_seed(g)).to(dtype)
            shards = shard_rows(mesh, x)
            want = TG.ring_all_gather_plain(shards)
            before = TG.ring_gather_kernel.launches
            runs = [TG.ring_all_gather(shards, mesh)
                    for _ in range(a.rings)]
            sync_all()
            launches = TG.ring_gather_kernel.launches - before
            exact = all(torch.equal(o, w) for outs in runs
                        for o, w in zip(outs, want))
            del runs
            ring_ms, plain_ms = [], []
            for _ in range(10):
                ring_ms.append(batch_ms(
                    lambda: TG.ring_all_gather(shards, mesh)))
                plain_ms.append(batch_ms(
                    lambda: TG.ring_all_gather_plain(shards)))
            good = exact and launches == a.rings * len(set(cards))
            ok &= good
            r = dict(layout=name, cards=cards, dtype=str(dtype)[6:],
                     shape=[rows, a.D], exact=exact, launches=launches,
                     rings=a.rings, ring_ms=[round(t, 4) for t in ring_ms],
                     plain_ms=[round(t, 4) for t in plain_ms])
            results.append(r)
            print(f"{name} {r['dtype']} g={g}: bit-exact {exact}, "
                  f"{launches} launches for {a.rings} rings; ring "
                  f"{min(ring_ms):.4f}-{max(ring_ms):.4f} ms, plain "
                  f"{min(plain_ms):.4f}-{max(plain_ms):.4f} ms", flush=True)
    print(json.dumps({"ok": ok, "device": smi, "count": n,
                      "results": results}))
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
