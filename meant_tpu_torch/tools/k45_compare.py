"""K4 and K5 at the streaming widths, and one src4096 `--num_heads 4`
training run at full depth, of one tree of the repo, on the card.

    python meant_tpu_torch/tools/k45_compare.py --root DIR --out FILE

Imports `chip_smoke` and `meant_tpu_torch` from DIR (a checkout, such as
the parent commit unpacked with `git archive` into a git-ignored
directory), builds its kernels there, and writes to FILE (JSON): K4, K5
and the two together (ms per launch by CUDA events, and the body each
ran) at the shapes `chip_smoke` launches them at, from its constants:
src4096 at 4 heads (40, 4096, 192) causal xPos, the played ring's chunk
(40, 1024, 192) pixel rotary, src4096 at 3 heads (30, 4096, 256) and at 8
(80, 4096, 96); then src4096 at `--num_heads 4`, 12 + 12 encoders, batch
2, trained through `chip_smoke.learn_long_heads_full` (3 steps, the
median of steps 2-3, with its launch counts), or the same run in a tree
that predates it. Run it as a file (not with -m) so that DIR's package is
the one imported; compare two trees within one card call, in turns
(parent, change, change, parent).
"""
import argparse
import json
import os
import sys


def shapes(cs) -> list:
    """(BH, s, d, heads, chip_smoke.long_case kind) of each reading: the
    launches of src4096 at 4, 3 and 8 heads and of the ring's chunk."""
    rows = []
    for s, d, kind in ((cs.LONG_SEQ, 192, "text"),
                       (cs.RING_CHUNK, 192, "vision"),
                       (cs.LONG_SEQ, 256, "text"), (cs.LONG_SEQ, 96, "text")):
        heads = cs.DIM // d
        rows.append((cs.LONG_BATCH * cs.LAG * heads, s, d, heads, kind))
    return rows


def full_step(cs) -> dict:
    """chip_smoke's full-depth src4096 --num_heads 4 run (its record
    "train"), or, in a tree without learn_long_heads_full, the same three
    steps with the same launch counts."""
    if hasattr(cs, "learn_long_heads_full"):
        res = {}
        cs.learn_long_heads_full(res)
        return res["train"]
    model = cs.build_flagship(cs.LONG_SEQ, flash=True, fixed_proj=True,
                              num_heads=4)
    e = cs.ENCODERS
    train, _, _ = cs.train_steps(
        model, cs.train_batch(cs.LONG_BATCH, seed=53, seq=cs.LONG_SEQ), 3,
        {"K1": e, "K2": e, "K3": e, "R1": 3 * e, "K4": e, "K5": e, "A1": 1},
        f"learn src4096 --num_heads 4 at {e} encoders", falling=False)
    return train


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    os.chdir(root)
    import torch

    import chip_smoke as cs
    from meant_tpu_torch.cuda_build import build_all

    build_all(cs.KERNELS)
    res = {"root": args.root, "card": cs.card_line()}
    gen = torch.Generator(device="cuda").manual_seed(9)
    for bh, s, d, heads, kind in shapes(cs):
        c = cs.long_case(kind, torch.bfloat16, gen, bh, s=s, d=d,
                         heads=heads)
        cs.rotate_case(c)
        key = f"({bh}, {s}, {d})"
        res[key] = {
            "K4": cs.event_ms(lambda: cs.run_online_dq_kernel(c), iters=10),
            "K5": cs.event_ms(lambda: cs.run_online_dkdv_kernel(c),
                              iters=10),
            "K4+K5": cs.event_ms(lambda: (cs.run_online_dq_kernel(c),
                                          cs.run_online_dkdv_kernel(c)),
                                 iters=10),
            "body": [cs.wrappers()[k].last_source for k in ("K4", "K5")]}
        print(args.root, key, json.dumps(res[key]), flush=True)
        del c
        torch.cuda.empty_cache()
    train = full_step(cs)
    res["step_ms"] = train["step_ms"]
    res["step_ms_median"] = train["step_ms_median"]
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)


if __name__ == "__main__":
    main()
