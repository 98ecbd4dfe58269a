"""Host cost of reaching the flash kernels, to compare two trees of the
port on one card.

    python3 meant_tpu_torch/tools/dispatch_cost.py [--root DIR] [--out F]

imports `meant_tpu_torch` and `chip_smoke` from DIR (default: the tree
that holds this file), so one call can time another checkout and this one
in turns (parent, change, change, parent). It prints one JSON line with the
card's name and power limit and:

- `flash_call_us`: host time per `flash_mha` call (bf16, BH=8, s=128,
  causal, the xPos tables), inference and forward + backward, resident and
  streaming (`force_online=True`: R1 + K3, then R1 + K4 + K5), where the
  kernels take less time than the host takes to enqueue them, so the number
  is the dispatch path's cost;
- `meant_step_ms`, `mlm_step_ms`, `mim_step_ms`: the median host time of a
  synchronized training step (steps 2-N) of `meant` at paper128's width
  and of bench.py's MLM and MIM pretrainers: the host-bound steps, through
  `chip_smoke`'s own model constructors, with the launch counts it checks.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def flash_call_us(calls: int = 2000) -> dict:
    import torch
    from meant_tpu_torch.ops import lang_freqs
    from meant_tpu_torch.ops.flash import flash_mha
    from meant_tpu_torch.ops.flash.flash_attention import _tables
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(1, 8, 128, 96, generator=gen, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    qcos, qsin, kcos, ksin = _tables(128, 96, lang_freqs(48, device="cuda"),
                                     True, 512.0)
    kw = dict(scale=96 ** -0.5, causal=True, qcos=qcos, qsin=qsin,
              kcos=kcos, ksin=ksin)
    grads = [t.detach().requires_grad_(True) for t in (q, k, v)]
    do = torch.randn_like(q)

    def infer():
        with torch.no_grad():
            flash_mha(q, k, v, **kw)

    def train():
        flash_mha(*grads, **kw).backward(do)

    def train_streaming():
        flash_mha(*grads, force_online=True, **kw).backward(do)

    out = {}
    for name, fn in (("inference", infer), ("forward_backward", train),
                     ("streaming_forward_backward", train_streaming)):
        for _ in range(50):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        host = time.perf_counter() - t0
        torch.cuda.synchronize()
        out[name] = host / calls * 1e6
    return out


def step_ms(steps: int) -> dict:
    import torch
    import chip_smoke as cs
    out = {}
    res, trainer_, _ = cs.train_steps(
        cs.build_paper(), cs.paper_batch(cs.BATCH, seed=12, labels=True),
        steps, {"K1": 24, "R1": 24, "K2": 24, "A1": 1}, "meant",
        model_name="meant", falling=False)
    out["meant_step_ms"] = res["step_ms_median"]
    del trainer_
    torch.cuda.empty_cache()
    for kind in ("mlm", "mim"):
        host = cs.pretrain_batch(kind)
        res, trainer_, _ = cs.timed_steps(
            cs.pretrainer(kind, cs.build_pretrainer(kind), host), host,
            steps, {"K1": 12, "R1": 12, "K2": 12, "A1": 1}, kind,
            falling=False)
        out[f"{kind}_step_ms"] = res["step_ms_median"]
        del trainer_
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(HERE)),
                    help="tree whose meant_tpu_torch and chip_smoke to time")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--out", default=None, help="append the JSON line here")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        print("dispatch_cost: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from meant_tpu_torch.cuda_build import build_all
    build_all(cs.KERNELS)
    result = {"root": root, "card": cs.card_line(),
              "flash_call_us": flash_call_us(), **step_ms(args.steps)}
    line = json.dumps(result)
    print(line, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
