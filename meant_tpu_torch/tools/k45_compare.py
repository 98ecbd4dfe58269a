"""The flash kernels past d = 128, two `--num_heads 4` training runs and
the `--num_heads 2` and 1 requests, of one tree of the repo, on the card.

    python meant_tpu_torch/tools/k45_compare.py --root DIR --out FILE

Imports `chip_smoke` and `meant_tpu_torch` from DIR (a checkout, such as
the parent commit unpacked with `git archive` into a git-ignored
directory), builds its kernels there, and writes to FILE (JSON), ms per
launch by CUDA events and the body each ran, at the shapes `chip_smoke`
launches them at, from its constants:

* K3 alone, R1 + K3, K4, K5 and K4 + K5 at src4096 at 4 heads (40, 4096,
  192) causal xPos, the played ring's chunk (40, 1024, 192) pixel rotary,
  src4096 at 3 heads (30, 4096, 256) and at 8 (80, 4096, 96);
* K2 alone (on R1's Qr and Kr) at meant_src --num_heads 4's (320, 512,
  192) causal xPos and (320, 196, 192) pixel rotary, at d = 256:
  src4096 --num_heads 3's vision tower (30, 196, 256) and --num_heads 3's
  text tower (240, 512, 256), at d = 384: --num_heads 2's (160, 512, 384)
  causal xPos and (160, 196, 384) pixel rotary, and at d = 768:
  --num_heads 1's charts (80, 196, 768), beside the SDPA backward, and at
  the flagship's (640, 512 / 196, 96);
* R1 + K1 and K1 alone at meant_src's resident launches past d = 128,
  (320, 512, 192), (320, 196, 192), (240, 512, 256), (160, 512, 384),
  (160, 196, 384) and (80, 196, 768), and at the flagship's (640, 512 /
  196, 96) (causal xPos at s=512, pixel rotary at 196), and R1 + K3
  and K3 alone at --num_heads 1's streaming text tower (80, 512, 768),
  each beside rotation + SDPA (the yardstick, in the same run);

then (unless `--kernels_only`) src4096 at `--num_heads 4`, 12 + 12
encoders, batch 2, trained through `chip_smoke.learn_long_heads_full` (3
steps, the median of steps 2-3, with its launch counts), or the same run
in a tree that predates it; then the flagship at `--num_heads 4`, 2 and 1
(s=512, batch 16, fixed_proj=True, as `chip_smoke.run_src_heads` trains
it) for SRC4_STEPS steps, the median of steps 2 on; then a 16-row request
of meant_src at `--num_heads 2` and 1 (build_model with --flash true,
`chip_smoke.time_requests`: the median of 7 and the forward's device
time). `--steps_only` takes the steps and requests alone.

`--past_256` takes instead the streaming backward past d = 256 and the
steps that launch it: K4, K5 and K4 + K5 as the main path launches them
(`chip_smoke.run_online_k45` where the tree has it, else the two calls)
beside the SDPA backward at --num_heads 1's text tower (80, 512, 768)
and src4096 --num_heads 2's (20, 4096, 384), causal xPos; the flagship's
`--num_heads 1` training step (as above); and src4096 at `--num_heads 2`
at full depth (`chip_smoke.learn_long_heads_full`).

`--odd` takes instead the backwards at an odd head dim and the steps
that launch them: K2 (alone, on R1's padded Qr and Kr), R1 + K2, and
flash_mha's forward (R1 + K1 with its pads and slices; K1 and R1 alone
beside it) at `--text_dim 760`'s (640, 512, 95) causal xPos, beside the
SDPA backward and rotation + SDPA, with a `torch.profiler` table of that
forward; K4, K5 and K4 + K5 at src4096's (80, 4096, 95) beside the SDPA
backward; the `--text_dim 760` training step and request at s=512; and
src4096 at `--text_dim 760` at full depth.

Run it as a file (not with -m) so that DIR's package is the one
imported; compare two trees within one card call, in turns (parent,
change, change, parent).
"""
import argparse
import json
import os
import sys


def odd_profile(cs, c, calls: int = 5) -> dict:
    """torch.profiler over `calls` flash_mha forwards of case c: each
    operator's device and host time a call, by device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    cs.run_kernel(c)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            cs.run_kernel(c)
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        dev = getattr(e, "device_time_total",
                      getattr(e, "cuda_time_total", 0.0))
        self_dev = getattr(e, "self_device_time_total",
                           getattr(e, "self_cuda_time_total", 0.0))
        rows.append({"name": e.key, "count": e.count / calls,
                     "device_ms": dev / calls / 1e3,
                     "self_device_ms": self_dev / calls / 1e3,
                     "host_ms": e.cpu_time_total / calls / 1e3})
    rows.sort(key=lambda r: -r["self_device_ms"])
    return {"calls": calls, "rows": rows[:25]}


def odd(cs, gen, root) -> dict:
    """The backwards at an odd head dim (module docstring, `--odd`), ms,
    with the width each ran at and the bodies."""
    import torch
    from meant_tpu_torch.ops.flash import (flash_bwd_dq, flash_bwd_dkdv,
                                           flash_bwd_dq_dkdv)
    res = {}
    heads = cs.ODD_HEADS
    d = cs.ODD_DIM // heads
    bh = cs.BATCH * cs.LAG * heads
    c = cs.backward_case("text", torch.bfloat16, gen, s=cs.SEQ, bh=bh, d=d,
                         heads=heads)
    p = cs.padded(c)
    cs.rotate_padded(c)
    key = f"K2 ({bh}, {cs.SEQ}, {d})"
    res[key] = {
        "width": p["width"],
        "K2": cs.event_ms(lambda: cs.k2_padded(c), iters=10),
        "R1+K2": cs.event_ms(lambda: (cs.rotate_padded(c), cs.k2_padded(c)),
                             iters=10),
        "library": cs.event_ms(cs.run_library_bwd(c), iters=10),
        "K2_body": cs.wrappers()["K2"].last_source,
        "R1+K1": cs.event_ms(lambda: cs.run_kernel(c), iters=20),
        "K1": cs.event_ms(lambda: cs.k1_padded(c), iters=20),
        "R1": cs.event_ms(lambda: cs.rotate_padded(c), iters=20),
        "library_fwd": cs.event_ms(lambda: cs.run_library(c), iters=20)}
    print(root, key, json.dumps(res[key]), flush=True)
    res[f"profile flash_mha ({bh}, {cs.SEQ}, {d})"] = prof = odd_profile(
        cs, c)
    print(root, "profile", json.dumps(prof["rows"][:12]), flush=True)
    del c, p
    torch.cuda.empty_cache()
    bh = cs.LONG_BATCH * cs.LAG * heads
    c = cs.long_case("text", torch.bfloat16, gen, bh, s=cs.LONG_SEQ, d=d,
                     heads=heads)
    p = cs.padded(c)
    cs.rotate_padded(c)
    args = (p["qr"], p["kr"], p["v"], p["do"],
            cs.flat(c["lse"]).contiguous(), cs.flat(c["delta"]).contiguous(),
            p["mask"], *p["tables"])
    kw = dict(scale=c["scale"], causal=c["causal"], num_heads=heads,
              head_dim=d)
    key = f"({bh}, {cs.LONG_SEQ}, {d})"
    res[key] = {
        "width": p["width"],
        "K4": cs.event_ms(lambda: flash_bwd_dq(*args, **kw), iters=10),
        "K5": cs.event_ms(lambda: flash_bwd_dkdv(*args, **kw), iters=10),
        "K4+K5": cs.event_ms(lambda: flash_bwd_dq_dkdv(*args, **kw),
                             iters=10),
        "library": cs.event_ms(cs.run_library_bwd(c), iters=5),
        "body": [cs.wrappers()[k].last_source for k in ("K4", "K5")]}
    print(root, key, json.dumps(res[key]), flush=True)
    del c, p, args
    torch.cuda.empty_cache()
    model = cs.build_flagship(flash=True, fixed_proj=True,
                              text_dim=cs.ODD_DIM)
    train, _, _ = cs.train_steps(
        model, cs.train_batch(cs.BATCH, seed=7), cs.SRC4_STEPS, cs.STEP,
        f"learn meant_src --text_dim {cs.ODD_DIM}", falling=False)
    res["odd_step_ms"] = train["step_ms"]
    res["odd_step_ms_median"] = train["step_ms_median"]
    del model
    torch.cuda.empty_cache()
    from meant_tpu_torch.serve import Predictor
    model = cs.build_zoo("meant_src", "--seq_len", str(cs.SEQ), "--text_dim",
                         str(cs.ODD_DIM), "--flash", "true")
    rec = {}
    cs.time_requests(Predictor(model, "meant_src", batch_size=cs.BATCH),
                     cs.request_batch(cs.BATCH, seed=70), rec,
                     label=f"meant_src --text_dim {cs.ODD_DIM}")
    res["odd_request"] = {k: rec[k] for k in ("request_ms",
                                              "request_ms_median",
                                              "forward_device_ms")}
    del model
    torch.cuda.empty_cache()
    model = cs.build_flagship(cs.LONG_SEQ, flash=True, fixed_proj=True,
                              text_dim=cs.ODD_DIM)
    e = cs.ENCODERS
    train, _, _ = cs.train_steps(
        model, cs.train_batch(cs.LONG_BATCH, seed=53, seq=cs.LONG_SEQ),
        cs.FULL_STEPS,
        {"K1": e, "K2": e, "K3": e, "R1": 3 * e, "K4": e, "K5": e, "A1": 1},
        f"learn src4096 --text_dim {cs.ODD_DIM} at {e} encoders",
        falling=False)
    res["odd_src4096_step_ms"] = train["step_ms"]
    res["odd_src4096_step_ms_median"] = train["step_ms_median"]
    del model
    torch.cuda.empty_cache()
    print(root, "steps", json.dumps(
        {"odd_step_ms_median": res["odd_step_ms_median"],
         "odd_request_ms_median": res["odd_request"]["request_ms_median"],
         "odd_src4096_step_ms_median": res["odd_src4096_step_ms_median"]}),
        flush=True)
    return res


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


def past_256_shapes(cs) -> list:
    """(BH, s, d, heads, kind) of the streaming launches past d = 256:
    --num_heads 1's text tower and src4096's at --num_heads 2."""
    return [(cs.BATCH * cs.LAG, cs.SEQ, cs.DIM, 1, "text"),
            (cs.LONG_BATCH * cs.LAG * 2, cs.LONG_SEQ, cs.DIM // 2, 2,
             "text")]


def past_256(cs, gen, root) -> dict:
    """K4, K5, K4 + K5 (as the main path launches them) and the SDPA
    backward at past_256_shapes, ms, with the bodies they ran; then the
    --num_heads 1 step and src4096's full-depth step at 2 heads."""
    import torch
    res = {}
    both = getattr(cs, "run_online_k45", None) or (
        lambda c: (cs.run_online_dq_kernel(c), cs.run_online_dkdv_kernel(c)))
    for bh, s, d, heads, kind in past_256_shapes(cs):
        c = cs.long_case(kind, torch.bfloat16, gen, bh, s=s, d=d,
                         heads=heads)
        cs.rotate_case(c)
        key = f"({bh}, {s}, {d})"
        library = cs.run_library_bwd(c)
        res[key] = {
            "K4": cs.event_ms(lambda: cs.run_online_dq_kernel(c), iters=10),
            "K5": cs.event_ms(lambda: cs.run_online_dkdv_kernel(c),
                              iters=10),
            "K4+K5": cs.event_ms(lambda: both(c), iters=10),
            "library": cs.event_ms(library, iters=5),
            "body": [cs.wrappers()[k].last_source for k in ("K4", "K5")]}
        print(root, key, json.dumps(res[key]), flush=True)
        del c, library
        torch.cuda.empty_cache()
    train = src_heads_step(cs, 1)
    res["src_heads1_step_ms"] = train["step_ms"]
    res["src_heads1_step_ms_median"] = train["step_ms_median"]
    torch.cuda.empty_cache()
    full = {}
    cs.learn_long_heads_full(full, 2)
    res["src4096_heads2_step_ms"] = full["train"]["step_ms"]
    res["src4096_heads2_step_ms_median"] = full["train"]["step_ms_median"]
    print(root, "steps", json.dumps(
        {k: res[k] for k in ("src_heads1_step_ms_median",
                             "src4096_heads2_step_ms_median")}), flush=True)
    return res


def resident_shapes(cs) -> list:
    """(BH, s, d, heads, chip_smoke.backward_case kind) of each K2
    reading."""
    rows = cs.BATCH * cs.LAG
    return [(rows * 4, cs.SEQ, 192, 4, "text"),
            (rows * 4, cs.N_PATCHES, 192, 4, "vision"),
            (cs.LONG_BATCH * cs.LAG * 3, cs.N_PATCHES, 256, 3, "vision"),
            (rows * 3, cs.SEQ, 256, 3, "text"),
            (rows * 2, cs.SEQ, 384, 2, "text"),
            (rows * 2, cs.N_PATCHES, 384, 2, "vision"),
            (rows, cs.N_PATCHES, 768, 1, "vision"),
            (rows * cs.HEADS, cs.SEQ, cs.HEAD_DIM, cs.HEADS, "text"),
            (rows * cs.HEADS, cs.N_PATCHES, cs.HEAD_DIM, cs.HEADS, "vision")]


def forward_shapes(cs) -> list:
    """(kernel, BH, s, d, heads, kind) of each forward reading: K1 at the
    resident launches past d = 128 and at the flagship's (d = 96), K3 at
    --num_heads 1's text tower."""
    rows = cs.BATCH * cs.LAG
    return [("K1", rows * heads, s, cs.DIM // heads, heads, kind)
            for heads, s, kind in ((4, cs.SEQ, "text"),
                                   (4, cs.N_PATCHES, "vision"),
                                   (3, cs.SEQ, "text"), (2, cs.SEQ, "text"),
                                   (2, cs.N_PATCHES, "vision"),
                                   (1, cs.N_PATCHES, "vision"),
                                   (cs.HEADS, cs.SEQ, "text"),
                                   (cs.HEADS, cs.N_PATCHES, "vision"))] + [
        ("K3", rows, cs.SEQ, cs.DIM, 1, "text")]


def forward_readings(cs, gen, root) -> dict:
    """R1 + K1 (or R1 + K3), the kernel alone and rotation + SDPA at
    forward_shapes, ms, with the body each ran."""
    import torch
    res = {}
    for kernel, bh, s, d, heads, kind in forward_shapes(cs):
        c = cs.attention_case(kind, torch.bfloat16, gen, s=s, bh=bh, d=d,
                              heads=heads)
        cs.rotate_case(c)
        both, alone = {"K1": (cs.run_kernel, cs.run_k1),
                       "K3": (cs.run_online_kernel,
                              cs.run_online_k3)}[kernel]
        key = f"{kernel} ({bh}, {s}, {d})"
        res[key] = {f"R1+{kernel}": cs.event_ms(lambda: both(c), iters=20),
                    kernel: cs.event_ms(lambda: alone(c), iters=20),
                    "library": cs.event_ms(lambda: cs.run_library(c),
                                           iters=20),
                    "body": cs.wrappers()[kernel].last_source}
        print(root, key, json.dumps(res[key]), flush=True)
        del c
        torch.cuda.empty_cache()
    return res


def request_ms(cs, heads: int) -> dict:
    """A BATCH-row request of meant_src --num_heads `heads` as build_model
    makes it (--flash true), timed by chip_smoke.time_requests."""
    import torch
    from meant_tpu_torch.serve import Predictor
    model = cs.build_zoo("meant_src", "--seq_len", str(cs.SEQ),
                         "--num_heads", str(heads), "--flash", "true")
    predictor = Predictor(model, "meant_src", batch_size=cs.BATCH)
    rec = {}
    cs.time_requests(predictor, cs.request_batch(cs.BATCH, seed=40 + heads),
                     rec, label=f"meant_src --num_heads {heads}")
    del model, predictor
    torch.cuda.empty_cache()
    return {k: rec[k] for k in ("request_ms", "request_ms_median",
                                "forward_device_ms")}


def src_heads_step(cs, heads: int = 4) -> dict:
    """The flagship at --num_heads `heads`, s=512, trained as run_src_heads
    trains it (train_steps at fixed_proj=True, batch 16, seed 7)."""
    import torch
    model = cs.build_flagship(flash=True, fixed_proj=True, num_heads=heads)
    train, _, _ = cs.train_steps(
        model, cs.train_batch(cs.BATCH, seed=7), cs.SRC4_STEPS,
        cs.src_launches(heads, True), f"learn meant_src --num_heads {heads}",
        falling=False)
    del model
    torch.cuda.empty_cache()
    return train


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


def kernel_readings(cs, gen, root) -> dict:
    """K3, R1 + K3, K4, K5 and K4 + K5 at `shapes`, K2 at
    `resident_shapes` and the forwards at `forward_shapes`."""
    import torch
    res = {}
    for bh, s, d, heads, kind in shapes(cs):
        c = cs.long_case(kind, torch.bfloat16, gen, bh, s=s, d=d,
                         heads=heads)
        cs.rotate_case(c)
        key = f"({bh}, {s}, {d})"
        res[key] = {
            "K3": cs.event_ms(lambda: cs.run_online_k3(c), iters=10),
            "R1+K3": cs.event_ms(lambda: cs.run_online_kernel(c), iters=10),
            "K4": cs.event_ms(lambda: cs.run_online_dq_kernel(c), iters=10),
            "K5": cs.event_ms(lambda: cs.run_online_dkdv_kernel(c),
                              iters=10),
            "K4+K5": cs.event_ms(lambda: (cs.run_online_dq_kernel(c),
                                          cs.run_online_dkdv_kernel(c)),
                                 iters=10),
            "body": [cs.wrappers()[k].last_source
                     for k in ("K3", "K4", "K5")]}
        print(root, key, json.dumps(res[key]), flush=True)
        del c
        torch.cuda.empty_cache()
    for bh, s, d, heads, kind in resident_shapes(cs):
        c = cs.backward_case(kind, torch.bfloat16, gen, s=s, bh=bh, d=d,
                             heads=heads)
        cs.rotate_case(c)
        key = f"K2 ({bh}, {s}, {d})"
        res[key] = {"K2": cs.event_ms(lambda: cs.run_bwd_k2(c), iters=10),
                    "body": cs.wrappers()["K2"].last_source,
                    "library": cs.event_ms(cs.run_library_bwd(c), iters=10)}
        print(root, key, json.dumps(res[key]), flush=True)
        del c
        torch.cuda.empty_cache()
    res.update(forward_readings(cs, gen, root))
    return res


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--kernels_only", action="store_true",
                    help="the kernels' readings, no step or request")
    ap.add_argument("--past_256", action="store_true",
                    help="only the streaming backward past d = 256 and "
                         "the steps that launch it")
    ap.add_argument("--steps_only", action="store_true",
                    help="the steps and requests, no kernel reading")
    ap.add_argument("--odd", action="store_true",
                    help="only the backwards at an odd head dim (d = 95) "
                         "and the steps that launch them")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    out = os.path.abspath(args.out)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    sys.path.insert(0, root)
    os.chdir(root)
    import torch

    import chip_smoke as cs
    from meant_tpu_torch.cuda_build import build_all

    logs = build_all(cs.KERNELS)
    res = {"root": args.root, "card": cs.card_line(), "build_log": logs}
    gen = torch.Generator(device="cuda").manual_seed(9)
    if args.past_256 or args.odd:
        res.update((odd if args.odd else past_256)(cs, gen, args.root))
        with open(out, "w") as f:
            json.dump(res, f, indent=1)
        return
    if not args.steps_only:
        res.update(kernel_readings(cs, gen, args.root))
    if args.kernels_only:
        with open(out, "w") as f:
            json.dump(res, f, indent=1)
        return
    train = full_step(cs)
    res["step_ms"] = train["step_ms"]
    res["step_ms_median"] = train["step_ms_median"]
    torch.cuda.empty_cache()
    for heads in (4, 2, 1):
        train = src_heads_step(cs, heads)
        res[f"src_heads{heads}_step_ms"] = train["step_ms"]
        res[f"src_heads{heads}_step_ms_median"] = train["step_ms_median"]
    for heads in (2, 1):
        res[f"src_heads{heads}_request"] = request_ms(cs, heads)
    print(args.root, "steps and requests", json.dumps(
        {"step_ms_median": res["step_ms_median"],
         **{f"src_heads{h}_step_ms_median":
            res[f"src_heads{h}_step_ms_median"] for h in (4, 2, 1)},
         **{f"src_heads{h}_request_ms_median":
            res[f"src_heads{h}_request"]["request_ms_median"]
            for h in (2, 1)}}), flush=True)
    with open(out, "w") as f:
        json.dump(res, f, indent=1)


if __name__ == "__main__":
    main()
