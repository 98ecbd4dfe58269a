#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (meant_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--out DIR]

Phases, run in the order 1-6, 9, 10, 7, 8; any failure raises and the
script exits non-zero:

1. build   -- nvcc builds every kernel of the serving, training and
              long-sequence paths from csrc/, one nvcc per source, all
              started together; cuobjdump must find wgmma (HGMMA) in each
              of the flash_fwd (K1, K3), flash_bwd (K2) and
              flash_bwd_online (K4, K5) libraries, and in K1's own kernel
              function.
2. kernels -- each kernel's wrapper against its plain PyTorch version on
              the card, at the main path's shapes: the rotation pass +
              flash forward (R1 + K1, bf16 at K1's own relative L2 bar)
              and R1 + backward (R1 + K2) in fp32 and bf16 at both
              attention shapes, R1 + the streaming forward (K3, out and
              lse; bf16 out also against the plain version in K3's tiled
              order), R1 (bit for bit) and the streaming dQ (K4) and
              dK/dV (K5) backward at s=4096, BH=16, in fp32 and bf16, and
              the fused AdamW (A1) over all 177,607,733 parameters; R1 +
              K1 and R1 + K2 also at the paper generation's s=128, and at
              the pretrainers' BH=128 (s=128 causal xPos, s=196).
3. slice   -- flagship meant_src (768 wide, 8 heads of 96, 12+12 encoders,
              s=512 text, 196-patch charts, bf16, seeded random weights)
              serves 40 rows through Predictor(batch_size=16): three
              requests, the last padded. K1's and R1's launch counts must
              rise by exactly 3 x 24 each and the probabilities must be
              finite and agree with the plain attention (towers and
              probabilities, at fixed_proj False and True).
4. train   -- the same model at fixed_proj=True (at False every tower
              gradient is zero, DEFECTS #15): one step's parameter
              gradients with the kernels vs the plain attention (8 rows,
              dropout off, per-tower relative L2); 20 steps of
              meant_trainer on one replayed 16-row batch at lr 1e-5
              constant, with exactly 24 K1, 24 R1 (in front of K1; K2
              takes their Qr and Kr), 24 K2 and 1 A1 launches per step
              and a finite, falling loss; step time, samples/s, peak
              memory and a torch.profiler breakdown of 2 steps; then
              cli.in_loop_train trains one epoch of a synthetic set,
              evaluates and saves, and Predictor(checkpoint_path=...)
              serves 16 rows with the trained model's probabilities.
              No phase of the flagship launches K3, K4 or K5.
5. long    -- src4096 (bench.py's long-sequence workload: the flagship at
              s=4096, batch 2, fusion projection of 4096): Predictor serves
              2 requests of 2 rows with exactly 12 K3 + 12 K1 + 24 R1
              launches per forward, towers and probabilities against the
              plain attention; one step's gradients at 1 row and 2
              encoders per tower against the plain attention; 10
              meant_trainer steps at fixed_proj=True with exactly 12 K3,
              12 K1, 36 R1 (before K3, K1 and K4 + K5), 12 K4, 12 K5, 12
              K2 and 1 A1 per step and a finite, falling loss;
              step time, samples/s, peak memory and a profiled step.
6. paper   -- the paper generation's `meant` (bench.py's paper128: the same
              width, s=128 tokens a day, 4-channel charts), built by the
              CLI's build_model with --flash true: Predictor serves 40
              rows with exactly 24 R1 + 24 K1 per forward (12 at s=128
              causal xPos, 12 at s=196) and no K2-K5, towers and
              probabilities against the plain attention, the request's
              median time and a profiled forward; one step's gradients
              against the plain attention (8 rows, dropout off); 20
              meant_trainer steps on one replayed 16-row batch at the
              default ff_dropout=0.5 with exactly 24 K1, 24 R1, 24 K2 and
              1 A1 per step and a finite, falling loss, a profiled step,
              and the same step at flash=False (timed and profiled
              only); then
              cli.in_loop_train --data_dir trains one epoch of an 80-row
              TempStock-small set of .npy files written here, evaluates
              and saves, cli.eval on the checkpoint gives the trainer's
              test confusion matrix, and Predictor(checkpoint_path=...)
              serves the test rows with the trained probabilities; A1
              against its plain version at meant's parameter count.
9. pretrain -- bench.py's build_mlm / build_mim (the same width and
              depth, batch 16, no lag in the batch, so BH = 128): the MLM
              (vocab 64001, s=128, tied gathered head; 106,644,737
              parameters) and the MIM (4x224^2 charts, L1 on the -100
              markers; 58,111,488), each with flash on: one step's
              gradients against the plain attention, for the MLM the
              gathered head against the full one, 20 steps on one
              replayed batch with exactly 12 R1, 12 K1, 12 K2 and 1 A1 a
              step and a falling loss, a profiled step, the flash=False
              step (bench.py's setting) timed and profiled only, A1 at
              the pretrainer's parameter count; then cli.pretrain_mlm on a
              .csv of 80 texts and cli.pretrain_mim on a .npy of 80
              charts, one epoch each at the CLIs' defaults (--flash auto
              runs the kernels, as the JAX harness does), and
              cli.in_loop_train -mn meant --flash true -p true -ptm from
              each checkpoint: before the first step the grafted entries
              (embedding and language tower, or vision tower) equal the
              checkpoint's and the rest are the fresh init; one epoch
              trains with meant's launch counts.
10. levers -- serving and memory levers at the flagship's width: the
              flagship (fixed_proj=True) served in bf16 and in int8
              (`Predictor(quantize="int8")`): exactly 24 R1 + 24 K1 a
              forward either way, int8 within atol 0.05 and argmax
              agreement 0.9 of bf16, request and forward device times side
              by side; the int8 product (`torch._int_mm`, zero-padded)
              int32-equal to its plain version at every shape that forward
              used; `cli.serve -mn meant --flash true --seq_len 128 --int8`;
              `cli.serve -mn meant_src --export` writes the flagship's
              program, and a fresh process that imports no model code
              loads it (`load_exported`) and serves 16 rows: exactly 24 R1
              + 24 K1, probabilities within 1e-5 of the live Predictor;
              src4096 at 2 encoders a tower exported and served (2 K3, 2
              K1, 4 R1); one training step of the flagship at remat off,
              "full", "dots" and scan_layers=True, dropout on, one seed:
              gradients bit for bit (else within 1e-3 relative L2 per
              group) of remat off, 48 R1 / 48 K1 / 24 K2 a step under
              remat (24 / 24 / 24 off), 4 trainer steps each for step time
              and peak memory, which must fall below remat off's; then
              `cli.in_loop_train -mn meant_src` with `--remat dots` and
              with `--scan_layers`, one epoch each.
7. timing  -- median request time, and each kernel's time per launch
              beside its bound, its plain version's time and one PyTorch
              call that computes the same (a yardstick the port never
              calls): rotation + scaled_dot_product_attention (R1 + K1,
              K1 alone beside it, at s=512, 196 and 128; R1 + K3, causal
              at s=4096; at BH=128 for the pretrainers) and its backward
              (R1 + K2; R1, K4 and K5 together),
              torch.optim.AdamW(fused=True) (A1, at the flagship's,
              meant's and the pretrainers' parameter counts); R1 has rows of
              its own at each shape. Beside the event time of the
              resident rows, their device time with the host out of the
              way (at s=128 a call launches less work than the host takes
              to issue it).
8. profile -- torch.profiler over 3 forwards of one 16-row request: device
              time per forward by kind, the device's idle share, and the
              top kernels.

It prints the card's name and power limit, one JSON line describing each
kernel, and last `{"ok": true, "device": {...}}`. `--out DIR` also writes
the full record (with nvcc's register report and the profiles) to
DIR/chip_smoke.json.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s of HBM3 and bf16
# tensor-core FLOP/s.
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12    # outside the tensor cores

BATCH, LAG, SEQ, IMAGE, PATCH, HEADS, DIM = 16, 5, 512, 224, 16, 8, 768
HEAD_DIM = DIM // HEADS
N_PATCHES = (IMAGE // PATCH) ** 2
ENCODERS = 12
REQUEST_ROWS = 40          # three requests at batch 16, the last padded
PROFILE_FORWARDS = 3

# Bars. fp32: the kernel and the plain version differ only in summation
# order (online vs two-pass softmax). bf16: each element is held to 2e-2
# relative + absolute, and the whole output to a relative L2 bar of
# ops/flash/kernel.py: K1_BF16_REL_L2 for K1, which rounds P after
# normalising as the plain version does; BF16_REL_L2 for K3, which rounds
# it at a running max, one bf16 step (2^-8 relative) apart, and
# K3_TILED_REL_L2 against the plain version in K3's own order.
FP32_RTOL, FP32_ATOL = 1e-4, 1e-5
BF16_TOL = 2e-2
# The slice in bf16, flash kernel vs plain attention through 12 layers:
# relative L2 error of each tower's output, and absolute error of the
# probabilities (sigmoid outputs; one bf16 step near 0.5 is 3.9e-3).
TOWER_REL_L2 = 3e-2
PROBS_ATOL = 2e-2
# A1 against its plain version: both round every operation to fp32 alike.
ADAMW_REL_ERR = 1e-6
# One training step's parameter gradients, K1+K2 vs the plain attention, in
# bf16 at fixed_proj=True, dropout off: relative L2 per group of parameters
# (text tower, vision tower, temporal stage and head). The H100 read 1.06e-2,
# 1.98e-2 and 1.13e-2: bf16 rounding in other places through twelve layers,
# as the served towers read 1.0e-2 (PERF.md).
STEP_GRAD_REL_L2 = 5e-2
GRAD_ROWS = 8              # rows of the gradient comparison
LEARN_STEPS, LEARN_LR = 20, 1e-5
PROFILE_STEPS = 2
KERNELS = ("flash_fwd", "flash_bwd", "flash_bwd_online", "adamw")
WGMMA_LIBRARIES = ("flash_fwd", "flash_bwd", "flash_bwd_online")
# src4096 (bench.py:807-817, build_src(4096, batch=2)): the flagship at
# s=4096 with a fusion projection of max(512, s), batch 2.
LONG_SEQ, LONG_BATCH = 4096, 2
LONG_REQUEST_ROWS = 4      # two requests of 2 rows
LONG_GRAD_ENCODERS = 2     # plain attention at 12 would save ~100 GB
LONG_STEPS = 10
LONG_CHECK_BH = 16         # the kernel checks against the plain versions
LONG_TIME_BH = LONG_BATCH * LAG * HEADS   # 80, the main path's launches
# paper128 (bench.py:163-179, build_paper128): meant at the same width, s=128
# tokens a day (TempStock-small), 4-channel charts, built by the CLI's
# build_model with --flash true (--flash auto turns the kernels off below
# 256 tokens, as bench.py's paper128 runs).
PAPER_SEQ = 128
PAPER_ARGV = ["-rid", "smoke", "-mn", "meant", "--flash", "true",
              "--seq_len", str(PAPER_SEQ), "-nec", str(ENCODERS)]
PAPER_DATA_ROWS = 80       # 48 / 16 / 16 rows after the 60/20/20 split
PAPER_PLAIN_STEPS = 5      # the flash=False step, timed only
# pretraining (bench.py:324-387, build_mlm / build_mim): the same width and
# depth, batch 16, bf16; the MLM at s=128 with the tied gathered head, the
# MIM on 4x224^2 charts; parameter counts of JAX less the rotary tables the
# port keeps as buffers
MLM_PARAMS, MIM_PARAMS = 106_644_737, 58_111_488
PRETRAIN_LR = 5e-5         # the pretraining CLIs' default -l
PRETRAIN_DATA_ROWS = 80    # 64 train / 16 val rows (n_val = max(n // 10, 16))
HEAD_LOSS_REL = 1e-3       # gathered vs full MLM head, relative loss error
# serving and memory levers: int8 against bf16 serving at JAX's own bars
# (tests/test_quant.py:115-117); an exported program against the live
# forward at JAX's export round-trip bar; remat's gradients against remat
# off where the kernels and products are not bit for bit
INT8_PROBS_ATOL, INT8_ARGMAX = 0.05, 0.9
EXPORT_ATOL = 1e-5
REMAT_GRAD_REL_L2 = 1e-3
REMAT_STEPS = 4
ROOT = os.path.dirname(os.path.abspath(__file__))


def fail(msg: str):
    raise RuntimeError(f"chip_smoke: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def count_hgmma(name: str, function: str = "") -> int:
    """wgmma instructions (HGMMA) in the SASS of the built csrc/<name>.cu,
    or only in its kernel functions whose (mangled) name holds `function`,
    by cuobjdump; fails when there are none."""
    import os
    from meant_tpu_torch.cuda_build import _library_path, find_nvcc
    tool = os.path.join(os.path.dirname(find_nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(_library_path(name))],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    # one section per kernel function, its mangled name on the first line
    sections = [sec for sec in sass.split("Function : ")[1:]
                if function in sec.split("\n", 1)[0]]
    n = sum("HGMMA" in line for sec in sections for line in sec.splitlines())
    where = f"{name} {function}".strip()
    print(f"SASS of {where}: {n} HGMMA (wgmma) instructions in "
          f"{len(sections)} function(s)", flush=True)
    if n == 0:
        fail(f"the built {where} issues no wgmma")
    return n


def event_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of fn() in ms over `iters` back-to-back calls. A
    sleep kernel (some 25 ms) holds the stream while the host enqueues the
    calls, so where a call launches less work than the host takes to issue
    it the events still bracket the device, not the host."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---- phase 2: the kernel against its plain version ---------------------

def attention_case(kind: str, dtype, gen, s=None, bh=BATCH * LAG * HEADS):
    """Inputs of one attention launch, at the flagship's shapes unless s
    and bh say otherwise: (bh / heads, heads, s, 96) q/k/v, tables, mask."""
    from meant_tpu_torch.ops import lang_freqs, pixel_freqs
    from meant_tpu_torch.ops.flash.flash_attention import _tables

    if s is None:
        s = N_PATCHES if kind == "vision" else SEQ
    shape = (bh // HEADS, HEADS, s, HEAD_DIM)
    q, k, v = (torch.randn(shape, generator=gen, device="cuda") * 2.0
               for _ in range(3))
    q, k, v = (t.to(dtype) for t in (q, k, v))
    if kind == "vision":
        freqs, xpos, causal = pixel_freqs(48, device="cuda"), False, False
    else:
        freqs, xpos, causal = lang_freqs(48, device="cuda"), True, True
    scale = 1.0 / DIM ** 0.5       # 1/sqrt(dim) in both towers
    tables = _tables(s, HEAD_DIM, freqs, xpos, 512.0)
    mask = None
    if kind == "text_masked":
        lengths = torch.randint(1, s + 1, (bh // HEADS,), generator=gen,
                                device="cuda")
        mask = (torch.arange(s, device="cuda")[None, :]
                < lengths[:, None]).to(torch.float32)
    return dict(q=q, k=k, v=v, tables=tables, mask=mask, scale=scale,
                causal=causal, s=s)


def run_kernel(c):
    from meant_tpu_torch.ops.flash import flash_mha
    qcos, qsin, kcos, ksin = c["tables"]
    return flash_mha(c["q"], c["k"], c["v"], scale=c["scale"],
                     causal=c["causal"], attention_mask=c["mask"], qcos=qcos,
                     qsin=qsin, kcos=kcos, ksin=ksin)


def run_k1(c):
    """K1 alone on c's qr and kr (rotate_case); out as (b, h, s, d)."""
    from meant_tpu_torch.ops.flash import flash_fwd
    b, h, s, d = c["q"].shape
    out = flash_fwd(c["qr"], c["kr"], c["v"].reshape(b * h, s, d),
                    c["mask"], scale=c["scale"], causal=c["causal"],
                    num_heads=h)
    return out.reshape(b, h, s, d)


def run_plain(c):
    from meant_tpu_torch.ops.flash import flash_mha_reference
    return flash_mha_reference(c["q"], c["k"], c["v"], c["mask"],
                               *c["tables"], scale=c["scale"],
                               causal=c["causal"])


def run_library(c):
    """Yardstick only: the rotation in PyTorch, then torch's fused SDPA."""
    from meant_tpu_torch.ops.rotary import rotate_half
    qcos, qsin, kcos, ksin = c["tables"]

    def rot(t, cos, sin):
        tf = t.to(torch.float32)
        return (tf * cos + rotate_half(tf) * sin).to(t.dtype)

    return torch.nn.functional.scaled_dot_product_attention(
        rot(c["q"], qcos, qsin), rot(c["k"], kcos, ksin), c["v"],
        is_causal=c["causal"], scale=c["scale"])


def rel_l2(out, ref) -> float:
    ref = ref.float()
    return ((out.float() - ref).norm() / ref.norm()).item()


# The resident cases of phase 2: (name, attention_case kind, s, BH), the
# flagship's s=512 text (also masked) and s=196 charts and the paper
# generation's s=128 text, at BH = 16 x 5 x 8 = 640, then the pretrainers'
# s=128 text and s=196 charts at BH = 16 x 8 = 128 (no lag in the batch).
MAIN_BH = BATCH * LAG * HEADS
PRETRAIN_BH = BATCH * HEADS
RESIDENT_CASES = (("text", "text", SEQ, MAIN_BH),
                  ("vision", "vision", N_PATCHES, MAIN_BH),
                  ("text_masked", "text_masked", SEQ, MAIN_BH),
                  ("text_s128", "text", PAPER_SEQ, MAIN_BH),
                  ("text_s128_bh128", "text", PAPER_SEQ, PRETRAIN_BH),
                  ("vision_bh128", "vision", N_PATCHES, PRETRAIN_BH))


def check_kernel(record):
    """R1 + K1 (flash_mha's resident forward) against flash_mha_reference
    at the main paths' shapes and the masked text case, fp32 and bf16."""
    from meant_tpu_torch.ops.flash.kernel import K1_BF16_REL_L2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    errors, rels = {}, {}
    for case, kind, s, bh in RESIDENT_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            c = attention_case(kind, dtype, gen, s=s, bh=bh)
            out = run_kernel(c)
            torch.cuda.synchronize()
            ref = run_plain(c)
            torch.cuda.synchronize()
            if out.shape != ref.shape or out.dtype != ref.dtype:
                fail(f"{kind} {dtype}: kernel gives {out.shape} {out.dtype}")
            err = (out.float() - ref.float()).abs().max().item()
            rel = rel_l2(out, ref)
            if dtype == torch.float32:
                ok = torch.allclose(out, ref, rtol=FP32_RTOL, atol=FP32_ATOL)
                bar = f"rtol {FP32_RTOL} atol {FP32_ATOL}"
            else:
                ok = (torch.allclose(out.float(), ref.float(), rtol=BF16_TOL,
                                     atol=BF16_TOL) and rel <= K1_BF16_REL_L2)
                bar = f"rtol/atol {BF16_TOL}, rel L2 {K1_BF16_REL_L2}"
            name = f"{case}/{str(dtype).split('.')[-1]}"
            print(f"R1 + K1 vs plain {name}: max_abs_err {err:.3e} rel_l2 "
                  f"{rel:.3e} ({bar}) {'ok' if ok else 'FAIL'}", flush=True)
            if not ok or not torch.isfinite(out).all():
                fail(f"kernel disagrees with its plain version ({name}, "
                     f"max abs err {err})")
            errors[name], rels[name] = err, rel
            del c, out, ref
    record["kernel_vs_plain_max_abs_err"] = errors
    record["kernel_vs_plain_rel_l2"] = rels
    return errors


def backward_case(kind, dtype, gen, **shape):
    """attention_case plus an output gradient dO of q's shape."""
    c = attention_case(kind, dtype, gen, **shape)
    c["do"] = torch.randn(c["q"].shape, generator=gen, device="cuda").to(
        dtype)
    return c


def run_bwd_kernel(c):
    """R1 then K2 on (b*h, s, d) views, as the resident backward runs them;
    returns (dq, dk, dv) as (b, h, s, d)."""
    rotate_case(c)
    return run_bwd_k2(c)


def run_bwd_k2(c):
    """K2 alone on c's qr and kr (rotate_case); (dq, dk, dv) as above."""
    from meant_tpu_torch.ops.flash import flash_bwd
    b, h, s, d = c["q"].shape
    flat = [c[n].reshape(b * h, s, d) for n in ("v", "do")]
    grads = flash_bwd(c["qr"], c["kr"], *flat, c["mask"], *c["tables"],
                      scale=c["scale"], causal=c["causal"], num_heads=h)
    return [g.reshape(b, h, s, d) for g in grads]


def run_bwd_plain(c):
    from meant_tpu_torch.ops.flash import flash_mha_bwd_reference
    return flash_mha_bwd_reference(c["q"], c["k"], c["v"], c["do"],
                                   c["mask"], *c["tables"], scale=c["scale"],
                                   causal=c["causal"])


def check_backward(record):
    """K2 against flash_mha_bwd_reference at the main paths' shapes (and the
    masked text case), fp32 and bf16, gradient by gradient."""
    from meant_tpu_torch.ops.flash.kernel import (BWD_BF16_ATOL,
                                                  BWD_BF16_REL_L2)
    gen = torch.Generator(device="cuda").manual_seed(2)
    errors, rels = {}, {}
    for case, kind, s, bh in RESIDENT_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            c = backward_case(kind, dtype, gen, s=s, bh=bh)
            got = run_bwd_kernel(c)
            torch.cuda.synchronize()
            want = run_bwd_plain(c)
            torch.cuda.synchronize()
            name = f"{case}/{str(dtype).split('.')[-1]}"
            rot_err = max((a.float() - b.float()).abs().max().item()
                          for a, b in zip((c["qr"], c["kr"]),
                                          rotate_plain(c)))
            print(f"R1 vs plain {name}: max_abs_err {rot_err:.3e} (bar 0) "
                  f"{'ok' if rot_err == 0 else 'FAIL'}", flush=True)
            if rot_err != 0:
                fail(f"R1 differs from _rotate ({name}, max abs err "
                     f"{rot_err})")
            errors[f"{name}/rot"] = rot_err
            worst = 0.0
            for g, a, b in zip(("dq", "dk", "dv"), got, want):
                err = (a.float() - b.float()).abs().max().item()
                rel = rel_l2(a, b)
                if dtype == torch.float32:
                    ok = torch.allclose(a, b, rtol=FP32_RTOL, atol=FP32_ATOL)
                else:
                    ok = (torch.allclose(a.float(), b.float(), rtol=BF16_TOL,
                                         atol=BWD_BF16_ATOL)
                          and rel <= BWD_BF16_REL_L2)
                ok = ok and bool(torch.isfinite(a).all())
                print(f"R1 + K2 vs plain {name} {g}: max_abs_err {err:.3e} "
                      f"rel_l2 {rel:.3e} {'ok' if ok else 'FAIL'}",
                      flush=True)
                if not ok:
                    fail(f"K2 disagrees with its plain version ({name} {g}, "
                         f"max abs err {err}, rel L2 {rel})")
                errors[f"{name}/{g}"], rels[f"{name}/{g}"] = err, rel
                worst = max(worst, err)
            errors[name] = worst
            del c, got, want
    record["k2_vs_plain_max_abs_err"] = errors
    record["k2_vs_plain_rel_l2"] = rels
    return errors


def run_online_kernel(c):
    """R1 then K3 on (b*h, s, d) views, as the streaming forward runs them;
    returns (out (b, h, s, d), lse (b, h, s))."""
    rotate_case(c)
    return run_online_k3(c)


def run_online_k3(c):
    """K3 alone on c's qr and kr (rotate_case); (out, lse) as above."""
    from meant_tpu_torch.ops.flash import flash_fwd_online
    b, h, s, d = c["q"].shape
    out, lse = flash_fwd_online(c["qr"], c["kr"], c["v"].reshape(b * h, s, d),
                                c["mask"], scale=c["scale"],
                                causal=c["causal"], num_heads=h)
    return out.reshape(b, h, s, d), lse.reshape(b, h, s)


def run_online_plain(c):
    from meant_tpu_torch.ops.flash import flash_mha_online_reference
    return flash_mha_online_reference(c["q"], c["k"], c["v"], c["mask"],
                                      *c["tables"], scale=c["scale"],
                                      causal=c["causal"])


def run_online_tiled_plain(c):
    """K3's plain version in the kernel's order (64-key tiles, P rounded at
    the running max): out only."""
    from meant_tpu_torch.ops.flash.kernel import (
        flash_mha_online_tiled_reference)
    return flash_mha_online_tiled_reference(
        c["q"], c["k"], c["v"], c["mask"], *c["tables"], scale=c["scale"],
        causal=c["causal"])[0]


def rotate_case(c):
    """R1 on (b*h, s, d) views of q and k; stores and returns (qr, kr)."""
    from meant_tpu_torch.ops.flash import rotate_qk
    b, h, s, d = c["q"].shape
    c["qr"], c["kr"] = rotate_qk(*(c[n].reshape(b * h, s, d)
                                   for n in ("q", "k")), *c["tables"])
    return c["qr"], c["kr"]


def rotate_plain(c):
    from meant_tpu_torch.ops.flash.kernel import _rotate
    b, h, s, d = c["q"].shape
    qcos, qsin, kcos, ksin = c["tables"]
    return (_rotate(c["q"].reshape(b * h, s, d), qcos, qsin),
            _rotate(c["k"].reshape(b * h, s, d), kcos, ksin))


def _online_bwd_args(c):
    """K4's and K5's arguments, q and k as R1 rotated them
    (rotate_case)."""
    b, h, s, d = c["q"].shape
    return ([c["qr"], c["kr"]]
            + [c[n].reshape(b * h, s, d) for n in ("v", "do")]
            + [c["lse"].reshape(b * h, s).contiguous(),
               c["delta"].reshape(b * h, s).contiguous(), c["mask"],
               *c["tables"]])


def run_online_dq_kernel(c):
    """K4; returns dq (b, h, s, d)."""
    from meant_tpu_torch.ops.flash import flash_bwd_dq
    (dq,) = flash_bwd_dq(*_online_bwd_args(c), scale=c["scale"],
                         causal=c["causal"], num_heads=c["q"].shape[1])
    return dq.reshape(c["q"].shape)


def run_online_dkdv_kernel(c):
    """K5; returns (dk, dv), each (b, h, s, d)."""
    from meant_tpu_torch.ops.flash import flash_bwd_dkdv
    grads = flash_bwd_dkdv(*_online_bwd_args(c), scale=c["scale"],
                           causal=c["causal"], num_heads=c["q"].shape[1])
    return [g.reshape(c["q"].shape) for g in grads]


def _online_plain_args(c):
    return ((c["q"], c["k"], c["v"], c["do"], c["lse"], c["delta"],
             c["mask"], *c["tables"]),
            dict(scale=c["scale"], causal=c["causal"]))


def run_online_dq_plain(c):
    from meant_tpu_torch.ops.flash.kernel import (
        flash_mha_bwd_online_dq_reference)
    args, kw = _online_plain_args(c)
    return flash_mha_bwd_online_dq_reference(*args, **kw)


def run_online_dkdv_plain(c):
    from meant_tpu_torch.ops.flash.kernel import (
        flash_mha_bwd_online_dkdv_reference)
    args, kw = _online_plain_args(c)
    return flash_mha_bwd_online_dkdv_reference(*args, **kw)


def long_case(kind, dtype, gen, bh):
    """One text-tower launch of src4096 (s=4096, causal xPos) with dO;
    `text_masked` has a padding mask of a random length per batch row (at
    least one key). A batch row with every key masked is checked by
    tests/test_torch_cuda.py with the pixel rotary: under causal xPos at
    s=4096 its dq sums terms up to some 300 in size, where one bf16 step
    of a dS entry moves an element by 0.6 (PERF.md). lse and delta for the
    backward come from the plain forward and carry a non-zero lse
    cotangent: delta = rowsum(dO * out) - g_lse."""
    c = backward_case(kind, dtype, gen, s=LONG_SEQ, bh=bh)
    out, lse = run_online_plain(c)
    g_lse = torch.randn(lse.shape, generator=gen, device="cuda")
    c.update(out=out, lse=lse,
             delta=(c["do"].float() * out.float()).sum(-1) - g_lse)
    return c


def check_long_kernels(record):
    """R1 + K3 (out and lse), R1, K4 and K5 against their plain versions
    at s=4096, BH=16, fp32 and bf16, without and with a padding mask: out
    at BF16_REL_L2 (and, in bf16, at K3_TILED_REL_L2 against the plain
    version in K3's tiled order), the gradients at K2's bars, lse within
    LSE_ATOL, R1 bit for bit."""
    from meant_tpu_torch.ops.flash.kernel import (BF16_REL_L2, BWD_BF16_ATOL,
                                                  BWD_BF16_REL_L2,
                                                  K3_TILED_REL_L2, LSE_ATOL)
    gen = torch.Generator(device="cuda").manual_seed(4)
    errors, rels = {}, {}
    for kind in ("text", "text_masked"):
        for dtype in (torch.float32, torch.bfloat16):
            c = long_case(kind, dtype, gen, LONG_CHECK_BH)
            name = f"long_{kind}/{str(dtype).split('.')[-1]}"
            out, lse = run_online_kernel(c)
            rotated = (c["qr"], c["kr"])
            dq = run_online_dq_kernel(c)
            dk, dv = run_online_dkdv_kernel(c)
            torch.cuda.synchronize()
            want = {"out": c["out"], "dq": run_online_dq_plain(c)}
            want["dk"], want["dv"] = run_online_dkdv_plain(c)
            torch.cuda.synchronize()
            lse_err = (lse - c["lse"]).abs().max().item()
            ok_lse = lse_err <= LSE_ATOL and bool(torch.isfinite(lse).all())
            print(f"R1 + K3 vs plain {name} lse: max_abs_err {lse_err:.3e} "
                  f"(bar {LSE_ATOL}) {'ok' if ok_lse else 'FAIL'}",
                  flush=True)
            if not ok_lse:
                fail(f"K3's lse disagrees with its plain version ({name}, "
                     f"max abs err {lse_err})")
            errors[f"{name}/lse"] = lse_err
            if dtype == torch.bfloat16:
                rel = rel_l2(out, run_online_tiled_plain(c))
                ok = rel <= K3_TILED_REL_L2
                print(f"R1 + K3 vs plain in K3's tiled order {name} out: "
                      f"rel_l2 {rel:.3e} (bar {K3_TILED_REL_L2}) "
                      f"{'ok' if ok else 'FAIL'}", flush=True)
                if not ok:
                    fail(f"K3 disagrees with its tiled plain version ({name},"
                         f" rel L2 {rel})")
                rels[f"{name}/out_tiled"] = rel
                torch.cuda.empty_cache()
            rot_err = max((a.float() - b.float()).abs().max().item()
                          for a, b in zip(rotated, rotate_plain(c)))
            print(f"R1 vs plain {name}: max_abs_err {rot_err:.3e} (bar 0) "
                  f"{'ok' if rot_err == 0 else 'FAIL'}", flush=True)
            if rot_err != 0:
                fail(f"R1 differs from _rotate ({name}, max abs err "
                     f"{rot_err})")
            errors[f"{name}/rot"] = rot_err
            for g, a in (("out", out), ("dq", dq), ("dk", dk), ("dv", dv)):
                b = want[g]
                err = (a.float() - b.float()).abs().max().item()
                rel = rel_l2(a, b)
                if dtype == torch.float32:
                    ok = torch.allclose(a, b, rtol=FP32_RTOL, atol=FP32_ATOL)
                elif g == "out":
                    ok = (torch.allclose(a.float(), b.float(), rtol=BF16_TOL,
                                         atol=BF16_TOL)
                          and rel <= BF16_REL_L2)
                else:
                    ok = (torch.allclose(a.float(), b.float(), rtol=BF16_TOL,
                                         atol=BWD_BF16_ATOL)
                          and rel <= BWD_BF16_REL_L2)
                ok = ok and bool(torch.isfinite(a).all())
                kernel = {"out": "K3", "dq": "K4"}.get(g, "K5")
                print(f"{kernel} vs plain {name} {g}: max_abs_err {err:.3e} "
                      f"rel_l2 {rel:.3e} {'ok' if ok else 'FAIL'}",
                      flush=True)
                if not ok:
                    fail(f"{kernel} disagrees with its plain version ({name} "
                         f"{g}, max abs err {err}, rel L2 {rel})")
                errors[f"{name}/{g}"], rels[f"{name}/{g}"] = err, rel
            del c, out, lse, rotated, dq, dk, dv, want
            torch.cuda.empty_cache()
    record["long_kernels_vs_plain_max_abs_err"] = errors
    record["long_kernels_vs_plain_rel_l2"] = rels
    return errors


def adamw_case(n: int, gen):
    """p, g, m, v over n parameters, with |g| above 1 so the clip acts."""
    p = torch.randn(n, generator=gen, device="cuda")
    g = torch.randn(n, generator=gen, device="cuda") * 1e-3
    m = torch.randn(n, generator=gen, device="cuda") * 1e-4
    v = torch.rand(n, generator=gen, device="cuda") * 1e-7
    return p, g, m, v


ADAMW_ARGS = dict(lr=1e-5, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01,
                  step=10, max_norm=1.0)


def check_adamw(record, n: int) -> float:
    """A1 against adamw_reference on the card over n parameters, AdamW and
    coupled Adam; max relative error of p, m and v."""
    from meant_tpu_torch.ops.adamw import (adamw_reference, update_scalars,
                                           adamw_update)
    gen = torch.Generator(device="cuda").manual_seed(3)
    worst_abs, worst_rel = 0.0, 0.0
    for coupled in (False, True):
        p, g, m, v = adamw_case(n, gen)
        ref = [t.clone() for t in (p, m, v)]
        norm = torch.linalg.vector_norm(g)
        args = dict(ADAMW_ARGS, coupled=coupled)
        adamw_update(p, g, m, v, norm=norm, **args)
        h = update_scalars(**{k: v_ for k, v_ in args.items()
                        if k != "max_norm"})
        adamw_reference(ref[0], g, ref[1], ref[2], h, norm, 1.0)
        torch.cuda.synchronize()
        for name, a, b in zip(("p", "m", "v"), (p, m, v), ref):
            rel = ((a - b).abs() / b.abs().clamp_min(1e-30)).max().item()
            worst_rel = max(worst_rel, rel)
            if name == "p":
                worst_abs = max(worst_abs, (a - b).abs().max().item())
            label = "Adam (coupled)" if coupled else "AdamW"
            print(f"A1 vs plain {label} {name}: max relative error "
                  f"{rel:.3e} over {n} parameters", flush=True)
            if not (rel <= ADAMW_REL_ERR and torch.isfinite(a).all()):
                fail(f"A1 disagrees with its plain version ({label} {name}, "
                     f"max relative error {rel})")
        del p, g, m, v, ref
    record.update(a1_vs_plain_max_rel_err=worst_rel,
                  a1_vs_plain_max_abs_err=worst_abs, a1_params=n)
    return worst_abs


# ---- phase 3: the slice ------------------------------------------------

def build_flagship(seq: int = SEQ, **kw):
    """The flagship meant_src; at seq > 512 the fusion projection is
    max(512, seq) wide, as bench.py's build_src makes it."""
    from meant_tpu_torch.models import EmbeddingConfig, meant_src
    kw.setdefault("num_encoders", ENCODERS)
    return meant_src(text_dim=DIM, image_dim=DIM, price_dim=5, height=IMAGE,
                     width=IMAGE, patch_res=PATCH, lag=LAG, num_classes=2,
                     embedding=EmbeddingConfig(), num_heads=HEADS,
                     channels=3, seq_len=max(SEQ, seq), dtype=torch.bfloat16,
                     device="cuda", seed=0, **kw)


def request_batch(n: int, seed: int = 0, seq: int = SEQ):
    rng = np.random.RandomState(seed)
    return {
        "input_ids": rng.randint(2, 64000, size=(n, LAG, seq)).astype(
            np.int32),
        "pixels": rng.randn(n, LAG, 3, IMAGE, IMAGE).astype(np.float32),
        "prices": rng.randn(n, LAG, 5).astype(np.float32),
        "attention_mask": np.ones((n, LAG, seq), np.float32),
    }


def towers_and_probs(model, predictor, chunk):
    """Probabilities and both towers' outputs of one request."""
    got = {}
    hooks = [model.languageEncoders.register_forward_hook(
                 lambda m, i, o: got.__setitem__("text", o.float())),
             model.visionEncoders.register_forward_hook(
                 lambda m, i, o: got.__setitem__("vision", o.float()))]
    try:
        got["probs"] = predictor.forward(chunk).float()
    finally:
        for h in hooks:
            h.remove()
    torch.cuda.synchronize()
    return got


def compare_slice(label, flash_out, plain_out, record):
    res = {}
    for name in ("text", "vision"):
        a, b = flash_out[name], plain_out[name]
        rel = ((a - b).norm() / b.norm()).item()
        res[f"{name}_rel_l2"] = rel
        if not (torch.isfinite(a).all() and rel <= TOWER_REL_L2):
            fail(f"{label}: {name} tower differs from the plain attention "
                 f"(relative L2 {rel:.3e} > {TOWER_REL_L2})")
    perr = (flash_out["probs"] - plain_out["probs"]).abs().max().item()
    res["probs_max_abs_err"] = perr
    if perr > PROBS_ATOL:
        fail(f"{label}: probabilities differ from the plain attention by "
             f"{perr:.3e} > {PROBS_ATOL}")
    print(f"slice {label} flash vs plain: {json.dumps(res)}", flush=True)
    record[f"slice_{label}"] = res


def run_slice(record):
    from meant_tpu_torch.ops.flash import flash_fwd
    from meant_tpu_torch.serve import Predictor

    model = build_flagship(flash=True)
    n_params = sum(p.numel() for p in model.parameters())
    predictor = Predictor(model, "meant_src", batch_size=BATCH)
    batch = request_batch(REQUEST_ROWS)
    predictor({k: v[:BATCH] for k, v in batch.items()})   # warm-up
    torch.cuda.synchronize()

    # the main path: counts to 0 just before, read just after
    reset_counts()
    probs = predictor(batch)
    torch.cuda.synchronize()
    counts = read_counts()
    launches = flash_fwd.launches
    by_shape = dict(flash_fwd.launches_by_shape)
    n_requests = -(-REQUEST_ROWS // BATCH)
    want = n_requests * 2 * ENCODERS
    print(f"served {REQUEST_ROWS} rows in {n_requests} requests: probs "
          f"{probs.shape}, flash_fwd launches {launches} (want {want}, and "
          f"as many R1), by (s, causal) {by_shape}; {n_params} parameters",
          flush=True)
    check_counts(counts, {"K1": want, "R1": want}, "serving the flagship")
    if probs.shape != (REQUEST_ROWS, 2) or not np.isfinite(probs).all():
        fail(f"bad probabilities {probs.shape}")
    if not ((probs > 0) & (probs < 1)).all():
        fail("sigmoid outputs outside (0, 1)")
    record.update(n_params=n_params, launches=launches,
                  launches_by_shape={shape_key(s, c): n
                                     for (s, c), n in by_shape.items()})

    # the same weights with the plain attention, at fixed_proj False (the
    # served model) and True (where the probabilities depend on the towers)
    chunk = {k: v[:BATCH] for k, v in batch.items()}
    state = model.state_dict()
    plain = build_flagship(flash=False)
    plain.load_state_dict(state)
    compare_slice("bug_faithful", towers_and_probs(model, predictor, chunk),
                  towers_and_probs(plain, Predictor(plain, "meant_src",
                                                    batch_size=BATCH), chunk),
                  record)
    del plain
    fixed = {}
    for flash in (True, False):
        m = build_flagship(flash=flash, fixed_proj=True)
        m.load_state_dict({k: v for k, v in state.items()
                           if k in m.state_dict()})
        fixed[flash] = towers_and_probs(
            m, Predictor(m, "meant_src", batch_size=BATCH), chunk)
        del m
    compare_slice("fixed_proj", fixed[True], fixed[False], record)
    spread = fixed[True]["probs"].std(dim=0).max().item()
    record["fixed_proj_probs_std"] = spread
    if spread == 0.0:
        fail("fixed_proj probabilities do not depend on the inputs")
    return predictor, chunk, by_shape


# ---- phase 4: training ---------------------------------------------------

def train_batch(n: int, seed: int, seq: int = SEQ):
    batch = request_batch(n, seed, seq)
    batch["y"] = np.random.RandomState(seed + 100).randint(
        0, 2, size=(n,)).astype(np.int32)
    return batch


def to_card(batch):
    from meant_tpu_torch.data.loader import host_tensor
    return {k: host_tensor(v).to("cuda") for k, v in batch.items()}


def _group(name: str) -> str:
    if name.startswith(("embedding", "languageEncoders", "lang_proj")):
        return "text"
    if name.startswith(("patchEmbed", "visionEncoders", "image_proj")):
        return "vision"
    if name.startswith(("mlm_head", "decoder")):    # the pretrainers' heads
        return "head"
    return "temporal_and_head"


def classify_loss(model_name):
    """loss_fn(model, batch) of meant_trainer's objective."""
    from meant_tpu_torch.train.classify import model_inputs, sigmoid_ce_loss

    def loss_fn(model, batch):
        args, kwargs = model_inputs(model_name, batch)
        return sigmoid_ce_loss(model(*args, **kwargs), batch["y"])
    return loss_fn


def step_gradients(model, batch, loss_fn):
    """Loss and parameter gradients (flat fp32, by group) of one step with
    dropout off."""
    model.eval()
    model.zero_grad(set_to_none=True)
    loss = loss_fn(model, batch)
    loss.backward()
    torch.cuda.synchronize()
    groups = {}
    for name, p in model.named_parameters():
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        groups.setdefault(_group(name), []).append(g.reshape(-1).float())
    return loss.item(), {k: torch.cat(v) for k, v in groups.items()}


def wrappers() -> dict:
    """Every kernel's wrapper by its name in PERF.md."""
    from meant_tpu_torch.ops.adamw import fused_adamw
    from meant_tpu_torch.ops.flash import (flash_bwd, flash_bwd_dkdv,
                                           flash_bwd_dq, flash_fwd,
                                           flash_fwd_online, rotate_qk)
    return {"K1": flash_fwd, "K2": flash_bwd, "K3": flash_fwd_online,
            "R1": rotate_qk, "K4": flash_bwd_dq, "K5": flash_bwd_dkdv,
            "A1": fused_adamw}


def reset_counts():
    for w in wrappers().values():
        w.launches = 0
        w.launches_by_shape.clear()


def read_counts() -> dict:
    """Launch counts; K1's and K2's also by (s, causal), keyed
    "s<s> causal=<c>", and R1's by s, keyed "s<s>"."""
    counts = {name: w.launches for name, w in wrappers().items()}
    for name in ("K1", "K2"):
        counts[f"{name}_by_shape"] = {
            shape_key(s, c): n
            for (s, c), n in wrappers()[name].launches_by_shape.items()}
    counts["R1_by_shape"] = {
        f"s{s}": n for (s,), n in wrappers()["R1"].launches_by_shape.items()}
    return counts


def check_counts(counts: dict, want: dict, label: str):
    """Fail unless every kernel launched exactly as `want` says (0 for the
    kernels it does not name)."""
    full = {name: want.get(name, 0) for name in wrappers()}
    got = {name: counts[name] for name in full}
    if got != full:
        fail(f"{label} launched {got}, want {full}")


def shape_key(s: int, causal: bool) -> str:
    return f"s{s} causal={bool(causal)}"


def compare_step_gradients(model, batch, want, make_plain, label,
                           model_name="meant_src", loss_fn=None):
    """One step's gradients through the kernels (exactly `want` launches)
    vs the plain attention (`make_plain()`, given the same weights), on the
    same batch, of meant_trainer's objective unless `loss_fn` says another.
    Returns the record."""
    loss_fn = loss_fn or classify_loss(model_name)
    reset_counts()
    loss_k, grads_k = step_gradients(model, batch, loss_fn)
    check_counts(read_counts(), want, label)
    plain = make_plain()
    plain.load_state_dict(model.state_dict())
    loss_p, grads_p = step_gradients(plain, batch, loss_fn)
    del plain
    torch.cuda.empty_cache()
    res = {"loss_kernels": loss_k, "loss_plain": loss_p}
    for name, g in grads_k.items():
        rel = rel_l2(g, grads_p[name])
        res[f"{name}_grad_rel_l2"] = rel
        if not (torch.isfinite(g).all() and rel <= STEP_GRAD_REL_L2):
            fail(f"step gradients of {name} differ from the plain "
                 f"attention (relative L2 {rel:.3e} > {STEP_GRAD_REL_L2})")
        if g.norm().item() == 0.0:
            fail(f"step gradients of {name} are all zero")
    rows = len(next(iter(batch.values())))
    print(f"{label} gradients, kernels vs plain attention ({rows} rows): "
          f"{json.dumps(res)}", flush=True)
    return res


def train_steps(model, host, steps, per_step, label, model_name="meant_src",
                falling=True):
    """`steps` steps of meant_trainer on one replayed batch (numpy `host`)
    at LEARN_LR constant (`timed_steps`)."""
    from meant_tpu_torch.data.loader import ArrayLoader
    from meant_tpu_torch.train.classify import meant_trainer
    trainer = meant_trainer({
        "model": model, "model_name": model_name,
        "train_loader": ArrayLoader(host, len(host["y"])),
        "lrst": "constant", "lr": LEARN_LR, "seed": 0, "test_model": False})
    return timed_steps(trainer, host, steps, per_step, label, falling)


def timed_steps(trainer, host, steps, per_step, label, falling=True):
    """`steps` steps of `trainer` on one replayed batch (numpy `host`): a
    training main path, counts set to 0 just before and read just after,
    exactly `per_step` launches per step and a finite loss, falling unless
    `falling` is False (a step timed only). Returns the record, the trainer
    and the device batch."""
    rows = len(next(iter(host.values())))
    trainer._init_state()
    n_trainable = trainer.optimizer.flat_p.numel()
    lr = trainer.optimizer.schedule(0)
    batch = to_card(host)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    losses, times = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = trainer.train_step(batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(out[0] if isinstance(out, tuple) else out)
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    losses = torch.stack(losses).tolist()
    want = {k: n * steps for k, n in per_step.items()}
    print(f"{label}: {steps} steps of {rows} replayed rows at lr "
          f"{lr}: loss {losses[0]:.5f} -> {losses[-1]:.5f}; "
          f"launches {counts} (want {want})", flush=True)
    check_counts(counts, want, f"{label}'s training steps")
    if not all(np.isfinite(losses)) or (falling
                                        and not losses[-1] < losses[0]):
        fail(f"{label}: loss not finite and falling: {losses}")
    steady = times[1:]
    median = statistics.median(steady)
    res = {
        "rows": rows, "steps": steps, "lr": lr,
        "losses": losses, "step_ms": times, "step_ms_median": median,
        "samples_per_s": rows / median * 1e3, "peak_memory_bytes": peak,
        "launches": counts, "trainable_params": n_trainable}
    print(f"{label} step ({rows} rows, host clock, synchronized) median "
          f"{median:.3f} ms over steps 2-{steps}: "
          f"{rows / median * 1e3:.2f} samples/s; peak memory "
          f"{peak / 2 ** 30:.2f} GiB; {n_trainable} trainable parameters",
          flush=True)
    return res, trainer, batch


def learn(model, record):
    """LEARN_STEPS steps of the flagship at batch 16."""
    res, trainer, batch = train_steps(
        model, train_batch(BATCH, seed=1), LEARN_STEPS,
        {"K1": 24, "R1": 24, "K2": 24, "A1": 1}, "learn")
    record["train"] = res
    record["train_profile"] = profile_calls(
        lambda: trainer.train_step(batch), PROFILE_STEPS, "step")
    return res["launches"]


def train_through_cli(record):
    """cli.in_loop_train trains one epoch, evaluates and saves; Predictor
    restores the checkpoint and must give the trained model's
    probabilities."""
    from meant_tpu_torch.cli import in_loop_train
    from meant_tpu_torch.cli.common import base_parser, build_model
    from meant_tpu_torch.serve import Predictor
    rows = request_batch(BATCH, seed=2)
    with tempfile.TemporaryDirectory() as d:
        argv = ["-rid", "smoke", "-mn", "meant_src", "--seq_len", str(SEQ),
                "-nec", str(ENCODERS), "--synthetic_n", "64", "-tb",
                str(BATCH), "-ne", "1", "-fp", d, "-lrst", "constant",
                "-l", str(LEARN_LR)]
        reset_counts()
        results = in_loop_train.main(argv)
        counts = read_counts()
        trainer = results["trainer"]
        steps = trainer.optimizer.step_count
        # the evaluation's forwards launch K1 and R1 too
        if (counts["A1"] != steps or counts["K2"] != 24 * steps
                or counts["K1"] < 24 * steps or counts["R1"] != counts["K1"]
                or counts["K3"] or counts["K4"] or counts["K5"]):
            fail(f"the CLI's {steps} steps launched {counts}")
        if results["checkpoint"] is None:
            fail("the CLI saved no checkpoint")
        trained = Predictor(trainer.model, "meant_src",
                            batch_size=BATCH)(rows)
        del trainer, results["trainer"]
        restored_model = build_model(base_parser().parse_args(argv))
        served = Predictor(restored_model, "meant_src",
                           checkpoint_path=results["checkpoint"],
                           batch_size=BATCH)(rows)
    same = bool(np.array_equal(trained, served))
    print(f"cli.in_loop_train: {steps} steps, launches {counts}, test "
          f"f1_macro {results['test']['f1_macro']:.4f}; Predictor from its "
          f"checkpoint: probabilities {'equal' if same else 'DIFFER'}",
          flush=True)
    if not same:
        fail("Predictor(checkpoint_path=...) does not serve the trained "
             f"model's probabilities (max diff "
             f"{np.abs(trained - served).max()})")
    record["cli_train"] = {"steps": steps, "launches": counts,
                           "history": results["history"],
                           "test": results["test"]}
    del restored_model
    torch.cuda.empty_cache()


def run_training(record):
    model = build_flagship(flash=True, fixed_proj=True)
    record["step_gradients"] = compare_step_gradients(
        model, to_card(train_batch(GRAD_ROWS, seed=5)),
        {"K1": 24, "R1": 24, "K2": 24},
        lambda: build_flagship(flash=False, fixed_proj=True), "train step")
    counts = learn(model, record)
    del model
    torch.cuda.empty_cache()
    train_through_cli(record)
    return counts


# ---- phase 5: the long-sequence path (src4096) ---------------------------

def serve_long(record):
    """Predictor serves LONG_REQUEST_ROWS rows of src4096 in requests of
    LONG_BATCH: exactly 12 K3 (text, s=4096) + 12 K1 (vision) per forward,
    each behind its R1;
    then the towers and probabilities of one request against the plain
    attention."""
    from meant_tpu_torch.serve import Predictor
    model = build_flagship(LONG_SEQ, flash=True)
    n_params = sum(p.numel() for p in model.parameters())
    predictor = Predictor(model, "meant_src", batch_size=LONG_BATCH)
    batch = request_batch(LONG_REQUEST_ROWS, seed=3, seq=LONG_SEQ)
    chunk = {k: v[:LONG_BATCH] for k, v in batch.items()}
    predictor(chunk)    # warm-up
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    probs = predictor(batch)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    counts = read_counts()
    n_requests = LONG_REQUEST_ROWS // LONG_BATCH
    print(f"served src4096: {LONG_REQUEST_ROWS} rows in {n_requests} "
          f"requests of {LONG_BATCH} in {wall_ms:.3f} ms (host clock): probs "
          f"{probs.shape}, launches {counts}; {n_params} parameters",
          flush=True)
    check_counts(counts, {"K1": n_requests * ENCODERS,
                          "R1": 2 * n_requests * ENCODERS,
                          "K3": n_requests * ENCODERS}, "serving src4096")
    if (probs.shape != (LONG_REQUEST_ROWS, 2) or not np.isfinite(probs).all()
            or not ((probs > 0) & (probs < 1)).all()):
        fail(f"bad src4096 probabilities {probs}")
    plain = build_flagship(LONG_SEQ, flash=False)
    plain.load_state_dict(model.state_dict())
    compare_slice("long", towers_and_probs(model, predictor, chunk),
                  towers_and_probs(plain, Predictor(plain, "meant_src",
                                                    batch_size=LONG_BATCH),
                                   chunk), record)
    del model, plain, predictor
    torch.cuda.empty_cache()
    return {"rows": LONG_REQUEST_ROWS, "requests": n_requests,
            "wall_ms": wall_ms, "launches": counts, "n_params": n_params,
            "probs": probs.tolist()}


def run_long(record):
    """src4096: serve, one step's gradients against the plain attention at
    LONG_GRAD_ENCODERS encoders per tower and 1 row, then LONG_STEPS
    meant_trainer steps at batch 2 and a profiled step."""
    res = {"serve": serve_long(record)}
    n = LONG_GRAD_ENCODERS
    small = build_flagship(LONG_SEQ, flash=True, fixed_proj=True,
                           num_encoders=n)
    res["step_gradients"] = compare_step_gradients(
        small, to_card(train_batch(1, seed=6, seq=LONG_SEQ)),
        # R1 in front of K3, of K1 (whose Qr, Kr K2 takes) and of K4 + K5
        {"K1": n, "K2": n, "K3": n, "R1": 3 * n, "K4": n, "K5": n},
        lambda: build_flagship(LONG_SEQ, flash=False, fixed_proj=True,
                               num_encoders=n), "src4096 step")
    del small
    torch.cuda.empty_cache()
    model = build_flagship(LONG_SEQ, flash=True, fixed_proj=True)
    train, trainer, batch = train_steps(
        model, train_batch(LONG_BATCH, seed=7, seq=LONG_SEQ), LONG_STEPS,
        {"K1": ENCODERS, "K2": ENCODERS, "K3": ENCODERS, "R1": 3 * ENCODERS,
         "K4": ENCODERS, "K5": ENCODERS, "A1": 1}, "learn src4096")
    res["train"] = train
    res["train_profile"] = profile_calls(
        lambda: trainer.train_step(batch), 1, "step", LONG_BATCH)
    record["long"] = res
    del model, trainer, batch
    torch.cuda.empty_cache()
    return train["launches"]


# ---- phase 6: the paper generation (meant, bench.py's paper128) ---------

def paper_args(*extra):
    from meant_tpu_torch.cli.common import base_parser
    return base_parser().parse_args(PAPER_ARGV + list(extra))


def build_paper(flash: bool = True):
    """meant through the CLI's build_model at paper128's width, seed 0."""
    from meant_tpu_torch.cli.common import build_model
    return build_model(paper_args("--flash", str(flash).lower()))


def paper_batch(n: int, seed: int, labels: bool = False):
    """Rows as bench.py's paper128 draws them: tweets, 4-channel charts and
    an all-ones mask (the flash path drops the mask, so with padding the
    flash and plain models would compute different functions)."""
    rng = np.random.RandomState(seed)
    batch = {
        "tweets": rng.randint(2, 64000, size=(n, LAG, PAPER_SEQ)).astype(
            np.int32),
        "graphs": rng.randn(n, LAG, 4, IMAGE, IMAGE).astype(np.float32),
        "attention_masks": np.ones((n, LAG, PAPER_SEQ), np.float32)}
    if labels:
        batch["y"] = rng.randint(0, 2, size=(n,)).astype(np.int32)
    return batch


def serve_paper(res):
    """Predictor serves REQUEST_ROWS meant rows in requests of BATCH: exactly
    24 R1 + 24 K1 per forward (12 at s=128 causal xPos, 12 at s=196), no
    K2-K5; towers and probabilities against the plain attention; the
    request's median time and a profiled forward. Returns K1's launches by
    shape."""
    from meant_tpu_torch.serve import Predictor
    model = build_paper()
    res["n_params"] = sum(p.numel() for p in model.parameters())
    predictor = Predictor(model, "meant", batch_size=BATCH)
    batch = paper_batch(REQUEST_ROWS, seed=10)
    chunk = {k: v[:BATCH] for k, v in batch.items()}
    predictor(chunk)    # warm-up
    torch.cuda.synchronize()
    reset_counts()
    probs = predictor(batch)
    torch.cuda.synchronize()
    counts = read_counts()
    n_requests = -(-REQUEST_ROWS // BATCH)
    want = n_requests * 2 * ENCODERS
    print(f"served meant: {REQUEST_ROWS} rows in {n_requests} requests: "
          f"probs {probs.shape}, launches {counts}; {res['n_params']} "
          f"parameters", flush=True)
    check_counts(counts, {"K1": want, "R1": want}, "serving meant")
    by_shape = {shape_key(PAPER_SEQ, True): n_requests * ENCODERS,
                shape_key(N_PATCHES, False): n_requests * ENCODERS}
    if counts["K1_by_shape"] != by_shape:
        fail(f"meant's K1 launches by shape {counts['K1_by_shape']}, want "
             f"{by_shape}")
    if (probs.shape != (REQUEST_ROWS, 2) or not np.isfinite(probs).all()
            or not ((probs > 0) & (probs < 1)).all()):
        fail(f"bad meant probabilities {probs}")
    plain = build_paper(flash=False)
    plain.load_state_dict(model.state_dict())
    compare_slice("paper", towers_and_probs(model, predictor, chunk),
                  towers_and_probs(plain, Predictor(plain, "meant",
                                                    batch_size=BATCH),
                                   chunk), res)
    del plain
    torch.cuda.empty_cache()
    res["launches"] = counts
    time_requests(predictor, chunk, res, label="meant")
    res["profile"] = profile_calls(lambda: predictor.forward(chunk),
                                   PROFILE_FORWARDS, "forward")
    del model, predictor
    torch.cuda.empty_cache()
    return counts["K1_by_shape"]


def learn_paper(res):
    """One step's gradients against the plain attention (GRAD_ROWS rows,
    dropout off), LEARN_STEPS meant_trainer steps at batch 16 with the
    default ff_dropout=0.5 (exactly 24 K1, 24 R1, 24 K2 and 1 A1 a step,
    finite falling loss), a profiled step, and the same step at
    flash=False, timed and profiled only. Returns the steps' counts."""
    model = build_paper()
    res["step_gradients"] = compare_step_gradients(
        model, to_card(paper_batch(GRAD_ROWS, seed=11, labels=True)),
        {"K1": 24, "R1": 24, "K2": 24}, lambda: build_paper(flash=False),
        "meant step", model_name="meant")
    host = paper_batch(BATCH, seed=12, labels=True)
    train, trainer, batch = train_steps(
        model, host, LEARN_STEPS, {"K1": 24, "R1": 24, "K2": 24, "A1": 1},
        "learn meant", model_name="meant")
    res["train"] = train
    res["train_profile"] = profile_calls(
        lambda: trainer.train_step(batch), PROFILE_STEPS, "step")
    del model, trainer, batch
    torch.cuda.empty_cache()
    plain, trainer, batch = train_steps(
        build_paper(flash=False), host, PAPER_PLAIN_STEPS, {"A1": 1},
        "meant at flash=False (timed only)", model_name="meant",
        falling=False)
    plain["profile"] = profile_calls(lambda: trainer.train_step(batch), 1,
                                     "step")
    res["plain_train"] = plain
    del trainer, batch
    torch.cuda.empty_cache()
    return train["launches"]


def write_tempstock(path: str, n: int, seed: int):
    """A TempStock-small set at full shape in its layout: graphs_5.npy (n,
    5, 4, 224, 224) fp32, tweets_5.npy (n, 5, 128) int64 with trailing pad
    id 1 where attention_masks_5.npy is 0, macds_5.npy (n, 5, 4) and
    y_resampled_5.npy (n,)."""
    import os
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, PAPER_SEQ + 1, size=(n, LAG))
    masks = (np.arange(PAPER_SEQ) < lengths[..., None]).astype(np.float32)
    tweets = np.where(masks > 0, rng.integers(2, 64000, (n, LAG, PAPER_SEQ)),
                      1)
    arrays = {
        "graphs": rng.standard_normal((n, LAG, 4, IMAGE, IMAGE),
                                      dtype=np.float32),
        "tweets": tweets.astype(np.int64), "attention_masks": masks,
        "macds": rng.standard_normal((n, LAG, 4), dtype=np.float32),
        "y_resampled": rng.integers(0, 2, size=(n,))}
    for name, a in arrays.items():
        np.save(os.path.join(path, f"{name}_{LAG}.npy"), a)


def paper_through_cli(res):
    """cli.in_loop_train -mn meant --flash true --data_dir trains one epoch
    of a TempStock-small set written here, evaluates and saves; cli.eval on
    its checkpoint must give the trainer's test confusion matrix, and
    Predictor(checkpoint_path=...) must serve the test rows with the trained
    model's probabilities."""
    import os
    from meant_tpu_torch.cli import eval as eval_cli
    from meant_tpu_torch.cli import in_loop_train
    from meant_tpu_torch.cli.common import build_model
    from meant_tpu_torch.data.datasets import (load_tempstock_small,
                                               split_arrays)
    from meant_tpu_torch.serve import Predictor
    with tempfile.TemporaryDirectory() as d:
        data = os.path.join(d, "data")
        os.makedirs(data)
        write_tempstock(data, PAPER_DATA_ROWS, seed=13)
        argv = PAPER_ARGV + ["--data_dir", data, "-ne", "1", "-tb",
                             str(BATCH), "-fp", d, "-lrst", "constant", "-l",
                             str(LEARN_LR)]
        reset_counts()
        results = in_loop_train.main(argv)
        counts = read_counts()
        trainer = results["trainer"]
        steps = trainer.optimizer.step_count
        forwards = steps + len(trainer.val_loader) + len(trainer.test_loader)
        check_counts(counts, {"K1": 24 * forwards, "R1": 24 * forwards,
                              "K2": 24 * steps, "A1": steps},
                     f"the CLI's {steps} meant steps and "
                     f"{forwards - steps} evaluation forwards")
        if results["checkpoint"] is None:
            fail("the CLI saved no meant checkpoint")
        metrics = eval_cli.main(argv + ["-ptm", results["checkpoint"]])
        if metrics["confusion"] != results["test"]["confusion"]:
            fail(f"cli.eval's confusion matrix {metrics['confusion']} is not "
                 f"the trainer's {results['test']['confusion']}")
        _, _, test = split_arrays(load_tempstock_small(data))
        rows = {k: test[k] for k in ("tweets", "graphs", "attention_masks")}
        trained = Predictor(trainer.model, "meant", batch_size=BATCH)(rows)
        del trainer, results["trainer"]
        served = Predictor(build_model(paper_args(*argv[len(PAPER_ARGV):])),
                           "meant", checkpoint_path=results["checkpoint"],
                           batch_size=BATCH)(rows)
    same = bool(np.array_equal(trained, served))
    print(f"cli.in_loop_train -mn meant --data_dir ({PAPER_DATA_ROWS} rows): "
          f"{steps} steps, launches {counts}, test confusion "
          f"{results['test']['confusion']} (cli.eval: the same); Predictor "
          f"from its checkpoint on {len(trained)} test rows: probabilities "
          f"{'equal' if same else 'DIFFER'}", flush=True)
    if not same:
        fail("Predictor(checkpoint_path=...) does not serve the trained "
             f"meant's probabilities (max diff "
             f"{np.abs(trained - served).max()})")
    res["cli_train"] = {"steps": steps, "launches": counts,
                        "history": results["history"],
                        "test": results["test"], "eval": metrics}
    torch.cuda.empty_cache()


def run_paper(record):
    """The paper-generation main paths: serve, train, the CLI on
    TempStock-small files, and A1 at meant's parameter count. Returns the
    counts the timing rows report."""
    res = {}
    record["paper"] = res
    serve_by_shape = serve_paper(res)
    train_counts = learn_paper(res)
    paper_through_cli(res)
    a1_err = check_adamw(res, res["n_params"])
    return {"serve_by_shape": serve_by_shape, "train": train_counts,
            "a1_err": a1_err, "n_params": res["n_params"]}


# ---- phase 9: pretraining (MLM, MIM) and grafting into meant -------------

def build_pretrainer(kind: str, flash: bool = True):
    """bench.py's build_mlm / build_mim model: 12 encoders of width 768, 8
    heads of 96, bf16 activations with fp32 params, seed 0; the MLM at vocab
    64001 with the tied head, the MIM on 4-channel 224^2 charts."""
    from meant_tpu_torch import models
    common = dict(num_encoders=ENCODERS, num_heads=HEADS, flash=flash,
                  dtype=torch.bfloat16, device="cuda", seed=0)
    if kind == "mlm":
        return models.meant_language_pretrainer(
            embedding=models.EmbeddingConfig(hidden_size=DIM), text_dim=DIM,
            **common)
    return models.meant_vision_pretrainer(
        patch_res=PATCH, channels=4, height=IMAGE, width=IMAGE,
        image_dim=DIM, **common)


def pretrain_batch(kind: str, seed: int = 0) -> dict:
    """bench.py's rows: 16 texts of 128 ids in [4, 64000) masked by
    mask_tokens(seed=1) with an all-ones mask, or 16 charts U[0, 1) masked
    by mask_image(seed=1)."""
    from meant_tpu_torch.data.masking import mask_image, mask_tokens
    rng = np.random.RandomState(seed)
    if kind == "mlm":
        ids = rng.randint(4, 64000, size=(BATCH, PAPER_SEQ))
        inputs, labels = mask_tokens(ids, mask_token_id=64000,
                                     special_ids=(0, 1, 2), seed=1)
        return {"input_ids": inputs.astype(np.int32),
                "attention_mask": np.ones((BATCH, PAPER_SEQ), np.float32),
                "labels": labels.astype(np.int32)}
    inputs, labels = mask_image(
        rng.rand(BATCH, 4, IMAGE, IMAGE).astype(np.float32), seed=1)
    return {"input_ids": inputs, "labels": labels}


def pretrainer(kind: str, model, host: dict, **kw):
    """The pretrainer of `kind` on one replayed batch at PRETRAIN_LR
    constant (the CLIs' default rate)."""
    from meant_tpu_torch.train.pretrain import mim_pretrainer, mlm_pretrainer
    cls = mlm_pretrainer if kind == "mlm" else mim_pretrainer
    return cls({"model": model, "train_data": [host], "lrst": "constant",
                "lr": PRETRAIN_LR, "seed": 0, **kw})


def pretrain_loss(kind: str, **kw):
    """loss_fn(model, batch) of the pretrainer's objective."""
    return lambda model, batch: pretrainer(kind, model, batch, **kw).loss(
        batch)


def learn_pretrain(kind: str, res: dict):
    """One step's gradients against the plain attention (dropout off), for
    the MLM the gathered head against the full one, LEARN_STEPS steps on
    one replayed batch with exactly 12 R1, 12 K1, 12 K2 and 1 A1 a step and
    a falling loss, a profiled step, and the same step at flash=False (timed
    and profiled only). Returns the steps' counts."""
    per_fwd = {"R1": ENCODERS, "K1": ENCODERS}
    model = build_pretrainer(kind)
    res["n_params"] = sum(p.numel() for p in model.parameters())
    want_params = MLM_PARAMS if kind == "mlm" else MIM_PARAMS
    print(f"{kind} pretrainer: {res['n_params']} parameters (want "
          f"{want_params})", flush=True)
    if res["n_params"] != want_params:
        fail(f"the {kind} pretrainer has {res['n_params']} parameters, "
             f"want {want_params}")
    host = pretrain_batch(kind)
    batch = to_card(host)
    res["step_gradients"] = compare_step_gradients(
        model, batch, dict(per_fwd, K2=ENCODERS),
        lambda: build_pretrainer(kind, flash=False), f"{kind} step",
        loss_fn=pretrain_loss(kind))
    if kind == "mlm":
        res["full_head"] = compare_heads(model, batch)
    train, trainer, batch = timed_steps(
        pretrainer(kind, model, host), host, LEARN_STEPS,
        dict(per_fwd, K2=ENCODERS, A1=1), f"learn {kind}")
    res["train"] = train
    res["train_profile"] = profile_calls(
        lambda: trainer.train_step(batch), PROFILE_STEPS, "step")
    del model, trainer, batch
    torch.cuda.empty_cache()
    plain, trainer, batch = timed_steps(
        pretrainer(kind, build_pretrainer(kind, flash=False), host), host,
        PAPER_PLAIN_STEPS, {"A1": 1},
        f"{kind} at flash=False (bench.py's setting; timed only)",
        falling=False)
    plain["profile"] = profile_calls(lambda: trainer.train_step(batch), 1,
                                     "step")
    res["plain_train"] = plain
    del trainer, batch
    torch.cuda.empty_cache()
    res["a1_err"] = check_adamw(res, res["n_params"])
    return train["launches"]


def compare_heads(model, batch) -> dict:
    """The gathered MLM head against the full (b, s, vocab) one on one
    batch, kernels on, dropout off: the loss within HEAD_LOSS_REL, each
    group's gradients within STEP_GRAD_REL_L2."""
    loss_g, grads_g = step_gradients(model, batch, pretrain_loss("mlm"))
    loss_f, grads_f = step_gradients(
        model, batch, pretrain_loss("mlm", gather_masked=False))
    res = {"loss_gathered": loss_g, "loss_full": loss_f,
           "loss_rel_err": abs(loss_g - loss_f) / abs(loss_f)}
    for name, g in grads_g.items():
        res[f"{name}_grad_rel_l2"] = rel_l2(g, grads_f[name])
    print(f"mlm gathered head vs full head: {json.dumps(res)}", flush=True)
    if res["loss_rel_err"] > HEAD_LOSS_REL or any(
            v > STEP_GRAD_REL_L2 for k, v in res.items()
            if k.endswith("_grad_rel_l2")):
        fail(f"the gathered MLM head disagrees with the full one: {res}")
    torch.cuda.empty_cache()
    return res


def write_pretrain_data(path: str, kind: str) -> str:
    """PRETRAIN_DATA_ROWS rows in a directory of its own: a .csv of
    synthetic texts (header, one text a row) or a .npy of 4x224^2 charts."""
    import os
    data = os.path.join(path, f"{kind}_data")
    os.makedirs(data)
    rng = np.random.RandomState(21)
    if kind == "mlm":
        with open(os.path.join(data, "tweets.csv"), "w") as f:
            f.write("text\n")
            for _ in range(PRETRAIN_DATA_ROWS):
                f.write(" ".join(f"w{rng.randint(1000)}" for _ in range(30))
                        + "\n")
    else:
        np.save(os.path.join(data, "charts.npy"), rng.rand(
            PRETRAIN_DATA_ROWS, 4, IMAGE, IMAGE).astype(np.float32))
    return data


def pretrain_through_cli(kind: str, d: str) -> tuple:
    """cli.pretrain_mlm / cli.pretrain_mim -ne 1 at their defaults (so
    --flash auto: the kernels run, as in the JAX harness) on a file written
    here; exactly 12 R1 + 12 K1 per forward, 12 K2 and 1 A1 per step.
    Returns the checkpoint path and the record."""
    from meant_tpu_torch.cli import pretrain_mim, pretrain_mlm
    cli = pretrain_mlm if kind == "mlm" else pretrain_mim
    argv = ["-rid", "0", "-nec", str(ENCODERS), "-ne", "1", "-fp", d,
            "--data_dir", write_pretrain_data(d, kind)]
    reset_counts()
    out = cli.main(argv)
    counts = read_counts()
    trainer = out["trainer"]
    steps = trainer.optimizer.step_count
    forwards = steps + len(trainer.val_data)
    check_counts(counts, {"R1": ENCODERS * forwards, "K1": ENCODERS * forwards,
                          "K2": ENCODERS * steps, "A1": steps},
                 f"cli.pretrain_{kind}'s {steps} steps and "
                 f"{forwards - steps} evaluation forwards")
    if out["checkpoint"] is None or not all(
            np.isfinite(h["train_loss"]) and np.isfinite(h["val_loss"])
            for h in out["history"]):
        fail(f"cli.pretrain_{kind}: {out['history']}, checkpoint "
             f"{out['checkpoint']}")
    print(f"cli.pretrain_{kind} ({PRETRAIN_DATA_ROWS} rows, defaults): "
          f"{steps} steps, launches {counts}, history {out['history']}; "
          f"checkpoint {out['checkpoint']}", flush=True)
    del trainer, out["trainer"]
    torch.cuda.empty_cache()
    return out["checkpoint"], {"steps": steps, "launches": counts,
                               "history": out["history"]}


def finetune_from(checkpoint: str, grafted: tuple, d: str) -> dict:
    """cli.in_loop_train -mn meant --flash true -p true -ptm <checkpoint>
    for one epoch: before the first step every entry under `grafted` equals
    the checkpoint's and every other one is the fresh init; then the epoch
    trains (finite loss) with meant's launch counts."""
    from meant_tpu_torch.cli import in_loop_train
    from meant_tpu_torch.train import checkpoint as ckpt
    argv = PAPER_ARGV + ["-ne", "1", "-tb", str(BATCH), "-fp", d, "-lrst",
                         "constant", "-l", str(LEARN_LR), "-p", "true",
                         "-ptm", checkpoint]
    trainer = in_loop_train.prepare(argv)
    fresh = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    source = ckpt.restore(checkpoint, "cuda")["params"]
    trainer._init_state()
    n = 0
    for k, v in trainer.model.state_dict().items():
        want = source[k] if k.startswith(grafted) else fresh[k]
        if not torch.equal(v, want):
            fail(f"after grafting {checkpoint}, {k} is not the "
                 f"{'checkpoint' if k.startswith(grafted) else 'fresh'} "
                 f"value")
        n += k.startswith(grafted)
    del fresh, source
    if n == 0:
        fail(f"nothing under {grafted} was grafted")
    reset_counts()
    results = trainer.train()
    counts = read_counts()
    steps = trainer.optimizer.step_count
    forwards = steps + len(trainer.val_loader) + len(trainer.test_loader)
    check_counts(counts, {"K1": 24 * forwards, "R1": 24 * forwards,
                          "K2": 24 * steps, "A1": steps},
                 f"meant from {grafted} of a pretraining checkpoint")
    loss = results["history"][0]["train_loss"]
    if not np.isfinite(loss):
        fail(f"meant from a pretraining checkpoint: loss {loss}")
    print(f"cli.in_loop_train -mn meant -p true -ptm <{grafted}>: {n} "
          f"entries grafted exactly, the rest fresh; {steps} steps, loss "
          f"{loss:.5f}, launches {counts}", flush=True)
    del trainer, results
    torch.cuda.empty_cache()
    return {"grafted_entries": n, "steps": steps, "train_loss": loss,
            "launches": counts}


def run_pretrain(record) -> dict:
    """Phase 9: the MLM and MIM pretrainers at bench.py's geometry, their
    CLIs, and meant fine-tuned from each CLI's checkpoint."""
    res = {"mlm": {}, "mim": {}}
    record["pretrain"] = res
    out = {}
    for kind in ("mlm", "mim"):
        out[kind] = {"train": learn_pretrain(kind, res[kind]),
                     "n_params": res[kind]["n_params"],
                     "a1_err": res[kind]["a1_err"]}
    with tempfile.TemporaryDirectory() as d:
        for kind, grafted in (("mlm", ("embedding.", "languageEncoders.")),
                              ("mim", ("visionEncoders.",))):
            path, res[kind]["cli"] = pretrain_through_cli(kind, d)
            with tempfile.TemporaryDirectory() as ft:   # 2 GB of meant
                res[kind]["finetune"] = finetune_from(path, grafted, ft)
    return out


# ---- phase 10: serving and memory levers ---------------------------------

def int8_counts() -> dict:
    """The int8 products since the last reset, by (rows, k, n)."""
    from meant_tpu_torch.nn import quant
    return dict(quant.products)


def reset_int8_counts():
    from meant_tpu_torch.nn import quant
    quant.products.clear()


def check_int8_products(shapes, res):
    """(a) The int8 product (cuBLASLt through `torch._int_mm`, zero-padded
    to the shapes it takes) against its plain version, the fp64 product,
    which is exact for int8 operands here: int32 equal at every (rows, k,
    n) the int8 forward used."""
    from meant_tpu_torch.nn.quant import int8_matmul, int8_matmul_reference
    gen = torch.Generator(device="cuda").manual_seed(9)
    rows = []
    for m, k, n in sorted(shapes):
        a = torch.randint(-127, 128, (m, k), generator=gen, device="cuda",
                          dtype=torch.int8)
        w = torch.randint(-127, 128, (n, k), generator=gen, device="cuda",
                          dtype=torch.int8)
        got, want = int8_matmul(a, w), int8_matmul_reference(a, w)
        exact = bool(torch.equal(got, want))
        rows.append({"shape": [m, k, n], "exact": exact,
                     "padded": any(x % 8 for x in (k, n)) or m <= 16})
        if not exact:
            fail(f"int8 product at (rows, k, n) = {(m, k, n)} differs from "
                 f"its plain version by "
                 f"{(got - want).abs().max().item()}")
    print(f"int8 product exact at {len(rows)} shapes: "
          f"{[r['shape'] for r in rows]}", flush=True)
    res["int8_products_checked"] = rows
    reset_int8_counts()


def serve_int8(res):
    """(b) The flagship at fixed_proj=True (its probabilities follow the
    towers) served in bf16 and in int8 at the same weights: exactly 24 R1 +
    24 K1 a forward either way, int8 within JAX's own bars of bf16
    (tests/test_quant.py: atol 0.05, argmax agreement >= 0.9), request and
    forward device times side by side. Returns the int8 product shapes of
    one forward."""
    from meant_tpu_torch.serve import Predictor
    model = build_flagship(flash=True, fixed_proj=True)
    batch = request_batch(REQUEST_ROWS, seed=20)
    chunk = {k: v[:BATCH] for k, v in batch.items()}
    n_requests = -(-REQUEST_ROWS // BATCH)
    want = n_requests * 2 * ENCODERS
    probs, shapes = {}, {}
    for mode in (None, "int8"):
        label = mode or "bf16"
        predictor = Predictor(model, "meant_src", batch_size=BATCH,
                              quantize=mode)
        predictor(chunk)        # warm-up
        torch.cuda.synchronize()
        reset_counts()
        reset_int8_counts()
        probs[label] = predictor(batch)
        torch.cuda.synchronize()
        counts = read_counts()
        shapes[label] = int8_counts()
        check_counts(counts, {"K1": want, "R1": want},
                     f"serving the flagship in {label}")
        print(f"served {REQUEST_ROWS} rows in {label}: launches {counts}; "
              f"int8 products {sum(shapes[label].values())}", flush=True)
        out = res.setdefault(label, {})
        time_requests(predictor, chunk, out, label=f"flagship {label}")
        out["profile"] = profile_calls(lambda: predictor.forward(chunk),
                                       PROFILE_FORWARDS, "forward")
    per_forward = {k: n // n_requests for k, n in shapes["int8"].items()}
    if shapes["bf16"] or not per_forward:
        fail(f"int8 products: bf16 {shapes['bf16']}, int8 {shapes['int8']}")
    err = float(np.abs(probs["int8"] - probs["bf16"]).max())
    agree = float((probs["int8"].argmax(-1)
                   == probs["bf16"].argmax(-1)).mean())
    res.update(int8_products_per_forward={str(k): n for k, n in
                                          per_forward.items()},
               int8_probs_max_abs_err=err, int8_argmax_agreement=agree)
    print(f"int8 vs bf16 serving: max |dprob| {err:.4e} (bar "
          f"{INT8_PROBS_ATOL}), argmax agreement {agree:.3f} (bar "
          f"{INT8_ARGMAX}); {sum(per_forward.values())} int8 products a "
          f"forward at {len(per_forward)} shapes", flush=True)
    if not (np.isfinite(probs["int8"]).all() and err <= INT8_PROBS_ATOL
            and agree >= INT8_ARGMAX):
        fail("int8 serving is outside JAX's bars against bf16")
    del model, predictor
    torch.cuda.empty_cache()
    return per_forward


def serve_paper_int8(res):
    """(b) `cli.serve -mn meant --flash true --seq_len 128 --int8` at
    paper128's width: one 16-row request, 24 R1 + 24 K1."""
    from meant_tpu_torch.cli import serve as serve_cli
    reset_counts()
    probs = serve_cli.main(PAPER_ARGV + ["--int8", "--serve_batch",
                                         str(BATCH), "--synthetic_n",
                                         str(BATCH)])
    torch.cuda.synchronize()
    counts = read_counts()
    check_counts(counts, {"K1": 2 * ENCODERS, "R1": 2 * ENCODERS},
                 "cli.serve -mn meant --int8")
    if probs.shape != (BATCH, 2) or not np.isfinite(probs).all():
        fail(f"cli.serve --int8 gave {probs}")
    res["paper_cli_int8"] = {"launches": counts,
                             "probs_mean": float(probs.mean())}
    torch.cuda.empty_cache()


LOAD_EXPORTED = """
import json, sys
import numpy as np, torch
sys.path.insert(0, sys.argv[1])
from meant_tpu_torch.serve import load_exported
from meant_tpu_torch.ops.flash import flash_fwd, flash_fwd_online, rotate_qk
params = torch.load(sys.argv[3], map_location="cuda")
batch = dict(np.load(sys.argv[4]))
fn = load_exported(sys.argv[2])
fn(params, batch)
torch.cuda.synchronize()
for w in (flash_fwd, flash_fwd_online, rotate_qk):
    w.launches = 0
probs = fn(params, batch)
torch.cuda.synchronize()
np.save(sys.argv[5], probs.float().cpu().numpy())
print(json.dumps({"K1": flash_fwd.launches, "K3": flash_fwd_online.launches,
                  "R1": rotate_qk.launches, "models_imported": sorted(
                      m for m in sys.modules
                      if m.startswith("meant_tpu_torch.models"))}))
"""


def export_flagship(res):
    """(c) `cli.serve -mn meant_src --export` writes the flagship's program;
    a fresh process that imports no model code loads it with
    `load_exported` and serves the CLI's 16 rows with the CLI model's
    params: exactly 24 R1 + 24 K1 a call, probabilities within EXPORT_ATOL
    of the live Predictor's."""
    import contextlib
    import io
    import re
    from meant_tpu_torch.cli import serve as serve_cli
    from meant_tpu_torch.cli.common import build_model, synthetic_batch
    from meant_tpu_torch.serve import Predictor
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "flagship.pt2")
        argv = ["-rid", "smoke", "-mn", "meant_src", "--seq_len", str(SEQ),
                "-nec", str(ENCODERS), "--serve_batch", str(BATCH),
                "--synthetic_n", str(BATCH), "--export", path]
        log = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(log):
            serve_cli.main(argv)
        cli_s = time.perf_counter() - t0
        print(log.getvalue(), end="", flush=True)
        found = re.search(r"exported program .* in ([0-9.]+) s",
                          log.getvalue())
        if not found:
            fail("cli.serve --export printed no export time")
        export_s = float(found.group(1))
        size = os.path.getsize(path)
        args = serve_cli.serve_parser().parse_args(argv)
        model = build_model(args)
        batch = synthetic_batch(args, BATCH)
        del batch["y"]
        live = Predictor(model, "meant_src", batch_size=BATCH)(batch)
        files = [os.path.join(d, f) for f in ("params.pt", "batch.npz",
                                              "probs.npy")]
        torch.save(model.state_dict(), files[0])
        np.savez(files[1], **batch)
        del model
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        done = subprocess.run(
            [sys.executable, "-c", LOAD_EXPORTED, ROOT, path, *files],
            capture_output=True, text=True, timeout=600)
        load_s = time.perf_counter() - t0
        if done.returncode != 0:
            fail(f"load_exported in a fresh process failed:\n"
                 f"{done.stderr[-4000:]}")
        report = json.loads(done.stdout.strip().splitlines()[-1])
        got = np.load(files[2])
    err = float(np.abs(got - live).max())
    res["export"] = dict(cli_s=cli_s, export_s=export_s, artifact_bytes=size,
                         fresh_process_s=load_s, probs_max_abs_err=err,
                         **report)
    print(f"exported flagship: trace + write {export_s:.1f} s, artifact "
          f"{size} bytes; a fresh process ({load_s:.1f} s) launched "
          f"{report}; max |dprob| vs the live Predictor {err:.3e} (bar "
          f"{EXPORT_ATOL})", flush=True)
    if report["models_imported"]:
        fail(f"load_exported imported {report['models_imported']}")
    if (report["K1"], report["R1"], report["K3"]) != (2 * ENCODERS,
                                                      2 * ENCODERS, 0):
        fail(f"the exported flagship launched {report}, want 24 K1 + 24 R1")
    if not err <= EXPORT_ATOL:
        fail(f"the exported flagship differs from the live Predictor by "
             f"{err:.3e}")


def export_long(res):
    """(c) src4096 at 2 encoders a tower, exported and served: its program
    holds the streaming forward, so a call launches K3 (2, and 2 K1 + 4
    R1), within EXPORT_ATOL of the live Predictor."""
    from meant_tpu_torch.serve import Predictor, export_forward, load_exported
    model = build_flagship(seq=LONG_SEQ, flash=True,
                           num_encoders=LONG_GRAD_ENCODERS)
    batch = request_batch(LONG_BATCH, seed=21, seq=LONG_SEQ)
    live = Predictor(model, "meant_src", batch_size=LONG_BATCH)(batch)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "src4096.pt2")
        t0 = time.perf_counter()
        export_forward(model, "meant_src", batch, path)
        export_s = time.perf_counter() - t0
        fn = load_exported(path)
        params = model.state_dict()
        fn(params, batch)
        torch.cuda.synchronize()
        reset_counts()
        got = fn(params, batch).float().cpu().numpy()
        torch.cuda.synchronize()
        counts = read_counts()
    want = {"K3": LONG_GRAD_ENCODERS, "K1": LONG_GRAD_ENCODERS,
            "R1": 2 * LONG_GRAD_ENCODERS}
    check_counts(counts, want, "the exported src4096 program")
    err = float(np.abs(got - live).max())
    res["export_src4096"] = {"export_s": export_s, "launches": counts,
                             "probs_max_abs_err": err}
    print(f"exported src4096 at {LONG_GRAD_ENCODERS} encoders a tower: "
          f"{export_s:.1f} s; a call launched {counts}; max |dprob| "
          f"{err:.3e}", flush=True)
    if not err <= EXPORT_ATOL:
        fail(f"the exported src4096 program differs by {err:.3e}")
    del model
    torch.cuda.empty_cache()


REMAT_SETTINGS = (("off", {}), ("full", {"remat": "full"}),
                  ("dots", {"remat": "dots"}),
                  ("scan_layers", {"scan_layers": True}))


def train_step_grads(model, batch, seed: int = 0):
    """Loss and gradients (flat fp32 by group) of one training-mode step,
    dropout on, drawn from `seed`."""
    from meant_tpu_torch.train.classify import seed_dropout
    model.train()
    model.zero_grad(set_to_none=True)
    seed_dropout(torch.device("cuda"), seed)
    loss = classify_loss("meant_src")(model, batch)
    loss.backward()
    torch.cuda.synchronize()
    groups = {}
    for name, p in model.named_parameters():
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        groups.setdefault(_group(name), []).append(g.reshape(-1).float())
    model.zero_grad(set_to_none=True)
    return loss.item(), {k: torch.cat(v) for k, v in groups.items()}


def remat_steps(res):
    """(d) The flagship at fixed_proj=True trained at remat off, "full",
    "dots" and scan_layers=True (so "dots"), the same weights (seed 0):
    one step's gradients in training mode with dropout on, the same seed,
    against remat off (bit for bit, else within REMAT_GRAD_REL_L2 per
    group; remat off's step is also repeated, to show which groups it
    repeats bit for bit itself); exactly 24 R1 / 24 K1 / 24 K2 a step off and 48 / 48 / 24
    under remat (the backward re-runs R1 + K1), one A1; REMAT_STEPS
    trainer steps for step time and peak memory, and a profiled step."""
    host = train_batch(BATCH, seed=22)
    batch = to_card(host)
    base = None
    for label, kw in REMAT_SETTINGS:
        model = build_flagship(flash=True, fixed_proj=True, **kw)
        fwd = 24 if label == "off" else 48
        reset_counts()
        loss, grads = train_step_grads(model, batch)
        check_counts(read_counts(), {"K1": fwd, "R1": fwd, "K2": 24},
                     f"a training step at remat {label}")
        out = {"loss": loss}
        if base is None:
            base = grads
            # the same step again: what remat off itself repeats bit for bit
            _, again = train_step_grads(model, batch)
            out["repeat_bitwise_equal"] = {
                name: bool(torch.equal(g, base[name]))
                for name, g in again.items()}
            del again
        else:
            for name, g in grads.items():
                same = bool(torch.equal(g, base[name]))
                rel = 0.0 if same else rel_l2(g, base[name])
                out[f"{name}_bitwise_equal"] = same
                out[f"{name}_grad_rel_l2"] = rel
                if not rel <= REMAT_GRAD_REL_L2:
                    fail(f"remat {label}: {name} gradients differ from "
                         f"remat off by {rel:.3e} relative L2")
        del grads
        steps, trainer, card_batch = train_steps(
            model, host, REMAT_STEPS,
            {"K1": fwd, "R1": fwd, "K2": 24, "A1": 1}, f"remat {label}",
            falling=False)
        out.update(step_ms_median=steps["step_ms_median"],
                   step_ms=steps["step_ms"],
                   peak_memory_bytes=steps["peak_memory_bytes"],
                   launches=steps["launches"],
                   profile=profile_calls(
                       lambda: trainer.train_step(card_batch), 1, "step"))
        res[f"remat_{label}"] = out
        print(f"remat {label}: " + json.dumps(
            {k: v for k, v in out.items() if k not in ("profile",
                                                       "launches")}),
              flush=True)
        del model, trainer, card_batch
        torch.cuda.empty_cache()
    off = res["remat_off"]["peak_memory_bytes"]
    for label, _ in REMAT_SETTINGS[1:]:
        if not res[f"remat_{label}"]["peak_memory_bytes"] < off:
            fail(f"remat {label} peaks at "
                 f"{res[f'remat_{label}']['peak_memory_bytes']} bytes, not "
                 f"below remat off's {off}")


def remat_through_cli(res):
    """(e) cli.in_loop_train -mn meant_src with --remat dots, then with
    --scan_layers: one epoch of a 64-row synthetic set (2 steps), exactly
    24 K2 and one A1 a step and at least 48 K1 (the evaluation's forwards
    launch K1 too), as many R1."""
    from meant_tpu_torch.cli import in_loop_train
    for flags in (["--remat", "dots"], ["--scan_layers"]):
        with tempfile.TemporaryDirectory() as d:
            argv = ["-rid", "smoke", "-mn", "meant_src", "--seq_len",
                    str(SEQ), "-nec", str(ENCODERS), "--synthetic_n", "64",
                    "-tb", str(BATCH), "-ne", "1", "-fp", d, "-lrst",
                    "constant", "-l", str(LEARN_LR), *flags]
            reset_counts()
            results = in_loop_train.main(argv)
            counts = read_counts()
            trainer = results.pop("trainer")
            steps = trainer.optimizer.step_count
            if (trainer.model.languageEncoders.remat != "dots"
                    or counts["A1"] != steps or counts["K2"] != 24 * steps
                    or counts["K1"] < 48 * steps
                    or counts["R1"] != counts["K1"] or counts["K3"]):
                fail(f"in_loop_train {flags}: {steps} steps launched "
                     f"{counts}")
        label = " ".join(flags)
        res[f"cli {label}"] = {"steps": steps, "launches": counts,
                               "history": results["history"]}
        print(f"cli.in_loop_train {label}: {steps} steps, launches "
              f"{counts}", flush=True)
        del trainer, results
        torch.cuda.empty_cache()


def run_levers(record) -> dict:
    """Phase 10: int8 serving, the exported forward, remat and scan_layers
    at the flagship's width."""
    res = {}
    t0 = time.perf_counter()
    shapes = serve_int8(res)
    check_int8_products(shapes, res)
    serve_paper_int8(res)
    export_flagship(res)
    export_long(res)
    remat_steps(res)
    remat_through_cli(res)
    res["wall_s"] = time.perf_counter() - t0
    print(f"phase levers: {res['wall_s']:.1f} s", flush=True)
    record["levers"] = res
    return res


# ---- phase 7: timing ---------------------------------------------------

def attention_cost(c, backward: bool = False) -> tuple:
    """(bytes, flops) the launch must move and compute. Forward: q, k, v
    read, o written, QK^T and P@V. Backward: q, k, v, dO read, dq, dk, dv
    written, and five products (S, dP, dV, dQ, dK). Tables and mask read
    once; products over the causal triangle (s(s+1)/2 pairs) or the full
    square."""
    q = c["q"]
    bh = q.shape[0] * q.shape[1]
    s, d = c["s"], q.shape[-1]
    nbytes = (7 if backward else 4) * q.numel() * q.element_size()
    nbytes += sum(t.numel() * 4 for t in c["tables"])
    if c["mask"] is not None:
        nbytes += c["mask"].numel() * 4
    pairs = s * (s + 1) // 2 if c["causal"] else s * s
    return nbytes, (5 if backward else 2) * 2 * bh * pairs * d


def run_library_bwd(c):
    """Yardstick only: a closure running the backward of the rotation in
    PyTorch plus scaled_dot_product_attention, from a recorded forward."""
    leaves = [c[n].detach().requires_grad_(True) for n in ("q", "k", "v")]
    out = run_library(dict(c, q=leaves[0], k=leaves[1], v=leaves[2]))
    return lambda: torch.autograd.grad(out, leaves, c["do"],
                                       retain_graph=True)


def kernel_row(name, source, replaces, launches, err, ms, plain_ms,
               library_ms, nbytes, flops, peak_flops, **extra):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms, "bytes": nbytes, "flops": flops,
            **extra}


def time_kernels(record, errors, launches_by_shape, bwd_errors,
                 train_counts, a1_err, n_params, paper, pretrain):
    """The resident rows (R1 + K1, K2, R1) at the flagship's two shapes, at
    the paper generation's s=128 and at the pretrainers' BH=128 shapes, each
    with its own path's launches (the pretrainers' forwards are those of
    their steps), then A1 at each path's parameter count."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = []
    flagship = {shape_key(*k): n for k, n in launches_by_shape.items()}
    mlm, mim = pretrain["mlm"]["train"], pretrain["mim"]["train"]
    for case, kind, label, fwd_by_shape, steps in (
            ("text", "text", "s512 causal xPos", flagship, train_counts),
            ("vision", "vision", "s196 pixel rotary", flagship,
             train_counts),
            ("text_s128", "text", "s128 causal xPos",
             paper["serve_by_shape"], paper["train"]),
            ("text_s128_bh128", "text", "s128 causal xPos BH128",
             mlm["K1_by_shape"], mlm),
            ("vision_bh128", "vision", "s196 pixel rotary BH128",
             mim["K1_by_shape"], mim)):
        s, bh = {name: (s, bh) for name, _, s, bh in RESIDENT_CASES}[case]
        c = backward_case(kind, torch.bfloat16, gen, s=s, bh=bh)
        key = (c["s"], c["causal"])
        nbytes, flops = attention_cost(c)
        with_r1 = event_ms(lambda: run_kernel(c), iters=20)
        rotate_case(c)
        k1_ms = event_ms(lambda: run_k1(c), iters=20)
        library_ms = event_ms(lambda: run_library(c), iters=20)
        print(f"resident forward at {label}: R1 + K1 {with_r1:.4f} ms "
              f"(K1 alone {k1_ms:.4f} ms) against rotation + SDPA's "
              f"{library_ms:.4f} ms ({with_r1 / library_ms:.2f}x)",
              flush=True)
        rows.append(kernel_row(
            f"flash_fwd[{label}]", "meant_tpu_torch/csrc/flash_fwd.cu",
            "meant_tpu/ops/flash/kernel.py:89",
            fwd_by_shape.get(shape_key(*key), 0),
            errors[f"{case}/bfloat16"],
            with_r1, event_ms(lambda: run_plain(c), iters=5), library_ms,
            nbytes, flops, PEAK_BF16_FLOPS, shape=list(c["q"].shape),
            dtype="bfloat16", k1_alone_ms=k1_ms,
            library_call="rotation + scaled_dot_product_attention"))
        nbytes, flops = attention_cost(c, backward=True)
        library = run_library_bwd(c)
        library_ms = event_ms(library, iters=10)
        rotate_case(c)
        k2_ms = event_ms(lambda: run_bwd_k2(c), iters=10)
        with_r1 = event_ms(lambda: run_bwd_kernel(c), iters=10)
        rows.append(kernel_row(
            f"flash_bwd[{label}]", "meant_tpu_torch/csrc/flash_bwd.cu",
            "meant_tpu/ops/flash/kernel.py:321",
            steps["K2_by_shape"].get(shape_key(*key), 0),
            bwd_errors[f"{case}/bfloat16"], k2_ms,
            event_ms(lambda: run_bwd_plain(c), iters=3), library_ms, nbytes,
            flops, PEAK_BF16_FLOPS, shape=list(c["q"].shape),
            dtype="bfloat16", r1_plus_k2_ms=with_r1))
        print(f"resident backward at {label}: K2 {k2_ms:.4f} ms, R1 + K2 "
              f"{with_r1:.4f} ms against the SDPA backward's "
              f"{library_ms:.4f} ms ({with_r1 / library_ms:.2f}x)",
              flush=True)
        nbytes, flops = rotation_cost(c)
        r1_ms = event_ms(lambda: rotate_case(c), iters=20)
        print(f"rotation pass at {label}: R1 {r1_ms:.4f} ms", flush=True)
        rows.append(kernel_row(
            f"rotate_qk[{label}]",
            "meant_tpu_torch/csrc/flash_bwd_online.cu",
            "meant_tpu/ops/flash/kernel.py:340",
            steps["R1_by_shape"].get(f"s{c['s']}", 0),
            bwd_errors[f"{case}/bfloat16/rot"], r1_ms,
            event_ms(lambda: rotate_plain(c), iters=5), None, nbytes, flops,
            PEAK_FP32_FLOPS, shape=list(c["q"].shape), dtype="bfloat16",
            library_call=None))
        del c, library
        torch.cuda.empty_cache()

    rows.append(adamw_row("adamw", n_params, train_counts["A1"], a1_err,
                          gen))
    rows.append(adamw_row("adamw[meant]", paper["n_params"],
                          paper["train"]["A1"], paper["a1_err"], gen))
    for kind, counts in (("mlm", mlm), ("mim", mim)):
        rows.append(adamw_row(f"adamw[{kind}]", pretrain[kind]["n_params"],
                              counts["A1"], pretrain[kind]["a1_err"], gen))
    record["kernels"] = rows
    return rows


def adamw_row(name, n_params, launches, err, gen):
    """A1 over n_params: its ms, its plain version's and
    torch.optim.AdamW(fused=True)'s."""
    from meant_tpu_torch.ops.adamw import (adamw_reference, update_scalars,
                                           adamw_update)
    p, g, m, v = adamw_case(n_params, gen)
    norm = torch.linalg.vector_norm(g)
    h = update_scalars(coupled=False, **{k: v_ for k, v_ in
                                         ADAMW_ARGS.items()
                                         if k != "max_norm"})
    ms = event_ms(lambda: adamw_update(p, g, m, v, norm=norm, coupled=False,
                                       **ADAMW_ARGS), iters=20)
    plain_ms = event_ms(lambda: adamw_reference(p, g, m, v, h, norm, 1.0),
                        iters=5)
    param = torch.nn.Parameter(p)
    param.grad = g
    library = torch.optim.AdamW([param], lr=ADAMW_ARGS["lr"],
                                weight_decay=ADAMW_ARGS["weight_decay"],
                                fused=True)
    library_ms = event_ms(library.step, iters=20)
    row = kernel_row(
        name, "meant_tpu_torch/csrc/adamw.cu",
        "scripts/probe_fused_adamw.py:59", launches, err, ms, plain_ms,
        library_ms, 28 * n_params, 20 * n_params, PEAK_FP32_FLOPS,
        params=n_params, dtype="float32")
    del p, g, m, v, param, library
    torch.cuda.empty_cache()
    return row


def long_cost(c, kernel: str) -> tuple:
    """(bytes, flops) a streaming launch must move and compute, each input
    read once and each output written once: K3 reads qr, kr, v and writes o
    and lse (its tables are on R1's row); K4 reads qr, kr, v, dO, lse,
    delta and the q tables (the adjoint's) and writes dq; K5 reads the same
    and writes dk, dv; the tables counted as four. Products over the
    causal triangle: 2 (K3: S, PV), 3 (K4: S, dP, dS Kr), 4 (K5: S, dP,
    P^T dO, dS^T Qr)."""
    q = c["q"]
    bh, s, d = q.shape[0] * q.shape[1], c["s"], q.shape[-1]
    tensors = {"K3": 4, "K4": 5, "K5": 6}[kernel]
    rows = {"K3": 1, "K4": 2, "K5": 2}[kernel]
    tables = 0 if kernel == "K3" else sum(t.numel() * 4 for t in c["tables"])
    nbytes = tensors * q.numel() * q.element_size() + rows * bh * s * 4
    nbytes += tables
    pairs = s * (s + 1) // 2 if c["causal"] else s * s
    products = {"K3": 2, "K4": 3, "K5": 4}[kernel]
    return nbytes, products * 2 * bh * pairs * d


def rotation_cost(c) -> tuple:
    """(bytes, flops) of R1: q and k read, qr and kr written, the four
    tables read once; three fp32 operations an element."""
    q = c["q"]
    nbytes = (4 * q.numel() * q.element_size()
              + sum(t.numel() * 4 for t in c["tables"]))
    return nbytes, 2 * 3 * q.numel()


def plain_ms_fitting(fn, big, small, iters: int):
    """The plain version's ms per call at the main path's BH where its
    (BH, s, s) fp32 matrices fit on the card, else at LONG_CHECK_BH;
    returns (ms, BH timed)."""
    try:
        return event_ms(lambda: fn(big), iters=iters, warmup=1), (
            big["q"].shape[0] * big["q"].shape[1])
    except torch.cuda.OutOfMemoryError:
        torch.cuda.empty_cache()
        return event_ms(lambda: fn(small), iters=iters, warmup=1), (
            small["q"].shape[0] * small["q"].shape[1])


def time_long_kernels(long_errors, long_counts):
    """R1 + K3, R1, K4 and K5 at the main path's launch (BH=80, s=4096,
    bf16, causal xPos): ms per launch, bound, plain version, and the
    yardstick: rotation + causal SDPA (R1 + K3 together; K3 alone beside
    it), its backward (R1, K4 and K5 together); R1 has no single PyTorch
    call of its own."""
    gen = torch.Generator(device="cuda").manual_seed(9)
    big = long_case("text", torch.bfloat16, gen, LONG_TIME_BH)
    small = long_case("text", torch.bfloat16, gen, LONG_CHECK_BH)
    rotate_case(big)
    shape, rows = list(big["q"].shape), []
    library_fwd = event_ms(lambda: run_library(big), iters=10)
    library = run_library_bwd(big)
    library_bwd = event_ms(library, iters=5)
    del library
    torch.cuda.empty_cache()
    plans = (
        ("K3", "flash_fwd_online", "meant_tpu_torch/csrc/flash_fwd.cu",
         "meant_tpu/ops/flash/kernel.py:127", run_online_kernel,
         run_online_plain, "long_text/bfloat16/out", library_fwd, 10),
        ("K4", "flash_bwd_dq", "meant_tpu_torch/csrc/flash_bwd_online.cu",
         "meant_tpu/ops/flash/kernel.py:456", run_online_dq_kernel,
         run_online_dq_plain, "long_text/bfloat16/dq", library_bwd, 5),
        ("K5", "flash_bwd_dkdv", "meant_tpu_torch/csrc/flash_bwd_online.cu",
         "meant_tpu/ops/flash/kernel.py:527", run_online_dkdv_kernel,
         run_online_dkdv_plain, ("long_text/bfloat16/dk",
                                 "long_text/bfloat16/dv"), library_bwd, 5))
    for (kernel, name, source, replaces, run, plain, err_keys, library_ms,
         iters) in plans:
        ms = event_ms(lambda: run(big), iters=iters)
        extra = {}
        if kernel == "K3":     # the row is R1 + K3; K3 alone beside it
            extra["k3_alone_ms"] = event_ms(lambda: run_online_k3(big),
                                            iters=iters)
            print(f"streaming forward at src4096's launch: R1 + K3 "
                  f"{ms:.4f} ms (K3 alone {extra['k3_alone_ms']:.4f} ms) "
                  f"against rotation + causal SDPA's {library_ms:.4f} ms "
                  f"({ms / library_ms:.2f}x)", flush=True)
        plain_ms, plain_bh = plain_ms_fitting(plain, big, small, iters=2)
        torch.cuda.empty_cache()
        keys = err_keys if isinstance(err_keys, tuple) else (err_keys,)
        nbytes, flops = long_cost(big, kernel)
        rows.append(kernel_row(
            f"{name}[s4096 causal xPos]", source, replaces,
            long_counts[kernel], max(long_errors[k] for k in keys), ms,
            plain_ms, library_ms, nbytes, flops, PEAK_BF16_FLOPS,
            shape=shape, dtype="bfloat16", plain_bh=plain_bh, **extra,
            library_call=("rotation + scaled_dot_product_attention"
                          if kernel == "K3" else
                          "backward of rotation + scaled_dot_product_"
                          "attention (dq, dk, dv: K4 and K5 together)")))
    nbytes, flops = rotation_cost(big)
    rows.insert(1, kernel_row(
        "rotate_qk[s4096 causal xPos]",
        "meant_tpu_torch/csrc/flash_bwd_online.cu",
        "meant_tpu/ops/flash/kernel.py:152", long_counts["R1"],
        long_errors["long_text/bfloat16/rot"],
        event_ms(lambda: rotate_case(big), iters=20),
        event_ms(lambda: rotate_plain(big), iters=5), None, nbytes, flops,
        PEAK_FP32_FLOPS, shape=shape, dtype="bfloat16",
        library_call=None))
    backward = sum(r["ms"] for r in rows[1:4])
    print(f"streaming backward at src4096's launch: R1 + K4 + K5 "
          f"{backward:.4f} ms against the SDPA backward's "
          f"{library_bwd:.4f} ms ({backward / library_bwd:.2f}x)",
          flush=True)
    del big, small
    torch.cuda.empty_cache()
    return rows


def time_requests(predictor, chunk, record, iters: int = 7,
                  label: str = "flagship"):
    predictor(chunk)
    times = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        predictor(chunk)            # ends in a device-to-host copy
        times.append((time.perf_counter() - t0) * 1e3)
    fwd_ms = event_ms(lambda: predictor.forward(chunk), iters=5)
    record.update(request_ms=times, request_ms_median=statistics.median(
        times), forward_device_ms=fwd_ms, rows_per_request=BATCH)
    print(f"{label} request (16 rows, host clock incl. copies) median "
          f"{statistics.median(times):.3f} ms over {iters}: "
          f"{[round(t, 3) for t in times]}; forward alone (device events) "
          f"{fwd_ms:.3f} ms", flush=True)


# ---- phase 8: where a request's device time goes -----------------------

def _kind(name: str) -> str:
    low = name.lower()
    if "rotate_qk" in low:
        return "rotate_qk (R1)"
    if "flash_fwd_lse" in low:
        return "flash_fwd_lse (K3)"
    # the wgmma bodies are K4/K5 at <false>, K2 at <true> (kStats)
    if "flash_bwd" in low and ("online" in low or "<false>" in low):
        return ("flash_bwd dq (K4)" if "_dq_" in low
                else "flash_bwd dkdv (K5)")
    if "flash_fwd" in low:
        return "flash_fwd (K1)"
    if "flash_bwd" in low:
        return "flash_bwd (K2)"
    if "adamw_kernel" in low:
        return "adamw (A1)"
    if any(t in low for t in ("gemm", "xmma", "cutlass", "sm90", "cublas",
                              "nvjet")):
        return "matrix products"
    return "other (elementwise, norms, copies, reductions)"


def profile_calls(fn, count: int, unit: str, rows: int = BATCH) -> dict:
    """Device time per call of fn by kernel and kind, from torch.profiler's
    device-side events (kernels, copies; the host-side ops above them
    would count the same time again), and the device's idle share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(count):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / count
    kernels = sorted(
        ((e.key, e.self_device_time_total / 1e3 / count, e.count // count)
         for e in prof.key_averages()
         if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
        key=lambda r: -r[1])
    if not kernels:
        fail("the profiler recorded no device time")
    busy = sum(ms for _, ms, _ in kernels)
    launches = sum(n for _, _, n in kernels)
    by_kind = {}
    for name, ms, _ in kernels:
        by_kind[_kind(name)] = by_kind.get(_kind(name), 0.0) + ms
    idle = max(0.0, 1.0 - busy / wall_ms)
    print(f"profile, per {unit} of {rows} rows: wall {wall_ms:.3f} ms, "
          f"device busy {busy:.3f} ms in {launches} kernels and copies, "
          f"idle share {idle:.3f}", flush=True)
    for kind, ms in sorted(by_kind.items(), key=lambda kv: -kv[1]):
        print(f"  {kind}: {ms:.3f} ms ({ms / busy:.1%})")
    for name, ms, n in kernels[:12]:
        print(f"  {ms:9.3f} ms x{n:<5} {name[:100]}")
    return {f"{unit}s": count, "rows": rows,
            f"device_ops_per_{unit}": launches,
            f"wall_ms_per_{unit}": wall_ms,
            f"device_busy_ms_per_{unit}": busy, "device_idle_share": idle,
            f"by_kind_ms_per_{unit}": by_kind,
            "top_kernels": [{"name": k[:120], f"ms_per_{unit}": ms,
                             "calls": n} for k, ms, n in kernels[:25]]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="directory for chip_smoke.json (full record)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    from meant_tpu_torch.cuda_build import build_all

    t_start = time.perf_counter()
    card = card_line()
    record = {"card": card, "device": torch.cuda.get_device_name(0),
              "torch": torch.__version__, "cuda": torch.version.cuda}
    print(f"card: {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    logs = build_all(KERNELS)
    record["build_s"] = time.perf_counter() - t0
    record["nvcc_log"] = logs
    print(f"phase build: {record['build_s']:.1f} s", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    record["hgmma"] = {name: count_hgmma(name) for name in WGMMA_LIBRARIES}
    record["hgmma"]["K1"] = count_hgmma("flash_fwd", "flash_fwd_wgmma_kernel")

    errors = check_kernel(record)
    bwd_errors = check_backward(record)
    long_errors = check_long_kernels(record)
    predictor, chunk, by_shape = run_slice(record)
    a1_err = check_adamw(record, record["n_params"])
    train_counts = run_training(record)
    long_counts = run_long(record)
    paper = run_paper(record)
    pretrain = run_pretrain(record)
    run_levers(record)
    rows = time_kernels(record, errors, by_shape, bwd_errors, train_counts,
                        a1_err, record["n_params"], paper, pretrain)
    at = [r["name"] for r in rows].index("adamw")
    rows[at:at] = time_long_kernels(long_errors, long_counts)  # before A1
    time_requests(predictor, chunk, record)
    record["profile"] = profile_calls(lambda: predictor.forward(chunk),
                                      PROFILE_FORWARDS, "forward")
    for r in rows:
        library = ("none" if r["library_ms"] is None
                   else f"{r['library_ms']:.4f} ms")
        print(f"{r['name']}: {r['ms']:.4f} ms/launch (bound "
              f"{r['bound_ms']:.4f} ms by {r['bound_by']}, plain "
              f"{r['plain_ms']:.4f} ms, library yardstick {library}) on "
              f"{card}", flush=True)
    record["wall_s"] = time.perf_counter() - t_start
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
            json.dump(record, f, indent=1, default=str)
    print(f"wall {record['wall_s']:.1f} s", flush=True)
    print(card)
    print(json.dumps({"kernels": [
        {k: r[k] for k in ("name", "route", "source", "replaces",
                           "launches", "max_abs_err", "ms", "plain_ms",
                           "bound_ms", "bound_by", "library_ms")}
        for r in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
