#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (meant_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--out DIR]

Phases, run in the order 1-6, 9, 10, 11, 12, 13, 7, 8; any failure
raises and the script exits non-zero:

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
              the pretrainers' BH=128 (s=128 causal xPos, s=196), and at
              meant_mosi's s=50 with xPos on 30 features (a partial 64-row
              tile, an identity tail of 66) at BH=128, with and without a
              padded key mask.
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
11. zoo    -- the rest of the CLI's model zoo at its widths (768, 8
              heads, 12 text encoders, 224^2 charts, lag 5, batch 16):
              meant_timesformer (s=512, TimeSformer depth 1) serves one
              request through Predictor with exactly 12 R1 + 12 K1, towers
              and probabilities against flash=False, the first encoder's
              attention on the model's own activations at K1's bar, a
              profiled forward, int8 serving (the same launches, JAX's bars
              against bf16), 3 trainer steps with exactly 12 K1, 12 R1, 12
              K2 and 1 A1 a step, peak memory and a profiled step;
              meant_mean_pooling (s=512), meant_tweet_price (--flash true,
              s=128; towers against flash=False) and meant_mosi (built
              with flash=True, s=50, xPos on 30 features, a TimeSformer of
              depth 12 over 50 frames of 20 features; towers against
              flash=False) one request and 2 steps each with the same
              counts; MOSI's encoder with mask_in_flash=True and a padded
              mask against flash=False (forward, input and parameter
              gradients; 1 R1 + 1 K1 + 1 K2); cli.in_loop_train for
              meant_price, mlp, lstm and teanet (synthetic sets) and teanet
              --data_dir on TempStock-small files, each with no flash launch
              and one A1 a step; A1 at meant_timesformer's parameter count
              (the TimeSformer's flash groups of 256+ keys: phase 12).
12. shapes -- the head dims and lengths beside the flagship's one length
              at d=96, and the trainer's extras: wgmma (HGMMA) in every
              instantiation at d=64 and 128 (K1, K3, K2's two kernels, K4
              + K5); R1 + K1 and K2 through flash_mha in fp32 and bf16 at
              the bars in force against their plain versions at d=64
              (BH=960, s=512 causal xPos and s=196 pixel rotary), d=128
              (BH=480, s=512), d=48 padded to 64 (BH=64, s=128) and the
              TimeSformer group (BH=640, 256 queries, 257 keys, d=64, no
              tables, no mask; the element bars' absolute parts in units
              of the reference's RMS there); R1 + K3, R1, K4 and K5 at
              d=128, BH=60, s=4096; `build_model(-mn meant_src
              --num_heads 12)` serves 40 rows (24 R1 + 24 K1 a request)
              against flash=False, one step's gradients against the plain
              attention, 5 trainer steps (24 R1, 24 K1, 24 K2, 1 A1 a
              step, falling loss); --num_heads 6: a request and 2 steps;
              `-mn meant_timesformer --image_size 256 --flash true`: a
              request (12 + 1 R1 and K1: the text encoders and the space
              group) against flash=False and 2 steps; src4096 at 6 heads
              and 2 encoders: a request (2 K3, 2 K1, 4 R1) and 2 steps; A1
              with a bf16 first moment against its plain version over
              177.6M parameters, the flagship 3 steps with an fp32 and 10
              with a bf16 first moment (peak memory side by side); batch 8
              with accumulation_steps=2: the accumulated gradient against
              batch 16's (5e-2 relative L2 per group) and 10 micro-steps
              with exactly 5 A1 launches; and, as a reading held to no
              bar, the gathered MLM head against the full one in fp32.
13. hf_vqa -- meant_vqa at bench.py's VQA geometry (768 wide, 12 + 12
              encoders, s=40 questions, 4x224^2 charts, batch 64, 3130
              answers, soft targets with a second annotator at 1/3, bf16,
              flash on as the VQA CLI runs it): one step's gradients
              against the plain attention, 3 vqa_trainer steps on one
              replayed batch with exactly 24 R1, 24 K1 (12 at s=40, 12 at
              s=196), 24 K2 and 1 A1 a step and a finite, falling loss, a
              profiled step, and the flash=False step (bench.py's setting)
              timed and profiled only; cli.vqa one epoch at -tb 16 on its
              synthetic set (s=24) and on a vqa_prepared.npz written here
              (s=40), each with its launches by shape and a checkpoint;
              bertweet, vl_bert and vilt (vilt at --seq_len 40, the others
              at 128) at the CLI's widths: 3 trainer steps on the CLI's
              synthetic batch (1 A1 a step, no flash kernel), a profiled
              step, cli.in_loop_train on a TempStock-small directory
              written here (3 steps, 1 A1 each, no flash kernel) and
              Predictor(checkpoint_path=...) serving the trained
              probabilities; cli.tweet_eval (bertweet, s=128, batch 16, 2
              epochs) with its mean step latency; A1 against its plain
              version at each of the four new parameter counts.
7. timing  -- median request time, and each kernel's time per launch
              beside its bound, its plain version's time and one PyTorch
              call that computes the same (a yardstick the port never
              calls): rotation + scaled_dot_product_attention (R1 + K1,
              K1 alone beside it, at s=512, 196 and 128; R1 + K3, causal
              at s=4096; at BH=128 for the pretrainers; at s=128 with
              meant_tweet_price's launches; at s=50 with xPos on 30
              features, BH=128, with meant_mosi's) and its backward
              (R1 + K2; R1, K4 and K5 together),
              torch.optim.AdamW(fused=True) (A1, at the flagship's,
              meant's, the pretrainers', meant_timesformer's and phase
              13's parameter counts; phase 12's shapes, and A1 with a bf16
              first moment); R1 + K1 and K2 also at meant_vqa's s=40 and
              s=196 (BH=512) and the VQA CLI's s=24;
              R1 has rows of its own at each shape. Beside the event time
              of the resident rows, their device time with the host out of
              the way (at s=128 a call launches less work than the host
              takes to issue it).
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

def attention_case(kind: str, dtype, gen, s=None, bh=BATCH * LAG * HEADS,
                   d=HEAD_DIM, s_k=None, heads=HEADS):
    """Inputs of one attention launch, at the flagship's shapes unless s,
    bh, the head dim d, the key length s_k and heads say otherwise: (bh /
    heads, heads, s | s_k, d) q/k/v, tables, mask. Kind "group" is a
    TimeSformer group (nn/timesformer.py): q scaled by d^-0.5 beforehand,
    scale 1, no tables (the identity), no mask, not causal."""
    from meant_tpu_torch.ops import lang_freqs, pixel_freqs
    from meant_tpu_torch.ops.flash.flash_attention import _tables
    from meant_tpu_torch.ops.flash.kernel import identity_tables

    if s is None:
        s = N_PATCHES if kind == "vision" else SEQ
    s_k = s if s_k is None else s_k
    q, k, v = (torch.randn((bh // heads, heads, n, d), generator=gen,
                           device="cuda") * 2.0 for n in (s, s_k, s_k))
    if kind == "group":
        q = q * d ** -0.5
    q, k, v = (t.to(dtype) for t in (q, k, v))
    scale = 1.0 / DIM ** 0.5       # 1/sqrt(dim) in both towers
    if kind == "group":
        tables = (*identity_tables(s, d, "cuda"),
                  *identity_tables(s_k, d, "cuda"))
        return dict(q=q, k=k, v=v, tables=tables, mask=None, scale=1.0,
                    causal=False, s=s, s_k=s_k)
    if kind == "vision":
        freqs, xpos, causal = pixel_freqs(d // 2, device="cuda"), False, False
    else:
        rot = 30 if kind.startswith("text_rot30") else d // 2
        freqs, xpos, causal = lang_freqs(rot, device="cuda"), True, True
    tables = _tables(s, d, freqs, xpos, 512.0)
    mask = None
    if kind.endswith("masked"):
        lengths = torch.randint(1, s + 1, (bh // heads,), generator=gen,
                                device="cuda")
        mask = (torch.arange(s, device="cuda")[None, :]
                < lengths[:, None]).to(torch.float32)
    return dict(q=q, k=k, v=v, tables=tables, mask=mask, scale=scale,
                causal=causal, s=s, s_k=s)


def flat(t):
    """(b, h, s, d) as the kernels' (b*h, s, d)."""
    return t.reshape(t.shape[0] * t.shape[1], *t.shape[2:])


def run_kernel(c):
    from meant_tpu_torch.ops.flash import flash_mha
    qcos, qsin, kcos, ksin = c["tables"]
    return flash_mha(c["q"], c["k"], c["v"], scale=c["scale"],
                     causal=c["causal"], attention_mask=c["mask"], qcos=qcos,
                     qsin=qsin, kcos=kcos, ksin=ksin)


def run_k1(c):
    """K1 alone on c's qr and kr (rotate_case); out as (b, h, s, d)."""
    from meant_tpu_torch.ops.flash import flash_fwd
    out = flash_fwd(c["qr"], c["kr"], flat(c["v"]), c["mask"],
                    scale=c["scale"], causal=c["causal"],
                    num_heads=c["q"].shape[1])
    return out.reshape(c["q"].shape)


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
# s=128 text and s=196 charts at BH = 16 x 8 = 128 (no lag in the batch),
# then meant_mosi's text: s=50 (inside one 64-row tile) with xPos on 30
# features, BH = 16 x 8 = 128, also with a padded key mask, then
# meant_vqa's s=40 text and s=196 charts at BH = 512 and the VQA CLI's
# s=24 text at BH = 128.
MAIN_BH = BATCH * LAG * HEADS
PRETRAIN_BH = BATCH * HEADS
MOSI_SEQ, MOSI_BH = 50, BATCH * HEADS
# meant_vqa at bench.py's VQA geometry: s=40 questions and s=196 charts at
# BH = 64 x 8 = 512, no lag; the VQA CLI's synthetic 24-token questions at
# -tb 16, BH = 128. Both lengths are below one 64-row tile.
VQA_SEQ, VQA_BATCH = 40, 64
VQA_BH = VQA_BATCH * HEADS
VQA_CLI_SEQ = 24
RESIDENT_CASES = (("text", "text", SEQ, MAIN_BH),
                  ("vision", "vision", N_PATCHES, MAIN_BH),
                  ("text_masked", "text_masked", SEQ, MAIN_BH),
                  ("text_s128", "text", PAPER_SEQ, MAIN_BH),
                  ("text_s128_bh128", "text", PAPER_SEQ, PRETRAIN_BH),
                  ("vision_bh128", "vision", N_PATCHES, PRETRAIN_BH),
                  ("text_s50_rot30", "text_rot30", MOSI_SEQ, MOSI_BH),
                  ("text_s50_rot30_masked", "text_rot30_masked", MOSI_SEQ,
                   MOSI_BH),
                  ("text_s40_bh512", "text", VQA_SEQ, VQA_BH),
                  ("vision_bh512", "vision", N_PATCHES, VQA_BH),
                  ("text_s24_bh128", "text", VQA_CLI_SEQ, PRETRAIN_BH))


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
    grads = flash_bwd(c["qr"], c["kr"], flat(c["v"]), flat(c["do"]),
                      c["mask"], *c["tables"], scale=c["scale"],
                      causal=c["causal"], num_heads=c["q"].shape[1])
    return [g.reshape(c[n].shape) for g, n in zip(grads, "qkv")]


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
    out, lse = flash_fwd_online(c["qr"], c["kr"], flat(c["v"]), c["mask"],
                                scale=c["scale"], causal=c["causal"],
                                num_heads=c["q"].shape[1])
    return out.reshape(c["q"].shape), lse.reshape(c["q"].shape[:3])


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
    c["qr"], c["kr"] = rotate_qk(flat(c["q"]), flat(c["k"]), *c["tables"])
    return c["qr"], c["kr"]


def rotate_plain(c):
    from meant_tpu_torch.ops.flash.kernel import _rotate
    qcos, qsin, kcos, ksin = c["tables"]
    return (_rotate(flat(c["q"]), qcos, qsin),
            _rotate(flat(c["k"]), kcos, ksin))


def _online_bwd_args(c):
    """K4's and K5's arguments, q and k as R1 rotated them
    (rotate_case)."""
    return ([c["qr"], c["kr"], flat(c["v"]), flat(c["do"]),
             flat(c["lse"]).contiguous(), flat(c["delta"]).contiguous(),
             c["mask"], *c["tables"]])


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
    return [g.reshape(c["k"].shape) for g in grads]


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


def long_case(kind, dtype, gen, bh, **shape):
    """One text-tower launch of src4096 (s=4096, causal xPos) with dO;
    `text_masked` has a padding mask of a random length per batch row (at
    least one key). A batch row with every key masked is checked by
    tests/test_torch_cuda.py with the pixel rotary: under causal xPos at
    s=4096 its dq sums terms up to some 300 in size, where one bf16 step
    of a dS entry moves an element by 0.6 (PERF.md). lse and delta for the
    backward come from the plain forward and carry a non-zero lse
    cotangent: delta = rowsum(dO * out) - g_lse."""
    c = backward_case(kind, dtype, gen, s=LONG_SEQ, bh=bh, **shape)
    out, lse = run_online_plain(c)
    g_lse = torch.randn(lse.shape, generator=gen, device="cuda")
    c.update(out=out, lse=lse,
             delta=(c["do"].float() * out.float()).sum(-1) - g_lse)
    return c


def check_long_kernels(record, bh=LONG_CHECK_BH, kinds=("text",
                                                       "text_masked"),
                       tag="long", seed=4, **shape):
    """R1 + K3 (out and lse), R1, K4 and K5 against their plain versions
    at s=4096, BH=16, fp32 and bf16, without and with a padding mask (or at
    the BH, kinds and head dim given): out at BF16_REL_L2 (and, in bf16,
    at K3_TILED_REL_L2 against the plain version in K3's tiled order), the
    gradients at K2's bars, lse within LSE_ATOL, R1 bit for bit."""
    from meant_tpu_torch.ops.flash.kernel import (BF16_REL_L2, BWD_BF16_ATOL,
                                                  BWD_BF16_REL_L2,
                                                  K3_TILED_REL_L2, LSE_ATOL)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    errors, rels = {}, {}
    for kind in kinds:
        for dtype in (torch.float32, torch.bfloat16):
            c = long_case(kind, dtype, gen, bh, **shape)
            name = f"{tag}_{kind}/{str(dtype).split('.')[-1]}"
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
    record[f"{tag}_kernels_vs_plain_max_abs_err"] = errors
    record[f"{tag}_kernels_vs_plain_rel_l2"] = rels
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
    kw.setdefault("num_heads", HEADS)
    return meant_src(text_dim=DIM, image_dim=DIM, price_dim=5, height=IMAGE,
                     width=IMAGE, patch_res=PATCH, lag=LAG, num_classes=2,
                     embedding=EmbeddingConfig(), channels=3,
                     seq_len=max(SEQ, seq), dtype=torch.bfloat16,
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


def towers_and_probs(model, predictor, chunk, towers=None):
    """Probabilities and the towers' outputs of one request; `towers`
    names them (default: the language and vision encoders)."""
    got = {}
    towers = towers or {"text": model.languageEncoders,
                        "vision": model.visionEncoders}
    hooks = [module.register_forward_hook(
                 lambda m, i, o, name=name: got.__setitem__(name, o.float()))
             for name, module in towers.items()]
    try:
        got["probs"] = predictor.forward(chunk).float()
    finally:
        for h in hooks:
            h.remove()
    torch.cuda.synchronize()
    return got


def compare_slice(label, flash_out, plain_out, record):
    res = {}
    for name in (k for k in flash_out if k != "probs"):
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
                  launches_by_shape={launch_key(k): n
                                     for k, n in by_shape.items()})

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
    """Launch counts; K1's and K2's also by shape (`launch_key`), and
    R1's by (s_q, s_k, d), keyed "s<s>" at the flagship's head dim and one
    length, else "s<s_q>x<s_k> d<d>"."""
    counts = {name: w.launches for name, w in wrappers().items()}
    for name in ("K1", "K2"):
        counts[f"{name}_by_shape"] = {
            launch_key(k): n
            for k, n in wrappers()[name].launches_by_shape.items()}
    counts["R1_by_shape"] = {
        r1_key(*k): n for k, n in wrappers()["R1"].launches_by_shape.items()}
    return counts


def check_counts(counts: dict, want: dict, label: str):
    """Fail unless every kernel launched exactly as `want` says (0 for the
    kernels it does not name)."""
    full = {name: want.get(name, 0) for name in wrappers()}
    got = {name: counts[name] for name in full}
    if got != full:
        fail(f"{label} launched {got}, want {full}")


def shape_key(s: int, causal: bool, s_k=None, d: int = HEAD_DIM) -> str:
    """"s<s> causal=<c>" at the flagship's head dim and one length, else
    "s<s>x<s_k> d<d> causal=<c>" (d the kernel's, after padding)."""
    if (s_k is None or s_k == s) and d == HEAD_DIM:
        return f"s{s} causal={bool(causal)}"
    return f"s{s}x{s_k} d{d} causal={bool(causal)}"


def launch_key(key) -> str:
    """A flash wrapper's launch key (s_q, s_k, d, causal) as shape_key."""
    s, s_k, d, causal = key
    return shape_key(s, causal, s_k, d)


def r1_key(s: int, s_k: int, d: int) -> str:
    return f"s{s}" if s == s_k and d == HEAD_DIM else f"s{s}x{s_k} d{d}"


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


def make_trainer(model, host, model_name="meant_src", **extra):
    """meant_trainer on one replayed batch (numpy `host`) at LEARN_LR
    constant; `extra` adds trainer parameters (mu_dtype,
    accumulation_steps)."""
    from meant_tpu_torch.data.loader import ArrayLoader
    from meant_tpu_torch.train.classify import meant_trainer
    return meant_trainer({
        "model": model, "model_name": model_name,
        "train_loader": ArrayLoader(host, len(host["y"])),
        "lrst": "constant", "lr": LEARN_LR, "seed": 0, "test_model": False,
        **extra})


def train_steps(model, host, steps, per_step, label, model_name="meant_src",
                falling=True, want=None, **extra):
    """`steps` steps of meant_trainer on one replayed batch (numpy `host`)
    at LEARN_LR constant (`timed_steps`)."""
    return timed_steps(make_trainer(model, host, model_name, **extra), host,
                       steps, per_step, label, falling, want)


def timed_steps(trainer, host, steps, per_step, label, falling=True,
                want=None):
    """`steps` steps of `trainer` on one replayed batch (numpy `host`): a
    training main path, counts set to 0 just before and read just after,
    exactly `per_step` launches per step (or `want` in all) and a finite
    loss, falling unless `falling` is False (a step timed only). Returns the
    record, the trainer and the device batch."""
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
    if want is None:
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


def write_tempstock(path: str, n: int, seed: int, seq: int = PAPER_SEQ):
    """A TempStock-small set at full shape in its layout: graphs_5.npy (n,
    5, 4, 224, 224) fp32, tweets_5.npy (n, 5, seq) int64 (128 tokens a day
    unless `seq` says otherwise) with trailing pad id 1 where
    attention_masks_5.npy is 0, macds_5.npy (n, 5, 4) and
    y_resampled_5.npy (n,)."""
    import os
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, seq + 1, size=(n, LAG))
    masks = (np.arange(seq) < lengths[..., None]).astype(np.float32)
    tweets = np.where(masks > 0, rng.integers(2, 64000, (n, LAG, seq)), 1)
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


# ---- phase 11: the rest of the CLI's model zoo ----------------------------

ZOO_LAUNCHES = {"K1": ENCODERS, "R1": ENCODERS}         # a text tower forward
ZOO_STEP = {"K1": ENCODERS, "R1": ENCODERS, "K2": ENCODERS, "A1": 1}
ZOO_STEPS = 3
ZOO_CLI_ROWS = 64          # 38 / 13 / 13 rows after the 60/20/20 split
ZOO_DATA_ROWS = 48         # teanet's TempStock-small files


def zoo_args(name: str, *extra):
    """The CLI's arguments for -mn name at its default widths (768, 8 heads,
    12 encoders, 224^2 charts, lag 5)."""
    from meant_tpu_torch.cli.common import base_parser
    return base_parser().parse_args(["-rid", "smoke", "-mn", name, "-nec",
                                     str(ENCODERS)] + list(extra))


def build_zoo(name: str, *extra):
    from meant_tpu_torch.cli.common import build_model
    return build_model(zoo_args(name, *extra))


def build_mosi(flash: bool):
    """meant_mosi at the CLI's widths (12 text encoders, a TimeSformer of
    depth 12 over 50 frames of 20 features), with the flash kernels on or
    off: the JAX CLI never hands --flash to meant_mosi, so it is built
    directly."""
    from meant_tpu_torch import models
    return models.meant_mosi(DIM, DIM, lag=MOSI_SEQ, num_classes=2,
                             flash=flash, num_heads=HEADS,
                             num_encoders=ENCODERS, dtype=torch.bfloat16,
                             device="cuda", seed=0)


def zoo_batch(name: str, n: int, seed: int):
    """The CLI's synthetic batch of `name` (with labels y); s=512 tokens
    for the TimeSformer family, 128 for meant_tweet_price, MOSI's 50."""
    from meant_tpu_torch.cli.common import synthetic_batch
    seq = {"meant_tweet_price": PAPER_SEQ}.get(name, SEQ)
    return synthetic_batch(zoo_args(name, "--seq_len", str(seq)), n,
                           seed=seed)


def serve_zoo(name, model, host, want, res, towers=None, plain=None):
    """One BATCH-row request through Predictor: exactly `want` launches,
    finite probabilities in (0, 1); the request's times; with `plain` (the
    same model at flash=False) the towers and probabilities against it."""
    from meant_tpu_torch.serve import Predictor
    predictor = Predictor(model, name, batch_size=BATCH)
    rows = {k: v for k, v in host.items() if k != "y"}
    predictor(rows)         # warm-up
    torch.cuda.synchronize()
    reset_counts()
    probs = predictor(rows)
    torch.cuda.synchronize()
    counts = read_counts()
    print(f"served {name}: {BATCH} rows, probs {probs.shape}, launches "
          f"{counts}", flush=True)
    check_counts(counts, want, f"serving {name}")
    if (probs.shape != (BATCH, 2) or not np.isfinite(probs).all()
            or not ((probs > 0) & (probs < 1)).all()):
        fail(f"bad {name} probabilities {probs}")
    res["launches"] = counts
    time_requests(predictor, rows, res, label=name)
    if plain is not None:
        plain.load_state_dict(model.state_dict())
        compare_slice(name, towers_and_probs(model, predictor, rows,
                                             towers(model)),
                      towers_and_probs(plain, Predictor(plain, name,
                                                        batch_size=BATCH),
                                       rows, towers(plain)), res)
    return predictor, probs


def attention_vs_plain(attn, x, mask, label, res):
    """The first text encoder's attention on the model's own activations:
    R1 + K1 (flash_mha) against flash_mha_reference at K1's bar."""
    from meant_tpu_torch.ops import split_heads
    from meant_tpu_torch.ops.flash import flash_mha, flash_mha_reference
    from meant_tpu_torch.ops.flash.flash_attention import _tables
    from meant_tpu_torch.ops.flash.kernel import K1_BF16_REL_L2
    with torch.no_grad():
        q, k, v = (split_heads(p(x), attn.num_heads)
                   for p in (attn.q, attn.k, attn.v))
        tables = _tables(q.shape[2], q.shape[3], attn.freqs, True, 512.0)
        got = flash_mha(q, k, v, scale=attn.scale, causal=attn.causal,
                        attention_mask=mask, qcos=tables[0],
                        qsin=tables[1], kcos=tables[2], ksin=tables[3])
        want = flash_mha_reference(q, k, v, mask, *tables, scale=attn.scale,
                                   causal=attn.causal)
    rel = rel_l2(got, want)
    print(f"{label}: first encoder's attention, R1 + K1 vs plain on the "
          f"model's activations {tuple(q.shape)}: rel_l2 {rel:.3e} (bar "
          f"{K1_BF16_REL_L2})", flush=True)
    if not (rel <= K1_BF16_REL_L2 and torch.isfinite(got).all()):
        fail(f"{label}: R1 + K1 on the model's activations is off its "
             f"plain version (relative L2 {rel})")
    res["first_attention_rel_l2"] = rel


def first_attention_input(model, name, host):
    """The first text encoder's attention, and its input and mask in one
    eval forward of `host`'s rows."""
    from meant_tpu_torch.train.classify import model_inputs
    got = {}
    attn = model.languageEncoders[0].attn
    hook = attn.register_forward_pre_hook(
        lambda m, a: got.update(x=a[0], mask=a[1] if len(a) > 1 else None))
    model.eval()
    try:
        with torch.no_grad():
            args, kwargs = model_inputs(name, to_card(
                {k: v for k, v in host.items() if k != "y"}))
            model(*args, **kwargs)
    finally:
        hook.remove()
    return attn, got["x"], got["mask"]


def zoo_timesformer(res):
    """meant_timesformer at the CLI's widths, s=512, b=16: one request
    (12 R1 + 12 K1) against flash=False, the first attention at K1's bar,
    int8 serving, ZOO_STEPS trainer steps (12 K1, 12 R1, 12 K2, 1 A1 a step)
    with peak memory and a profiled step."""
    from meant_tpu_torch.serve import Predictor
    name = "meant_timesformer"
    model = build_zoo(name, "--seq_len", str(SEQ), "--flash", "true")
    res["n_params"] = sum(p.numel() for p in model.parameters())
    host = zoo_batch(name, BATCH, seed=30)
    towers = lambda m: {"text": m.languageEncoders, "vision": m.timesformer}
    predictor, probs = serve_zoo(
        name, model, host, ZOO_LAUNCHES, res, towers,
        plain=build_zoo(name, "--seq_len", str(SEQ), "--flash", "false"))
    torch.cuda.empty_cache()
    attention_vs_plain(*first_attention_input(model, name, host), name,
                       res)
    res["forward_profile"] = profile_calls(
        lambda: predictor.forward({k: v for k, v in host.items()
                                   if k != "y"}), PROFILE_FORWARDS,
        "forward")
    # int8 serving of the same weights: the same launches, JAX's bars
    rows = {k: v for k, v in host.items() if k != "y"}
    int8 = Predictor(model, name, batch_size=BATCH, quantize="int8")
    int8(rows)
    reset_counts()
    reset_int8_counts()
    q = int8(rows)
    torch.cuda.synchronize()
    counts, products = read_counts(), int8_counts()
    check_counts(counts, ZOO_LAUNCHES, f"serving {name} in int8")
    err = float(np.abs(q - probs).max())
    agree = float((q.argmax(-1) == probs.argmax(-1)).mean())
    res["int8"] = {"probs_max_abs_err": err, "argmax_agreement": agree,
                   "int8_products": sum(products.values()),
                   "int8_shapes": len(products)}
    print(f"{name} int8 vs bf16: max |dprob| {err:.4e} (bar "
          f"{INT8_PROBS_ATOL}), argmax agreement {agree:.3f} (bar "
          f"{INT8_ARGMAX}); {sum(products.values())} int8 products",
          flush=True)
    if not (products and np.isfinite(q).all() and err <= INT8_PROBS_ATOL
            and agree >= INT8_ARGMAX):
        fail(f"{name} int8 serving is outside JAX's bars against bf16")
    del predictor, int8
    train, trainer, batch = train_steps(
        model, host, ZOO_STEPS, ZOO_STEP, f"learn {name}", model_name=name,
        falling=False)
    res["train"] = train
    res["train_profile"] = profile_calls(
        lambda: trainer.train_step(batch), 1, "step")
    del model, trainer, batch
    torch.cuda.empty_cache()
    return train["launches"]


def zoo_model(name, model, host, res, plain=None, towers=None):
    """One request and ZOO_STEPS - 1 steps (the first one untimed) of a
    kernel-bearing zoo model: 12 R1 + 12 K1 a forward, 12 K1, 12 R1, 12 K2
    and 1 A1 a step."""
    res["n_params"] = sum(p.numel() for p in model.parameters())
    serve_zoo(name, model, host, ZOO_LAUNCHES, res, towers, plain)
    torch.cuda.empty_cache()
    train, _, _ = train_steps(model, host, 2, ZOO_STEP, f"learn {name}",
                              model_name=name, falling=False)
    res["train"] = train
    torch.cuda.empty_cache()
    return res["launches"], train["launches"]


def mask_in_flash(res):
    """MOSI's encoder (LayerNorm + xavier, xPos on 30 features) at width
    768, s=50, with `mask_in_flash=True` and a padded mask: the forward
    (1 R1 + 1 K1) and backward (1 K2) against the same weights at
    flash=False, and against the same flash call without the mask (the
    mask must reach the kernels)."""
    from meant_tpu_torch.nn.encoders import LanguageEncoder
    from meant_tpu_torch.nn.layers import init_weights
    gen = torch.Generator(device="cuda").manual_seed(31)
    kw = dict(dim=DIM, num_heads=HEADS, norm="layer", ff_norm2="rms",
              init_style="xavier", rot_dim=30, ff_dropout=0.0,
              dtype=torch.bfloat16, device="cuda")
    flash = LanguageEncoder(flash=True, mask_in_flash=True, **kw)
    plain = LanguageEncoder(flash=False, **kw)
    init_weights(flash, gen)
    plain.load_state_dict(flash.state_dict())
    x = torch.randn((BATCH, MOSI_SEQ, DIM), generator=gen, device="cuda")
    lengths = torch.randint(1, MOSI_SEQ + 1, (BATCH,), generator=gen,
                            device="cuda")
    mask = (torch.arange(MOSI_SEQ, device="cuda")[None, :]
            < lengths[:, None]).to(torch.float32)
    g = torch.randn((BATCH, MOSI_SEQ, DIM), generator=gen, device="cuda")
    out = {}
    for label, enc, m in (("flash", flash, mask), ("plain", plain, mask),
                          ("flash_unmasked", flash, None)):
        xi = x.clone().requires_grad_(True)
        enc.zero_grad(set_to_none=True)
        if label == "flash":
            reset_counts()
        y = enc(xi, m)
        (y.float() * g).sum().backward()
        torch.cuda.synchronize()
        if label == "flash":
            check_counts(read_counts(), {"K1": 1, "R1": 1, "K2": 1},
                         "mask_in_flash encoder, forward and backward")
        out[label] = (y.float(), xi.grad.float(),
                      torch.cat([p.grad.reshape(-1).float()
                                 for p in enc.parameters()]))
    rels = {f"{part}_rel_l2": rel_l2(a, b) for part, a, b in zip(
        ("out", "input_grad", "param_grad"), out["flash"], out["plain"])}
    moved = rel_l2(out["flash_unmasked"][0], out["flash"][0])
    res["mask_in_flash"] = dict(rels, unmasked_vs_masked_rel_l2=moved)
    print(f"mask_in_flash encoder at s={MOSI_SEQ}, rot_dim 30, padded mask "
          f"(lengths {lengths.tolist()}): flash vs plain {json.dumps(rels)};"
          f" the mask moves the flash output by {moved:.3e}", flush=True)
    if not (rels["out_rel_l2"] <= TOWER_REL_L2
            and rels["input_grad_rel_l2"] <= STEP_GRAD_REL_L2
            and rels["param_grad_rel_l2"] <= STEP_GRAD_REL_L2
            and moved > 1e-2):
        fail(f"mask_in_flash encoder off the plain attention: {rels}, "
             f"mask effect {moved}")


def zoo_cli(res):
    """cli.in_loop_train of the four models that launch no flash kernel
    (meant_price, mlp, lstm, teanet; one epoch of a synthetic set at the
    CLI's defaults: -di 128, -nl 3) and teanet on TempStock-small files:
    exactly one A1 a step, no flash kernel."""
    import os
    from meant_tpu_torch.cli import in_loop_train
    runs = {}
    with tempfile.TemporaryDirectory() as d:
        data = os.path.join(d, "data")
        os.makedirs(data)
        write_tempstock(data, ZOO_DATA_ROWS, seed=32)
        for label, name, extra in (
                ("meant_price", "meant_price", []), ("mlp", "mlp", []),
                ("lstm", "lstm", []), ("teanet", "teanet", []),
                ("teanet_data_dir", "teanet", ["--data_dir", data])):
            argv = ["-rid", "smoke", "-mn", name, "-ne", "1", "-tb",
                    str(BATCH), "--synthetic_n", str(ZOO_CLI_ROWS), "-fp", d,
                    "-lrst", "constant"] + extra
            reset_counts()
            results = in_loop_train.main(argv)
            counts = read_counts()
            steps = results["trainer"].optimizer.step_count
            check_counts(counts, {"A1": steps}, f"cli.in_loop_train -mn "
                         f"{label}")
            loss = results["history"][0]["train_loss"]
            if steps < 1 or not np.isfinite(loss):
                fail(f"cli.in_loop_train -mn {label}: {steps} steps, loss "
                     f"{loss}")
            runs[label] = {"steps": steps, "launches": counts,
                           "train_loss": loss, "test": results["test"]}
            print(f"cli.in_loop_train -mn {label}: {steps} steps, loss "
                  f"{loss:.5f}, launches {counts}", flush=True)
            del results
    res["cli"] = runs
    torch.cuda.empty_cache()


def run_zoo(record) -> dict:
    """Phase 11: the TimeSformer family, meant_tweet_price, meant_mosi and
    the four models without flash kernels at the CLI's widths."""
    t0 = time.perf_counter()
    res = {}
    record["zoo"] = res
    out = {"timesformer": zoo_timesformer(res.setdefault(
        "meant_timesformer", {}))}
    name = "meant_mean_pooling"
    zoo_model(name, build_zoo(name, "--seq_len", str(SEQ), "--flash",
                              "true"), zoo_batch(name, BATCH, seed=33),
              res.setdefault(name, {}))
    name = "meant_tweet_price"
    args = ("--seq_len", str(PAPER_SEQ), "--flash")
    out["tweet_price"] = zoo_model(
        name, build_zoo(name, *args, "true"),
        zoo_batch(name, BATCH, seed=34), res.setdefault(name, {}),
        plain=build_zoo(name, *args, "false"),
        towers=lambda m: {"text": m.languageEncoders})
    out["mosi"] = zoo_model(
        "meant_mosi", build_mosi(True), zoo_batch("meant_mosi", BATCH,
                                                  seed=35),
        res.setdefault("meant_mosi", {}), plain=build_mosi(False),
        towers=lambda m: {"text": m.languageEncoders,
                          "vision": m.timesformer})
    mask_in_flash(res)
    zoo_cli(res)
    out["a1_err"] = check_adamw(res["meant_timesformer"],
                                res["meant_timesformer"]["n_params"])
    out["n_params"] = res["meant_timesformer"]["n_params"]
    res["wall_s"] = time.perf_counter() - t0
    print(f"phase zoo: {res['wall_s']:.1f} s", flush=True)
    return out


# ---- phase 12: shapes and extras -------------------------------------------

# The flash kernels at the head dims and lengths the CLI reaches beside the
# flagship's one length at d = 96: (name, attention_case kind, s, s_k, BH,
# d, heads). meant_src --num_heads 12 (width 768, d = 64) at s=512 causal
# xPos and s=196 pixel rotary, BH = 16 x 5 x 12; --num_heads 6 (d = 128) at
# s=512, BH = 16 x 5 x 6; --num_heads 16 (d = 48, padded to 64) at s=128
# on a small BH; the TimeSformer space group of --image_size 256 (256
# queries and 257 keys at d = 64, q scaled beforehand, no tables, no
# mask), BH = 16 x 8 heads x 5 frames.
SHAPE_CASES = (
    ("text_d64", "text", SEQ, SEQ, BATCH * LAG * 12, 64, 12),
    ("vision_d64", "vision", N_PATCHES, N_PATCHES, BATCH * LAG * 12, 64, 12),
    ("text_d128", "text", SEQ, SEQ, BATCH * LAG * 6, 128, 6),
    ("text_d48", "text", PAPER_SEQ, PAPER_SEQ, 64, 48, 16),
    ("group_256x257", "group", 256, 257, BATCH * HEADS * LAG, 64, 1))
SRC12_HEADS, SRC6_HEADS = 12, 6
SRC12_STEPS = 5
TS_IMAGE = 256             # meant_timesformer --image_size 256: 256 patches
TS_LAUNCHES = {"K1": ENCODERS + 1, "R1": ENCODERS + 1}   # + the space group
MU_STEPS, MU_FP32_STEPS = 10, 3
ACCUM_K, ACCUM_MICRO, ACCUM_ROWS = 2, 10, 8   # bench.py's "b8 x accum2"
ACCUM_GRAD_REL_L2 = 5e-2
LONG6_BH = LONG_BATCH * LAG * SRC6_HEADS      # src4096 at 6 heads: 60
STEP = {"K1": 2 * ENCODERS, "R1": 2 * ENCODERS, "K2": 2 * ENCODERS,
        "A1": 1}


def group_unit(name: str, ref) -> float:
    """The unit of the element bars' absolute parts: 1 (the bars in force)
    but for the TimeSformer group, whose gradients come at scale 1 on a
    pre-scaled q (dq reaches some 160 with an RMS near 30, where FP32_ATOL
    is below one fp32 step and BWD_BF16_ATOL below one bf16 step): there
    the reference's RMS, where that passes 1."""
    if not name.startswith("group"):
        return 1.0
    return max(1.0, ref.float().pow(2).mean().sqrt().item())


def run_autograd(c):
    """flash_mha forward (R1 + K1) and its autograd backward (K2 on K1's Qr
    and Kr), a head dim the kernels are not built for padded as the
    wrapper pads it: (out, dq, dk, dv)."""
    from meant_tpu_torch.ops.flash import flash_mha
    qcos, qsin, kcos, ksin = c["tables"]
    leaves = [c[n].detach().requires_grad_(True) for n in "qkv"]
    out = flash_mha(*leaves, scale=c["scale"], causal=c["causal"],
                    attention_mask=c["mask"], qcos=qcos, qsin=qsin,
                    kcos=kcos, ksin=ksin)
    return (out.detach(), *torch.autograd.grad(out, leaves, c["do"]))


def shape_case(name, dtype, gen):
    _, kind, s, s_k, bh, d, heads = next(c for c in SHAPE_CASES
                                         if c[0] == name)
    return backward_case(kind, dtype, gen, s=s, s_k=s_k, bh=bh, d=d,
                         heads=heads)


def check_shapes(record) -> dict:
    """R1 + K1 and K2 through flash_mha (padding included) against
    flash_mha_reference and flash_mha_bwd_reference at SHAPE_CASES, fp32
    and bf16, at the bars in force (fp32 FP32_RTOL / FP32_ATOL; bf16: K1's
    and K2's; the absolute parts in `group_unit`); R1 bit for bit where d
    is one of the kernels' own."""
    from meant_tpu_torch.ops.flash.kernel import (BWD_BF16_ATOL,
                                                  BWD_BF16_REL_L2, HEAD_DIMS,
                                                  K1_BF16_REL_L2)
    gen = torch.Generator(device="cuda").manual_seed(12)
    errors, rels = {}, {}
    for name, *_ in SHAPE_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            c = shape_case(name, dtype, gen)
            got = run_autograd(c)
            torch.cuda.synchronize()
            want = [run_plain(c), *run_bwd_plain(c)]
            torch.cuda.synchronize()
            label = f"{name}/{str(dtype).split('.')[-1]}"
            if c["q"].shape[-1] in HEAD_DIMS:
                rot_err = max((a.float() - b.float()).abs().max().item()
                              for a, b in zip(rotate_case(c),
                                              rotate_plain(c)))
                print(f"R1 vs plain {label}: max_abs_err {rot_err:.3e} "
                      f"(bar 0) {'ok' if rot_err == 0 else 'FAIL'}",
                      flush=True)
                if rot_err != 0:
                    fail(f"R1 differs from _rotate ({label})")
                errors[f"{label}/rot"] = rot_err
            for g, a, b in zip(("out", "dq", "dk", "dv"), got, want):
                err = (a.float() - b.float()).abs().max().item()
                rel = rel_l2(a, b)
                unit = group_unit(name, b)
                if dtype == torch.float32:
                    ok = torch.allclose(a, b, rtol=FP32_RTOL,
                                        atol=FP32_ATOL * unit)
                elif g == "out":
                    ok = (torch.allclose(a.float(), b.float(), rtol=BF16_TOL,
                                         atol=BF16_TOL * unit)
                          and rel <= K1_BF16_REL_L2)
                else:
                    ok = (torch.allclose(a.float(), b.float(), rtol=BF16_TOL,
                                         atol=BWD_BF16_ATOL * unit)
                          and rel <= BWD_BF16_REL_L2)
                ok = ok and bool(torch.isfinite(a).all())
                kernel = "R1 + K1" if g == "out" else "R1 + K2"
                print(f"{kernel} vs plain {label} {g}: max_abs_err {err:.3e}"
                      f" rel_l2 {rel:.3e} (|ref| max "
                      f"{b.abs().max().item():.3e}, atol unit {unit:.3g}) "
                      f"{'ok' if ok else 'FAIL'}", flush=True)
                if not ok:
                    fail(f"{kernel} disagrees with its plain version "
                         f"({label} {g}, max abs err {err}, rel L2 {rel})")
                errors[f"{label}/{g}"], rels[f"{label}/{g}"] = err, rel
            del c, got, want
            torch.cuda.empty_cache()
    record["shapes_vs_plain_max_abs_err"] = errors
    record["shapes_vs_plain_rel_l2"] = rels
    return errors


def count_new_hgmma() -> dict:
    """wgmma in every instantiation at head dims 64 and 128: K1, K3 (the
    forward body), K2's two kernels and K4 + K5."""
    counts = {}
    for d in (64, 128):
        for label, lib, function in (
                ("K1", "flash_fwd", f"flash_fwd_wgmma_kernelILi{d}E"),
                ("K3", "flash_fwd", f"flash_fwd_lse_wgmma_kernelILi{d}E"),
                ("K2", "flash_bwd", f"ILb1ELi{d}E"),
                ("K4+K5", "flash_bwd_online", f"ILb0ELi{d}E")):
            counts[f"{label} d{d}"] = count_hgmma(lib, function)
    return counts


def serve_src_heads(res, heads: int, rows: int, compare: bool):
    """build_model(-mn meant_src --num_heads heads --flash true) at the
    flagship's width serves `rows` rows in requests of BATCH (exactly 24 R1
    + 24 K1 a request); with `compare`, the towers and probabilities of one
    request against the same weights at flash=False."""
    from meant_tpu_torch.serve import Predictor
    label = f"meant_src --num_heads {heads}"
    args = ("--seq_len", str(SEQ), "--num_heads", str(heads), "--flash")
    model = build_zoo("meant_src", *args, "true")
    predictor = Predictor(model, "meant_src", batch_size=BATCH)
    batch = request_batch(rows, seed=40 + heads)
    chunk = {k: v[:BATCH] for k, v in batch.items()}
    predictor(chunk)        # warm-up
    torch.cuda.synchronize()
    reset_counts()
    probs = predictor(batch)
    torch.cuda.synchronize()
    counts = read_counts()
    want = -(-rows // BATCH) * 2 * ENCODERS
    print(f"served {label}: {rows} rows, launches {counts}", flush=True)
    check_counts(counts, {"K1": want, "R1": want}, f"serving {label}")
    if (probs.shape != (rows, 2) or not np.isfinite(probs).all()
            or not ((probs > 0) & (probs < 1)).all()):
        fail(f"bad {label} probabilities {probs.shape}")
    res["serve_launches"] = counts
    if not compare:
        del model, predictor
        torch.cuda.empty_cache()
        return counts
    plain = build_zoo("meant_src", *args, "false")
    plain.load_state_dict(model.state_dict())
    compare_slice(f"src_heads{heads}",
                  towers_and_probs(model, predictor, chunk),
                  towers_and_probs(plain, Predictor(plain, "meant_src",
                                                    batch_size=BATCH), chunk),
                  res)
    del model, plain, predictor
    torch.cuda.empty_cache()
    return counts


def run_src_heads(res, heads: int, rows: int, steps: int, grads: bool):
    """meant_src at `heads` heads of the flagship's width: serving through
    the CLI's build_model, then the flagship at fixed_proj=True (the
    trained configuration): with `grads`, the served towers against
    flash=False and one step's gradients against the plain attention;
    `steps` trainer steps with exactly 24 R1, 24 K1, 24 K2 and 1 A1 a step
    (a falling loss past 2 steps)."""
    serve = serve_src_heads(res, heads, rows, compare=grads)
    model = build_flagship(flash=True, fixed_proj=True, num_heads=heads)
    if grads:
        res["step_gradients"] = compare_step_gradients(
            model, to_card(train_batch(GRAD_ROWS, seed=6)),
            {k: n for k, n in STEP.items() if k != "A1"},
            lambda: build_flagship(flash=False, fixed_proj=True,
                                   num_heads=heads),
            f"meant_src --num_heads {heads} train step")
    res["train"], _, _ = train_steps(
        model, train_batch(BATCH, seed=7), steps, STEP,
        f"learn meant_src --num_heads {heads}", falling=steps > 2)
    del model
    torch.cuda.empty_cache()
    return serve, res["train"]["launches"]


def run_timesformer_256(res):
    """meant_timesformer --image_size 256 --flash true at the CLI's widths:
    one request (12 R1 + 12 K1 for the text encoders, 1 R1 + 1 K1 for the
    TimeSformer's space group of 256 queries and 257 keys) against
    flash=False, and 2 trainer steps with as many K2 and 1 A1 a step."""
    from meant_tpu_torch.cli.common import synthetic_batch
    name = "meant_timesformer"
    extra = ("--seq_len", str(SEQ), "--image_size", str(TS_IMAGE))
    model = build_zoo(name, *extra, "--flash", "true")
    host = synthetic_batch(zoo_args(name, *extra), BATCH, seed=36)
    serve_zoo(name, model, host, TS_LAUNCHES, res,
              lambda m: {"text": m.languageEncoders, "vision": m.timesformer},
              plain=build_zoo(name, *extra, "--flash", "false"))
    torch.cuda.empty_cache()
    res["train"], _, _ = train_steps(
        model, host, 2, {**TS_LAUNCHES, "K2": ENCODERS + 1, "A1": 1},
        f"learn {name} --image_size {TS_IMAGE}", model_name=name,
        falling=False)
    del model
    torch.cuda.empty_cache()
    return res["launches"], res["train"]["launches"]


def check_adamw_bf16(res, n: int) -> float:
    """A1 with a bf16 first moment against adamw_reference over n
    parameters: p and v to ADAMW_REL_ERR relative, m equal but for ties
    (within one bf16 step: both round the same fp32 m')."""
    from meant_tpu_torch.ops.adamw import (adamw_reference, adamw_update,
                                           update_scalars)
    gen = torch.Generator(device="cuda").manual_seed(14)
    p, g, m, v = adamw_case(n, gen)
    m = m.to(torch.bfloat16)
    ref = [t.clone() for t in (p, m, v)]
    norm = torch.linalg.vector_norm(g)
    adamw_update(p, g, m, v, norm=norm, **ADAMW_ARGS)
    h = update_scalars(mu_bf16=True, coupled=False,
                       **{k: x for k, x in ADAMW_ARGS.items()
                          if k != "max_norm"})
    adamw_reference(ref[0], g, ref[1], ref[2], h, norm, 1.0)
    torch.cuda.synchronize()
    worst = 0.0
    for name, a, b in (("p", p, ref[0]), ("v", v, ref[2])):
        rel = ((a - b).abs() / b.abs().clamp_min(1e-30)).max().item()
        worst = max(worst, rel)
        print(f"A1 (bf16 m) vs plain {name}: max relative error {rel:.3e} "
              f"over {n} parameters", flush=True)
        if not (rel <= ADAMW_REL_ERR and torch.isfinite(a).all()):
            fail(f"A1 with a bf16 m disagrees with its plain version "
                 f"({name}, {rel})")
    differ = (m != ref[1])
    step = (ref[1].float().abs() * 2.0 ** -7).clamp_min(1e-38)
    off = ((m.float() - ref[1].float()).abs() > step).sum().item()
    print(f"A1 (bf16 m) vs plain m: {differ.sum().item()} of {n} elements "
          f"differ, {off} by more than one bf16 step", flush=True)
    if off:
        fail("A1's bf16 m is off its plain version by more than a tie")
    res.update(a1_bf16_vs_plain_max_rel_err=worst,
               a1_bf16_m_differ=differ.sum().item())
    worst_abs = (p - ref[0]).abs().max().item()
    del p, g, m, v, ref
    torch.cuda.empty_cache()
    return worst_abs


def run_mu_bf16(res):
    """The flagship (fixed_proj=True) trained on one replayed batch with
    an fp32 first moment (MU_FP32_STEPS steps, for peak memory and step
    time) and then MU_STEPS steps with mu_dtype=bf16 (24 R1, 24 K1, 24 K2,
    1 A1 a step; falling loss), each on a fresh model: peak memory side by
    side."""
    res["a1_err"] = check_adamw_bf16(res, res["n_params"])
    host = train_batch(BATCH, seed=1)
    runs = {}
    for label, mu_dtype, steps in (("fp32", None, MU_FP32_STEPS),
                                   ("bf16", torch.bfloat16, MU_STEPS)):
        model = build_flagship(flash=True, fixed_proj=True)
        runs[label], trainer, _ = train_steps(
            model, host, steps, STEP, f"learn with a {label} first moment",
            mu_dtype=mu_dtype)
        if trainer.optimizer.m.dtype != (mu_dtype or torch.float32):
            fail(f"mu_dtype={mu_dtype} left the first moment in "
                 f"{trainer.optimizer.m.dtype}")
        del model, trainer
        torch.cuda.empty_cache()
    peak = {k: r["peak_memory_bytes"] for k, r in runs.items()}
    saved = peak["fp32"] - peak["bf16"]
    print(f"mu_bf16: peak memory {peak['bf16'] / 2 ** 30:.3f} GiB against "
          f"fp32 m's {peak['fp32'] / 2 ** 30:.3f} GiB ({saved / 2 ** 20:.1f} "
          f"MiB less; the moment alone is "
          f"{res['n_params'] * 2 / 2 ** 20:.1f} MiB less); step median "
          f"{runs['bf16']['step_ms_median']:.3f} ms against "
          f"{runs['fp32']['step_ms_median']:.3f} ms", flush=True)
    if saved <= 0:
        fail("a bf16 first moment did not lower peak memory")
    res.update(train=runs["bf16"], train_fp32_m=runs["fp32"],
               peak_saved_bytes=saved)
    return runs["bf16"]["launches"]


def accumulated_gradient(model, host) -> torch.Tensor:
    """The gradient A1 receives from ACCUM_K micro-steps of meant_trainer's
    optimizer with accumulation_steps=ACCUM_K, one per ACCUM_ROWS-row half
    of `host`, dropout off: the running mean that reaches the update,
    flat fp32."""
    from meant_tpu_torch.train import optim
    trainer = make_trainer(model, host, accumulation_steps=ACCUM_K)
    trainer._init_state()
    opt, seen = trainer.optimizer, []
    update = optim.adamw_update
    optim.adamw_update = lambda p, g, *a, **kw: (seen.append(g.clone()),
                                                 update(p, g, *a, **kw))
    loss_fn = classify_loss("meant_src")
    try:
        model.eval()
        for i in range(ACCUM_K):
            opt.zero_grad()
            loss_fn(model, to_card({k: v[i * ACCUM_ROWS:(i + 1) * ACCUM_ROWS]
                                    for k, v in host.items()})).backward()
            opt.step()
    finally:
        optim.adamw_update = update
    if len(seen) != 1 or opt.step_count != 1:
        fail(f"{ACCUM_K} micro-steps applied {len(seen)} updates")
    return seen[0]


def run_accumulation(res):
    """The flagship (fixed_proj=True) at batch ACCUM_ROWS with
    accumulation_steps=ACCUM_K: the mean of two micro-steps' gradients
    against one batch-16 gradient of the same rows and weights, per group
    at ACCUM_GRAD_REL_L2; then ACCUM_MICRO micro-steps with exactly
    ACCUM_MICRO / ACCUM_K A1 launches and a falling loss."""
    host = train_batch(ACCUM_K * ACCUM_ROWS, seed=8)
    model = build_flagship(flash=True, fixed_proj=True)
    state = {k: v.clone() for k, v in model.state_dict().items()}
    _, want = step_gradients(model, to_card(host), classify_loss("meant_src"))
    model.load_state_dict(state)
    flat = accumulated_gradient(model, host)
    got, offset = {}, 0
    for name, p in model.named_parameters():
        if p.requires_grad:
            got.setdefault(_group(name), []).append(
                flat[offset:offset + p.numel()])
            offset += p.numel()
    rels = {}
    for group, parts in got.items():
        rels[group] = rel_l2(torch.cat(parts), want[group])
        if not rels[group] <= ACCUM_GRAD_REL_L2:
            fail(f"accumulated gradient of {group} is off the batch-16 one "
                 f"(relative L2 {rels[group]:.3e})")
    print(f"accumulation: the mean of {ACCUM_K} x {ACCUM_ROWS} rows against "
          f"{ACCUM_K * ACCUM_ROWS} rows, relative L2 per group "
          f"{json.dumps(rels)}", flush=True)
    res["grad_rel_l2"] = rels
    del model, state, want, flat, got
    torch.cuda.empty_cache()
    model = build_flagship(flash=True, fixed_proj=True)
    micro = {k: v[:ACCUM_ROWS] for k, v in host.items()}
    per = {k: n for k, n in STEP.items() if k != "A1"}
    want_counts = {**{k: n * ACCUM_MICRO for k, n in per.items()},
                   "A1": ACCUM_MICRO // ACCUM_K}
    res["train"], trainer, _ = train_steps(
        model, micro, ACCUM_MICRO, STEP, f"learn b{ACCUM_ROWS} x accum"
        f"{ACCUM_K}", want=want_counts, accumulation_steps=ACCUM_K)
    if trainer.optimizer.step_count != ACCUM_MICRO // ACCUM_K:
        fail(f"{ACCUM_MICRO} micro-steps applied "
             f"{trainer.optimizer.step_count} updates")
    del model, trainer
    torch.cuda.empty_cache()
    return res["train"]["launches"]


def run_long_heads6(res):
    """src4096 at --num_heads 6 (d = 128) with LONG_GRAD_ENCODERS encoders a
    tower, the streaming path at d = 128 from the user's entry points: one
    request of LONG_BATCH rows through Predictor (exactly 2 K3 + 2 K1 + 4
    R1) and 2 trainer steps (2 K3, 2 K1, 6 R1, 2 K4, 2 K5, 2 K2 and 1 A1 a
    step)."""
    from meant_tpu_torch.serve import Predictor
    n = LONG_GRAD_ENCODERS
    model = build_flagship(LONG_SEQ, flash=True, fixed_proj=True,
                           num_heads=SRC6_HEADS, num_encoders=n)
    predictor = Predictor(model, "meant_src", batch_size=LONG_BATCH)
    rows = request_batch(LONG_BATCH, seed=50, seq=LONG_SEQ)
    predictor(rows)     # warm-up
    torch.cuda.synchronize()
    reset_counts()
    probs = predictor(rows)
    torch.cuda.synchronize()
    counts = read_counts()
    print(f"served src4096 --num_heads {SRC6_HEADS} at {n} encoders: "
          f"launches {counts}", flush=True)
    check_counts(counts, {"K3": n, "K1": n, "R1": 2 * n},
                 f"serving src4096 at {SRC6_HEADS} heads")
    if not (np.isfinite(probs).all() and ((probs > 0) & (probs < 1)).all()):
        fail(f"bad src4096 probabilities at {SRC6_HEADS} heads")
    res["serve_launches"] = counts
    del predictor
    res["train"], _, _ = train_steps(
        model, train_batch(LONG_BATCH, seed=51, seq=LONG_SEQ), 2,
        {"K3": n, "K1": n, "R1": 3 * n, "K4": n, "K5": n, "K2": n, "A1": 1},
        f"learn src4096 --num_heads {SRC6_HEADS}", falling=False)
    del model
    torch.cuda.empty_cache()
    return {"R1": counts["R1"] + res["train"]["launches"]["R1"],
            **{k: res["train"]["launches"][k] for k in ("K4", "K5")},
            "K3": counts["K3"] + res["train"]["launches"]["K3"]}


def time_shapes(out, n_params) -> list:
    """The rows of the new shapes: R1 + K1, K2 and R1 at d = 64 (s=512 and
    196, BH = 960), d = 128 (s=512, BH = 480) and the TimeSformer group
    (256 x 257, d = 64, BH = 640), each with the launches of the run that
    reaches it (meant_src --num_heads 12, --num_heads 6, meant_timesformer
    --image_size 256); R1 + K3, R1, K4 and K5 at src4096's launch at 6
    heads (BH = 60, d = 128) with the launches of that drive; A1 with a
    bf16 first moment at the flagship's count."""
    gen = torch.Generator(device="cuda").manual_seed(15)
    errors, rows = out["errors"], []
    for name, label, (serve, steps) in (
            ("text_d64", "s512 causal xPos d64", out["src12"]),
            ("vision_d64", "s196 pixel rotary d64", out["src12"]),
            ("text_d128", "s512 causal xPos d128", out["src6"]),
            ("group_256x257", "s256x257 d64 TimeSformer group",
             out["timesformer"])):
        c = shape_case(name, torch.bfloat16, gen)
        d = c["q"].shape[-1]
        key = shape_key(c["s"], c["causal"], c["s_k"], d)
        bf16 = f"{name}/bfloat16"
        rows += resident_rows(
            c, label, serve["K1_by_shape"].get(key, 0),
            steps["K2_by_shape"].get(key, 0),
            steps["R1_by_shape"].get(r1_key(c["s"], c["s_k"], d), 0),
            errors[f"{bf16}/out"],
            max(errors[f"{bf16}/{g}"] for g in ("dq", "dk", "dv")),
            errors[f"{bf16}/rot"])
        del c
    rows += time_long_kernels(out["long_errors"], out["long6"],
                              bh=LONG6_BH, small_bh=SRC6_HEADS,
                              tag="long_d128", label="s4096 causal xPos d128",
                              d=128, heads=SRC6_HEADS)
    rows.append(adamw_row("adamw[mu_bf16]", n_params, out["mu_bf16"]["A1"],
                          out["a1_bf16_err"], gen, mu_bf16=True))
    return rows


def trace_mlm_heads_fp32(res):
    """The gathered MLM head against the full one of bench.py's build_mlm
    in fp32 (activations and the flash kernels' fp32 bodies), one batch,
    dropout off: a reading held to no bar. Agreement to 1e-5 reads the bf16
    gap (`compare_heads`) as rounding at different GEMM shapes."""
    from meant_tpu_torch import models
    model = models.meant_language_pretrainer(
        embedding=models.EmbeddingConfig(hidden_size=DIM), text_dim=DIM,
        num_encoders=ENCODERS, num_heads=HEADS, flash=True, dtype=None,
        device="cuda", seed=0)
    batch = to_card(pretrain_batch("mlm"))
    loss_g, grads_g = step_gradients(model, batch, pretrain_loss("mlm"))
    loss_f, grads_f = step_gradients(
        model, batch, pretrain_loss("mlm", gather_masked=False))
    out = {"loss_gathered": loss_g, "loss_full": loss_f,
           "loss_rel_err": abs(loss_g - loss_f) / abs(loss_f)}
    for name, g in grads_g.items():
        out[f"{name}_grad_rel_l2"] = rel_l2(g, grads_f[name])
    out["agree_to_1e-5"] = all(v <= 1e-5 for k, v in out.items()
                               if k.endswith(("_rel_l2", "_rel_err")))
    print(f"mlm gathered head vs full head in fp32 (a reading): "
          f"{json.dumps(out)}", flush=True)
    res["mlm_heads_fp32"] = out
    del model, batch, grads_g, grads_f
    torch.cuda.empty_cache()


def run_shapes(record, n_params: int) -> dict:
    """Phase 12: the kernels at the new head dims and lengths, the models
    that reach them, and the trainer's --mu_bf16 and accumulation."""
    t0 = time.perf_counter()
    res = {"n_params": n_params}
    record["shapes"] = res
    res["hgmma"] = count_new_hgmma()
    out = {"errors": check_shapes(res)}
    out["long_errors"] = check_long_kernels(
        res, bh=LONG6_BH, kinds=("text",), tag="long_d128", seed=13, d=128,
        heads=SRC6_HEADS)
    out["src12"] = run_src_heads(res.setdefault("src_heads12", {}),
                                 SRC12_HEADS, REQUEST_ROWS, SRC12_STEPS, True)
    out["src6"] = run_src_heads(res.setdefault("src_heads6", {}),
                                SRC6_HEADS, BATCH, 2, False)
    out["timesformer"] = run_timesformer_256(
        res.setdefault("timesformer_256", {}))
    out["long6"] = run_long_heads6(res.setdefault("long_heads6", {}))
    mu = res.setdefault("mu_bf16", {"n_params": n_params})
    out["mu_bf16"] = run_mu_bf16(mu)
    out["a1_bf16_err"] = mu["a1_err"]
    out["accumulation"] = run_accumulation(res.setdefault("accumulation", {}))
    trace_mlm_heads_fp32(res)
    res["wall_s"] = time.perf_counter() - t0
    print(f"phase shapes: {res['wall_s']:.1f} s", flush=True)
    return out


# ---- phase 13: VQA, the HF baselines and tweet_eval --------------------

# bench.py's vqa cell (build_vqa, bench.py:390-434): meant_vqa-12 at 768
# wide, 8 heads of 96, s=40 questions (VQA_SEQ), 4x224^2 charts, batch 64,
# 3130 answers, soft targets with a second annotator at 1/3, bf16 with fp32
# params. The VQA CLI runs -tb 16 over 64 rows: 16 val, 16 test, 32 train.
VQA_CLASSES = 3130
VQA_CLI_ROWS = 64
VQA_STEP = {"K1": 2 * ENCODERS, "R1": 2 * ENCODERS, "K2": 2 * ENCODERS,
            "A1": 1}
VQA_STEPS = 3
VQA_LR = 5e-5                         # the VQA CLI's default -l
# the HF baselines at the CLI's widths (768, -nec 12, --num_heads 8, vocab
# 64001, batch 16); ViLT's text position table holds 40 tokens
HF_SEQ = {"bertweet": PAPER_SEQ, "vl_bert": PAPER_SEQ, "vilt": 40}
HF_STEPS = 3
HF_DATA_ROWS = 80                     # 48 / 16 / 16 rows: 3 steps at 16
TWEET_EVAL_EPOCHS = 2


def vqa_model(flash: bool):
    """bench.py's build_vqa model, seeded, on the card."""
    from meant_tpu_torch.models import EmbeddingConfig, meant_vqa
    return meant_vqa(DIM, DIM, 4, IMAGE, IMAGE, PATCH, 1, VQA_CLASSES,
                     embedding=EmbeddingConfig(), flash=flash,
                     num_heads=HEADS, num_encoders=ENCODERS,
                     dtype=torch.bfloat16, device="cuda", seed=0)


def vqa_batch(n: int = VQA_BATCH, s: int = VQA_SEQ, seed: int = 0) -> dict:
    """bench.py's VQA batch (its RandomState draws, in its order): one-hot
    targets with a second annotator's answer at 1/3."""
    rng = np.random.RandomState(seed)
    labels = np.zeros((n, VQA_CLASSES), np.float32)
    hard = rng.randint(0, VQA_CLASSES, size=n)
    labels[np.arange(n), hard] = 1.0
    soft = rng.randint(0, VQA_CLASSES, size=n)
    labels[np.arange(n), soft] = np.maximum(labels[np.arange(n), soft],
                                            1 / 3)
    return {"language_input_ids": rng.randint(2, 64000, size=(n, s)).astype(
                np.int32),
            "pixel_values": rng.randn(n, 4, IMAGE, IMAGE).astype(np.float32),
            "attention_mask": np.ones((n, s), np.float32),
            "pixel_mask": np.ones((n, IMAGE, IMAGE), np.float32),
            "labels": labels}


def vqa_loss(model, batch):
    """The VQA trainer's objective on a device batch."""
    from meant_tpu_torch.train.vqa import soft_target_ce
    out = model(batch["language_input_ids"], batch["pixel_values"],
                attention_mask=batch["attention_mask"])
    return soft_target_ce(out, batch["labels"])


def vqa_trainer_on(model, host):
    """vqa_trainer on one replayed batch (numpy `host`) at VQA_LR
    constant."""
    from meant_tpu_torch.data.loader import ArrayLoader
    from meant_tpu_torch.train.vqa import vqa_trainer
    return vqa_trainer({
        "model": model, "model_name": "meant_vqa",
        "train_loader": ArrayLoader(host, len(host["labels"])),
        "num_classes": VQA_CLASSES, "lr": VQA_LR, "lrst": "constant",
        "seed": 0, "test_model": False})


def check_by_shape(counts: dict, want: dict, label: str):
    """Fail unless K1's and K2's launches by shape are exactly `want`
    ({kernel: {shape_key: n}})."""
    for name, shapes in want.items():
        if counts[f"{name}_by_shape"] != shapes:
            fail(f"{label}: {name} launched {counts[f'{name}_by_shape']}, "
                 f"want {shapes}")


def learn_vqa(res) -> dict:
    """One step's gradients against the plain attention, VQA_STEPS trainer
    steps at batch 64 (24 R1, 24 K1, 24 K2, 1 A1 a step; K1 and K2 12 at
    s=40 and 12 at s=196), a profiled step, then the same steps at
    flash=False (bench.py's setting), timed and profiled only."""
    model = vqa_model(flash=True)
    res["n_params"] = sum(p.numel() for p in model.parameters())
    res["step_gradients"] = compare_step_gradients(
        model, to_card(vqa_batch(GRAD_ROWS, seed=41)),
        {k: n for k, n in VQA_STEP.items() if k != "A1"},
        lambda: vqa_model(flash=False), "meant_vqa step",
        loss_fn=vqa_loss)
    host = vqa_batch()
    train, trainer, batch = timed_steps(vqa_trainer_on(model, host), host,
                                        VQA_STEPS, VQA_STEP,
                                        "learn meant_vqa")
    per_shape = {shape_key(VQA_SEQ, True): ENCODERS * VQA_STEPS,
                 shape_key(N_PATCHES, False): ENCODERS * VQA_STEPS}
    check_by_shape(train["launches"], {"K1": per_shape, "K2": per_shape},
                   "meant_vqa's steps")
    res["train"] = train
    res["train_profile"] = profile_calls(lambda: trainer.train_step(batch),
                                         1, "step", rows=VQA_BATCH)
    del model, trainer, batch
    torch.cuda.empty_cache()
    plain = vqa_model(flash=False)
    res["train_flash_off"], trainer, batch = timed_steps(
        vqa_trainer_on(plain, host), host, VQA_STEPS, {"A1": 1},
        "meant_vqa at flash=False", falling=False)
    res["train_flash_off_profile"] = profile_calls(
        lambda: trainer.train_step(batch), 1, "step", rows=VQA_BATCH)
    del plain, trainer, batch
    torch.cuda.empty_cache()
    return train["launches"]


def write_vqa_npz(path: str, n: int, seed: int):
    """A vqa_prepared.npz at bench.py's VQA geometry (s=40, 3130 answers)."""
    import os
    b = vqa_batch(n, seed=seed)
    np.savez(os.path.join(path, "vqa_prepared.npz"),
             input_ids=b["language_input_ids"], images=b["pixel_values"],
             attention_mask=b["attention_mask"], pixel_mask=b["pixel_mask"],
             soft_targets=b["labels"])


def vqa_through_cli(res) -> dict:
    """cli.vqa one epoch at -tb 16 and -nc 3130: the synthetic set (s=24)
    and a vqa_prepared.npz written here (s=40); the default --flash takes
    the flash path (the raw string), K1 and K2 at the question length and
    at s=196, a checkpoint written. Returns the synthetic run's counts."""
    import os
    from meant_tpu_torch.cli import vqa as vqa_cli
    runs = {}
    with tempfile.TemporaryDirectory() as d:
        write_vqa_npz(d, VQA_CLI_ROWS, seed=42)
        for label, s, extra in (("synthetic", VQA_CLI_SEQ, []),
                                ("npz", VQA_SEQ, ["--data_dir", d])):
            argv = ["-rid", "smoke", "-nec", str(ENCODERS), "-nc",
                    str(VQA_CLASSES), "--synthetic_n", str(VQA_CLI_ROWS),
                    "-tb", str(BATCH), "-ne", "1", "-fp", d] + extra
            reset_counts()
            results = vqa_cli.main(argv)
            counts = read_counts()
            trainer = results["trainer"]
            steps = trainer.optimizer.step_count
            forwards = steps + len(trainer.val_loader) + len(
                trainer.test_loader)
            check_counts(counts, {"K1": 24 * forwards, "R1": 24 * forwards,
                                  "K2": 24 * steps, "A1": steps},
                         f"cli.vqa ({label}): {steps} steps and "
                         f"{forwards - steps} evaluation forwards")
            check_by_shape(counts, {
                "K1": {shape_key(s, True): ENCODERS * forwards,
                       shape_key(N_PATCHES, False): ENCODERS * forwards},
                "K2": {shape_key(s, True): ENCODERS * steps,
                       shape_key(N_PATCHES, False): ENCODERS * steps}},
                f"cli.vqa ({label})")
            path = results["checkpoint"]
            loss = results["history"][0]["train_loss"]
            if (path is None or not os.path.exists(path)
                    or not np.isfinite(loss)):
                fail(f"cli.vqa ({label}): checkpoint {path}, loss {loss}")
            runs[label] = {"steps": steps, "launches": counts,
                           "history": results["history"],
                           "checkpoint": os.path.basename(path),
                           "test_f1_macro": results["test"]["f1_macro"]}
            print(f"cli.vqa ({label}, s={s}): {steps} steps, loss "
                  f"{loss:.5f}, launches {counts}, checkpoint "
                  f"{os.path.basename(path)}", flush=True)
            del results, trainer
            torch.cuda.empty_cache()
    res["cli"] = runs
    return runs["synthetic"]["launches"]


def hf_args(name: str, *extra):
    return zoo_args(name, "--seq_len", str(HF_SEQ[name]), *extra)


def hf_baseline(name: str, res) -> int:
    """-mn name at the CLI's widths: HF_STEPS meant_trainer steps on the
    CLI's synthetic batch (one A1 a step, no flash kernel; every parameter
    finite after them, through the finfo.min masks), a profiled step; then
    cli.in_loop_train on a TempStock-small directory written here (3 steps,
    evaluation, a checkpoint; exactly one A1 a step and no other launch)
    and Predictor(checkpoint_path=...) serving one request with the trained
    model's probabilities. Returns the CLI's steps."""
    import os
    from meant_tpu_torch.cli import in_loop_train
    from meant_tpu_torch.cli.common import build_model, synthetic_batch
    from meant_tpu_torch.serve import Predictor
    model = build_model(hf_args(name))
    res["n_params"] = sum(p.numel() for p in model.parameters())
    host = synthetic_batch(hf_args(name), BATCH, seed=43)
    train, trainer, batch = train_steps(model, host, HF_STEPS, {"A1": 1},
                                        f"learn {name}", model_name=name,
                                        falling=False)
    if not all(torch.isfinite(p).all() for p in model.parameters()):
        fail(f"{name}: a parameter is not finite after {HF_STEPS} steps")
    res["train"] = train
    res["train_profile"] = profile_calls(lambda: trainer.train_step(batch),
                                         1, "step")
    del model, trainer, batch
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as d:
        data = os.path.join(d, "data")
        os.makedirs(data)
        write_tempstock(data, HF_DATA_ROWS, seed=44, seq=HF_SEQ[name])
        argv = ["-rid", "smoke", "-mn", name, "-nec", str(ENCODERS),
                "--seq_len", str(HF_SEQ[name]), "--data_dir", data, "-ne",
                "1", "-tb", str(BATCH), "-fp", d, "-lrst", "constant"]
        reset_counts()
        results = in_loop_train.main(argv)
        counts = read_counts()
        trainer = results["trainer"]
        steps = trainer.optimizer.step_count
        check_counts(counts, {"A1": steps}, f"cli.in_loop_train -mn {name}")
        loss = results["history"][0]["train_loss"]
        if (steps != HF_STEPS or not np.isfinite(loss)
                or results["checkpoint"] is None):
            fail(f"cli.in_loop_train -mn {name}: {steps} steps, loss {loss},"
                 f" checkpoint {results['checkpoint']}")
        rows = {k: v[:BATCH] for k, v in host.items() if k != "y"}
        trained = Predictor(trainer.model, name, batch_size=BATCH)(rows)
        del trainer, results["trainer"]
        torch.cuda.empty_cache()
        reset_counts()
        served = Predictor(build_model(hf_args(name)), name,
                           checkpoint_path=results["checkpoint"],
                           batch_size=BATCH)(rows)
        check_counts(read_counts(), {}, f"serving {name}")
    same = bool(np.array_equal(trained, served))
    print(f"cli.in_loop_train -mn {name} --data_dir ({HF_DATA_ROWS} rows, "
          f"s={HF_SEQ[name]}): {steps} steps, loss {loss:.5f}, launches "
          f"{counts}; Predictor from its checkpoint: probabilities "
          f"{'equal' if same else 'DIFFER'}", flush=True)
    if not (same and served.shape == (BATCH, 2)
            and ((served > 0) & (served < 1)).all()):
        fail(f"{name}: Predictor(checkpoint_path=...) served {served}, the "
             f"trained model {trained}")
    res["cli"] = {"steps": steps, "launches": counts,
                  "history": results["history"], "test": results["test"]}
    torch.cuda.empty_cache()
    return steps


def tweet_eval_through_cli(res):
    """cli.tweet_eval: bertweet at s=128, batch 16, TWEET_EVAL_EPOCHS epochs
    of the synthetic set, one A1 a step and no other launch; its mean step
    latency."""
    from meant_tpu_torch.cli import tweet_eval
    argv = ["-rid", "smoke", "-nec", str(ENCODERS), "--synthetic_n",
            str(VQA_CLI_ROWS), "-tb", str(BATCH), "-ne",
            str(TWEET_EVAL_EPOCHS)]
    reset_counts()
    results = tweet_eval.main(argv)
    counts = read_counts()
    trainer = results["trainer"]
    steps = trainer.optimizer.step_count
    check_counts(counts, {"A1": steps}, "cli.tweet_eval")
    losses = [h["train_loss"] for h in results["history"]]
    if len(losses) != TWEET_EVAL_EPOCHS or not np.all(np.isfinite(losses)):
        fail(f"cli.tweet_eval: epochs {losses}")
    ms = [t * 1e3 for t in trainer.latencies]
    res["tweet_eval"] = {"steps": steps, "launches": counts,
                         "history": results["history"], "step_ms": ms,
                         "step_ms_mean": float(np.mean(ms)),
                         "step_ms_median": statistics.median(ms[1:])}
    print(f"cli.tweet_eval: {steps} steps over {TWEET_EVAL_EPOCHS} epochs, "
          f"losses {losses}, mean step latency {np.mean(ms):.3f} ms (median "
          f"of steps 2-{steps} {statistics.median(ms[1:]):.3f} ms)",
          flush=True)
    del results, trainer
    torch.cuda.empty_cache()


def run_hf_vqa(record) -> dict:
    """Phase 13: meant_vqa's training at bench.py's geometry, cli.vqa, the
    HF baselines through cli.in_loop_train and Predictor, and
    cli.tweet_eval; A1 at each new parameter count. Returns what the
    timing rows report."""
    t0 = time.perf_counter()
    res = {}
    record["hf_vqa"] = res
    vqa = res.setdefault("meant_vqa", {})
    out = {"vqa_train": learn_vqa(vqa), "vqa_cli": vqa_through_cli(vqa)}
    out["a1"] = {"meant_vqa": (vqa["n_params"],
                               vqa["train"]["launches"]["A1"],
                               check_adamw(vqa, vqa["n_params"]))}
    for name in HF_SEQ:
        r = res.setdefault(name, {})
        steps = hf_baseline(name, r)
        out["a1"][name] = (r["n_params"],
                           r["train"]["launches"]["A1"] + steps,
                           check_adamw(r, r["n_params"]))
    tweet_eval_through_cli(res)
    res["wall_s"] = time.perf_counter() - t0
    print(f"phase hf_vqa: {res['wall_s']:.1f} s", flush=True)
    return out


# ---- phase 7: timing ---------------------------------------------------

def attention_cost(c, backward: bool = False) -> tuple:
    """(bytes, flops) the launch must move and compute. Forward: q, k, v
    read, o written, QK^T and P@V. Backward: q, k, v, dO read, dq, dk, dv
    written, and five products (S, dP, dV, dQ, dK). Tables and mask read
    once; products over the (row, key) pairs the causal fill keeps
    (min(row + 1, s_k) a row) or all s_q s_k."""
    q, k = c["q"], c["k"]
    bh = q.shape[0] * q.shape[1]
    s, s_k, d = c["s"], c["s_k"], q.shape[-1]
    nbytes = ((3 * q.numel() + 4 * k.numel()) if backward
              else (2 * q.numel() + 2 * k.numel())) * q.element_size()
    nbytes += sum(t.numel() * 4 for t in c["tables"])
    if c["mask"] is not None:
        nbytes += c["mask"].numel() * 4
    pairs = (sum(min(r + 1, s_k) for r in range(s)) if c["causal"]
             else s * s_k)
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


def resident_rows(c, label, fwd_launches, bwd_launches, r1_launches,
                  fwd_err, bwd_err, rot_err) -> list:
    """The three rows of one resident shape: R1 + K1 (K1 alone beside it)
    against rotation + SDPA, K2 (R1 + K2 beside it) against the SDPA
    backward, and R1; each with its launches on the main path, its error
    against the plain version, its bound and its plain version's time."""
    rows = []
    nbytes, flops = attention_cost(c)
    with_r1 = event_ms(lambda: run_kernel(c), iters=20)
    rotate_case(c)
    k1_ms = event_ms(lambda: run_k1(c), iters=20)
    library_ms = event_ms(lambda: run_library(c), iters=20)
    print(f"resident forward at {label}: R1 + K1 {with_r1:.4f} ms "
          f"(K1 alone {k1_ms:.4f} ms) against rotation + SDPA's "
          f"{library_ms:.4f} ms ({with_r1 / library_ms:.2f}x)", flush=True)
    rows.append(kernel_row(
        f"flash_fwd[{label}]", "meant_tpu_torch/csrc/flash_fwd.cu",
        "meant_tpu/ops/flash/kernel.py:89", fwd_launches, fwd_err, with_r1,
        event_ms(lambda: run_plain(c), iters=5), library_ms, nbytes, flops,
        PEAK_BF16_FLOPS, shape=list(c["q"].shape), s_k=c["s_k"],
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
        "meant_tpu/ops/flash/kernel.py:321", bwd_launches, bwd_err, k2_ms,
        event_ms(lambda: run_bwd_plain(c), iters=3), library_ms, nbytes,
        flops, PEAK_BF16_FLOPS, shape=list(c["q"].shape), s_k=c["s_k"],
        dtype="bfloat16", r1_plus_k2_ms=with_r1))
    print(f"resident backward at {label}: K2 {k2_ms:.4f} ms, R1 + K2 "
          f"{with_r1:.4f} ms against the SDPA backward's "
          f"{library_ms:.4f} ms ({with_r1 / library_ms:.2f}x)", flush=True)
    nbytes, flops = rotation_cost(c)
    r1_ms = event_ms(lambda: rotate_case(c), iters=20)
    print(f"rotation pass at {label}: R1 {r1_ms:.4f} ms", flush=True)
    rows.append(kernel_row(
        f"rotate_qk[{label}]", "meant_tpu_torch/csrc/flash_bwd_online.cu",
        "meant_tpu/ops/flash/kernel.py:340", r1_launches, rot_err, r1_ms,
        event_ms(lambda: rotate_plain(c), iters=5), None, nbytes, flops,
        PEAK_FP32_FLOPS, shape=list(c["q"].shape), s_k=c["s_k"],
        dtype="bfloat16", library_call=None))
    del library
    torch.cuda.empty_cache()
    return rows


def time_kernels(record, errors, launches_by_shape, bwd_errors,
                 train_counts, a1_err, n_params, paper, pretrain, zoo,
                 hf_vqa):
    """The resident rows (R1 + K1, K2, R1) at the flagship's two shapes, at
    the paper generation's s=128, at the pretrainers' BH=128 shapes, at
    meant_tweet_price's s=128, meant_mosi's s=50 (xPos on 30 features,
    BH=128), meant_vqa's s=40 and s=196 at BH=512 and the VQA CLI's s=24,
    each with its own path's launches (the pretrainers' and meant_vqa's
    forwards are those of their steps), then A1 at each path's parameter
    count."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = []
    flagship = {launch_key(k): n for k, n in launches_by_shape.items()}
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
             mim["K1_by_shape"], mim),
            ("text_s128", "text", "s128 causal xPos meant_tweet_price",
             zoo["tweet_price"][0]["K1_by_shape"], zoo["tweet_price"][1]),
            ("text_s50_rot30", "text_rot30",
             "s50 causal xPos rot30 BH128 meant_mosi",
             zoo["mosi"][0]["K1_by_shape"], zoo["mosi"][1]),
            ("text_s40_bh512", "text", "s40 causal xPos BH512 meant_vqa",
             hf_vqa["vqa_train"]["K1_by_shape"], hf_vqa["vqa_train"]),
            ("vision_bh512", "vision", "s196 pixel rotary BH512 meant_vqa",
             hf_vqa["vqa_train"]["K1_by_shape"], hf_vqa["vqa_train"]),
            ("text_s24_bh128", "text", "s24 causal xPos BH128 cli.vqa",
             hf_vqa["vqa_cli"]["K1_by_shape"], hf_vqa["vqa_cli"])):
        s, bh = {name: (s, bh) for name, _, s, bh in RESIDENT_CASES}[case]
        c = backward_case(kind, torch.bfloat16, gen, s=s, bh=bh)
        key = shape_key(c["s"], c["causal"])
        rows += resident_rows(
            c, label, fwd_by_shape.get(key, 0),
            steps["K2_by_shape"].get(key, 0),
            steps["R1_by_shape"].get(f"s{c['s']}", 0),
            errors[f"{case}/bfloat16"], bwd_errors[f"{case}/bfloat16"],
            bwd_errors[f"{case}/bfloat16/rot"])

    rows.append(adamw_row("adamw", n_params, train_counts["A1"], a1_err,
                          gen))
    rows.append(adamw_row("adamw[meant]", paper["n_params"],
                          paper["train"]["A1"], paper["a1_err"], gen))
    for kind, counts in (("mlm", mlm), ("mim", mim)):
        rows.append(adamw_row(f"adamw[{kind}]", pretrain[kind]["n_params"],
                              counts["A1"], pretrain[kind]["a1_err"], gen))
    rows.append(adamw_row("adamw[meant_timesformer]", zoo["n_params"],
                          zoo["timesformer"]["A1"], zoo["a1_err"], gen))
    for name, (count, launches, err) in hf_vqa["a1"].items():
        rows.append(adamw_row(f"adamw[{name}]", count, launches, err, gen))
    record["kernels"] = rows
    return rows


def adamw_row(name, n_params, launches, err, gen, mu_bf16=False):
    """A1 over n_params (with a bf16 first moment when mu_bf16): its ms,
    its plain version's and torch.optim.AdamW(fused=True)'s (fp32
    moments: torch has no bf16 one)."""
    from meant_tpu_torch.ops.adamw import (adamw_reference, update_scalars,
                                           adamw_update)
    p, g, m, v = adamw_case(n_params, gen)
    if mu_bf16:
        m = m.to(torch.bfloat16)
    norm = torch.linalg.vector_norm(g)
    h = update_scalars(coupled=False, mu_bf16=mu_bf16,
                       **{k: v_ for k, v_ in ADAMW_ARGS.items()
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
        library_ms, (24 if mu_bf16 else 28) * n_params, 20 * n_params,
        PEAK_FP32_FLOPS, params=n_params, dtype="float32",
        m_dtype="bfloat16" if mu_bf16 else "float32")
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
    n = c["q"].numel() + c["k"].numel()
    nbytes = (2 * n * c["q"].element_size()
              + sum(t.numel() * 4 for t in c["tables"]))
    return nbytes, 3 * n


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


def time_long_kernels(long_errors, long_counts, bh=LONG_TIME_BH,
                      small_bh=LONG_CHECK_BH, tag="long",
                      label="s4096 causal xPos", **shape):
    """R1 + K3, R1, K4 and K5 at the main path's launch (BH=80, s=4096,
    bf16, causal xPos; or the BH and head dim given): ms per launch,
    bound, plain version, and the yardstick: rotation + causal SDPA (R1 +
    K3 together; K3 alone beside it), its backward (R1, K4 and K5
    together); R1 has no single PyTorch call of its own."""
    gen = torch.Generator(device="cuda").manual_seed(9)
    big = long_case("text", torch.bfloat16, gen, bh, **shape)
    small = long_case("text", torch.bfloat16, gen, small_bh, **shape)
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
         run_online_plain, f"{tag}_text/bfloat16/out", library_fwd, 10),
        ("K4", "flash_bwd_dq", "meant_tpu_torch/csrc/flash_bwd_online.cu",
         "meant_tpu/ops/flash/kernel.py:456", run_online_dq_kernel,
         run_online_dq_plain, f"{tag}_text/bfloat16/dq", library_bwd, 5),
        ("K5", "flash_bwd_dkdv", "meant_tpu_torch/csrc/flash_bwd_online.cu",
         "meant_tpu/ops/flash/kernel.py:527", run_online_dkdv_kernel,
         run_online_dkdv_plain, (f"{tag}_text/bfloat16/dk",
                                 f"{tag}_text/bfloat16/dv"), library_bwd, 5))
    for (kernel, name, source, replaces, run, plain, err_keys, library_ms,
         iters) in plans:
        ms = event_ms(lambda: run(big), iters=iters)
        extra = {}
        if kernel == "K3":     # the row is R1 + K3; K3 alone beside it
            extra["k3_alone_ms"] = event_ms(lambda: run_online_k3(big),
                                            iters=iters)
            print(f"streaming forward at {label}: R1 + K3 "
                  f"{ms:.4f} ms (K3 alone {extra['k3_alone_ms']:.4f} ms) "
                  f"against rotation + causal SDPA's {library_ms:.4f} ms "
                  f"({ms / library_ms:.2f}x)", flush=True)
        plain_ms, plain_bh = plain_ms_fitting(plain, big, small, iters=2)
        torch.cuda.empty_cache()
        keys = err_keys if isinstance(err_keys, tuple) else (err_keys,)
        nbytes, flops = long_cost(big, kernel)
        rows.append(kernel_row(
            f"{name}[{label}]", source, replaces,
            long_counts[kernel], max(long_errors[k] for k in keys), ms,
            plain_ms, library_ms, nbytes, flops, PEAK_BF16_FLOPS,
            shape=shape, dtype="bfloat16", plain_bh=plain_bh, **extra,
            library_call=("rotation + scaled_dot_product_attention"
                          if kernel == "K3" else
                          "backward of rotation + scaled_dot_product_"
                          "attention (dq, dk, dv: K4 and K5 together)")))
    nbytes, flops = rotation_cost(big)
    rows.insert(1, kernel_row(
        f"rotate_qk[{label}]",
        "meant_tpu_torch/csrc/flash_bwd_online.cu",
        "meant_tpu/ops/flash/kernel.py:152", long_counts["R1"],
        long_errors[f"{tag}_text/bfloat16/rot"],
        event_ms(lambda: rotate_case(big), iters=20),
        event_ms(lambda: rotate_plain(big), iters=5), None, nbytes, flops,
        PEAK_FP32_FLOPS, shape=shape, dtype="bfloat16",
        library_call=None))
    backward = sum(r["ms"] for r in rows[1:4])
    print(f"streaming backward at {label}: R1 + K4 + K5 "
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
    # the wgmma bodies are K4/K5 at <false, D>, K2 at <true, D> (kStats)
    if "flash_bwd" in low and ("online" in low or "<false," in low):
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
    zoo = run_zoo(record)
    shapes = run_shapes(record, record["n_params"])
    hf_vqa = run_hf_vqa(record)
    rows = time_kernels(record, errors, by_shape, bwd_errors, train_counts,
                        a1_err, record["n_params"], paper, pretrain, zoo,
                        hf_vqa)
    at = [r["name"] for r in rows].index("adamw")
    rows[at:at] = time_long_kernels(long_errors, long_counts)  # before A1
    rows += time_shapes(shapes, record["n_params"])
    record["kernels"] = rows
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
