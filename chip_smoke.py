#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (meant_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--out DIR]

Phases, run in the order 1-6, 9-17, 7, 8; any failure
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
14. ner   -- token classification and the last harnesses, where A1 is
              the one kernel (RoBERTa's attention is plain, as in JAX; no
              R1 or K1-K5 launch): bench.py's ner cell (TokenClassifier 768
              wide, 12 layers, vocab 64001, 9 tags, s=256, batch 32, bf16)
              8 ner_trainer steps on one batch, one A1 with no norm a step,
              a finite, falling loss, a profiled step; cli.hug_train -mn
              roberta_tweet -nc 15 (1024 wide, 24 layers, 16 heads, vocab
              50265, s=128, -tb 16) --pretrained from a roberta_tweet.bin
              written here (the backbone bit for bit before the first
              step), one epoch and a checkpoint; cli.tweet7 --crf
              --impl_crf -nc 15 (768, 12 layers, 8 heads) one epoch, its
              rows decoded under the BIO mask with no forbidden
              transition, the CRF's NLL and decode beside a step;
              cli.checkpoint_train then --epoch 1 (epoch 1's checkpoint bit
              for bit before the first step); cli.in_loop_genia -js 2,
              cli.hug_pretrain_mlm with and without --fixed_loss,
              cli.hug_train -t classification -mn bertweet,
              cli.run_other_models -mn meant_tweet and cli.train_legacy on
              .npz shards, one A1 a step each; a hub-layout
              vinai/bertweet-base (3 safetensors shards, the word table in
              bf16, written by this script's own writer) grafted by
              cli.in_loop_train --hf_cache into -mn bertweet --num_heads 12
              and -mn meant, bit for bit, then one epoch each; A1 against
              its plain version at the two new parameter counts, clipped
              and with no norm.
15. buckets -- the host data path at the flagship's width (fixed_proj=
              True), bench.py's src_bucketed geometry: R1 + K1 and R1 + K2
              at s=256 and 384 causal xPos, BH=640, fp32 and bf16, against
              their plain versions; 256 rows (16 replicated) of 64-512
              tokens drawn from RandomState(7) through BucketedLoader(
              shuffle=True), buckets 128 / 256 / 384 / 512 (rows and steps
              per bucket asserted; a bucket that cannot fill a batch
              fails), two epochs of meant_trainer.train() with exactly 24
              R1, 12 K1 and 12 K2 at the bucket's s and 12 each at 196 and
              1 A1 a step, the loss finite and falling over the second
              epoch; the same rows at s=512 only beside them (samples/s);
              one profiled step of each bucket and of its rows at s=512
              (busy, wall, idle share); a step under
              utils.observability.profile_trace, whose trace must name K1
              and K2; checkpoint.save(block=False) then an A1 step at once:
              the file holds the pre-step parameters and moments bit for
              bit; each bucket's step gradients at 2 encoders against the
              plain attention; cli.in_loop_train -mn meant --flash true
              --seq_len 128 --data_dir --buckets 32,64,96,128 on 80
              TempStock-small rows of 10-128 tokens (exact launches by
              bucket, the background save restoring bit for bit, the
              confusion PNG drawn or skipped as matplotlib is present)
              and cli.eval; Prefetcher(workers=4) over charts read from an
              np.memmap equal to workers=1, a worker's error raised in the
              consumer; the native collate library built.
16. layouts -- the parallel layouts at one card, over a world-1 NCCL
              process group started in this process: the flagship
              (fixed_proj=True, batch 16) trained 3 steps by the plain
              meant_trainer, with make_mesh() and with fsdp=True from the
              same weights under torch.use_deterministic_algorithms, each
              with exactly 24 R1, 12 K1 at s=512 and 12 at s=196, 24 K2
              and 1 A1 a step, the losses and parameters bit for bit the
              plain run's;
              Predictor(tensor_parallel=True) on a (1, 1) (data, model)
              mesh answering one 16-row request with exactly 24 R1 + 24
              K1, bit for bit the plain Predictor; ring_attend at one
              rank bit for bit flash_mha(force_online=True); then 4 ranks
              of src4096's attention ((10, 8, 4096, 96) bf16, causal, xPos
              at global positions, chunks of 1024) played in this process
              by shifts that index the chunks: exactly 16 R1 + 16 K3
              forward and 16 R1 + 16 K4 + 16 K5 backward at (80, 1024,
              96), the lse cotangent nonzero at the 9 chunks at or before
              each rank's own but rank 0's lone diagonal one (whose lse its
              output does not depend on); the output against the unsplit
              R1 + K3, the
              plain ring in fp32 and the ring's plain engine at
              BF16_REL_L2, the gradients against the plain engine at
              RING_PLAIN_GRAD_REL_L2 (its own forward's out and lse carry
              K3's bf16 difference into the backward) and against the
              plain backward on the kernels' forward at BWD_BF16_REL_L2,
              the fp32 case against the plain ring at
              FP32_RTOL / FP32_ATOL; the played ring's forward and backward
              times beside the unsplit R1 + K3 and R1 + K4 + K5, and the
              world-1 all_reduce, reduce_scatter and all_gather of the
              flagship's flat buffer; R1 + K3, R1, K4 and K5 against
              their plain versions at the ring's chunk shape (BH=16,
              s=1024, not causal).
17. head dims -- the flash path at every head dim: odd d, where the
              rotation pairs lane d-1 with lane 0 and the backwards'
              adjoint wraps, and d past 128, which the wide bodies of
              csrc/flash_wide.cuh take (the contraction streamed over the
              width, the output in groups of 64-column chunks on a grid
              axis) but in bf16 for every kernel at 192, 256 and 384 and
              for K1 and K3 at 768 (their sliced ring), which run wgmma
              bodies built at those widths (HGMMA counted in each, in
              phase 12), and for K2, K4 and K5 at 768 (an even d), which
              run the chain body (S and dP on fp32 FMA chains, the
              products on wgmma; K4 + K5 one call on the main path). R1 +
              K1 and K2 through flash_mha at d = 7, 95, 130,
              192, 256, 257, 384 and 768 (s=200, BH=16, causal xPos with a
              key mask, and plain), one launch of each a call, fp32 and
              bf16 at the bars in force, R1 bit for bit at the padded
              width, and at an odd
              d the wrap term of column d-1 of dq and dk reproduced; R1 +
              K3, K4 and K5 through flash_mha(return_lse=True) at d = 95,
              192 and 384 (s=4096, BH=4). meant_src --num_heads 4 (768
              wide, 4 heads of 192) serves 40 rows against flash=False
              (24 R1 + 24 K1 a request), one step's gradients against the
              plain attention and 5 steps (24 R1, 24 K1, 24 K2, 1 A1 a
              step, falling loss); --num_heads 2 and 1 (d = 384, 768) a
              request and 2 steps each (at 768 the s=512 text tower
              streams, as JAX's rule routes it: R1 + K3, R1 + K4 + K5);
              src4096 at 4, 3 and 2 heads and 2 encoders a request (2 K3,
              2 K1, 4 R1) and 2 steps, at 4 and 2 heads 3 steps at full
              depth (12 K3, K4, K5 a step); --text_dim 760 (8 heads of 95) a request
              against flash=False, one step's gradients and 2 steps;
              --num_heads 3 (d = 256) a request and 2 steps; the 4-rank
              ring played at (10, 4, 4096, 192); R1 + K3, K4 and K5 at the
              main path's shapes past 128 ((20, 4096, 384) among them),
              K4 + K5 in one call on the chain body at (80, 512, 768),
              with and without a key mask, bit for bit K4 and K5 apart.
              Rows of the kernel line at d = 192 (s=512, 196,
              4096), 256 (s=512, 196, 4096), 384 (s=512, 196, 4096), 768
              (s=196, 512) and 95 (s=512).
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
              13's parameter counts, and with no norm at phase 14's; phase
              12's shapes, and A1 with a bf16 first moment); R1 + K1 and K2 also at meant_vqa's s=40 and
              s=196 (BH=512), the VQA CLI's s=24 and phase 15's s=256
              and 384 (BH=640); R1 + K3, R1, K4 and K5 at phase 16's
              ring chunk (BH=80, s=1024, not causal);
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
import functools
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


@functools.lru_cache(maxsize=None)
def _sass_sections(path: str) -> tuple:
    """The SASS of the library at `path` by cuobjdump, one section per
    kernel function, its mangled name on the first line (read once)."""
    from meant_tpu_torch.cuda_build import find_nvcc
    tool = os.path.join(os.path.dirname(find_nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", path], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    return tuple(sass.split("Function : ")[1:])


def count_hgmma(name: str, function: str = "") -> int:
    """wgmma instructions (HGMMA) in the SASS of the built csrc/<name>.cu,
    or only in its kernel functions whose (mangled) name holds `function`,
    by cuobjdump; fails when there are none."""
    from meant_tpu_torch.cuda_build import _library_path
    sections = [sec for sec in _sass_sections(str(_library_path(name)))
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
                    causal=False, s=s, s_k=s_k, kind=kind)
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
                causal=causal, s=s, s_k=s, kind=kind)


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
    """Yardstick only: the rotation in PyTorch (the lanes' rotate-half at
    an odd head dim), then torch's fused SDPA."""
    from meant_tpu_torch.ops.flash.kernel import rotate_half_lanes
    from meant_tpu_torch.ops.rotary import rotate_half
    qcos, qsin, kcos, ksin = c["tables"]
    half = rotate_half_lanes if c["q"].shape[-1] % 2 else rotate_half

    def rot(t, cos, sin):
        tf = t.to(torch.float32)
        return (tf * cos + half(tf) * sin).to(t.dtype)

    return torch.nn.functional.scaled_dot_product_attention(
        rot(c["q"], qcos, qsin), rot(c["k"], kcos, ksin), c["v"],
        is_causal=c["causal"], scale=c["scale"])


def rel_l2(out, ref) -> float:
    ref = ref.float()
    return ((out.float() - ref).norm() / ref.norm()).item()


def hold(kernel, label, g, a, b, dtype, out_bar, unit=1.0):
    """One output of a kernel against its plain version at the bars in
    force: fp32 FP32_RTOL / FP32_ATOL; bf16 BF16_TOL per element (the
    gradients' absolute part BWD_BF16_ATOL) and a relative L2 bar
    (`out_bar` for out, BWD_BF16_REL_L2 for a gradient); absolute parts
    times `unit`. Returns (max abs err, rel L2)."""
    from meant_tpu_torch.ops.flash.kernel import (BWD_BF16_ATOL,
                                                  BWD_BF16_REL_L2)
    err = (a.float() - b.float()).abs().max().item()
    rel = rel_l2(a, b)
    if dtype == torch.float32:
        ok = torch.allclose(a, b, rtol=FP32_RTOL, atol=FP32_ATOL * unit)
    elif g == "out":
        ok = (torch.allclose(a.float(), b.float(), rtol=BF16_TOL,
                             atol=BF16_TOL * unit) and rel <= out_bar)
    else:
        ok = (torch.allclose(a.float(), b.float(), rtol=BF16_TOL,
                             atol=BWD_BF16_ATOL * unit)
              and rel <= BWD_BF16_REL_L2)
    ok = ok and bool(torch.isfinite(a).all())
    print(f"{kernel} vs plain {label} {g}: max_abs_err {err:.3e} rel_l2 "
          f"{rel:.3e} (|ref| max {b.abs().max().item():.3e}, atol unit "
          f"{unit:.3g}) {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail(f"{kernel} disagrees with its plain version ({label} {g}, max "
             f"abs err {err}, rel L2 {rel})")
    return err, rel


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


def check_kernel(record, cases=RESIDENT_CASES, key="kernel_vs_plain"):
    """R1 + K1 (flash_mha's resident forward) against flash_mha_reference
    at the main paths' shapes and the masked text case (or at `cases`,
    recorded under `key`), fp32 and bf16."""
    from meant_tpu_torch.ops.flash.kernel import K1_BF16_REL_L2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    errors, rels = {}, {}
    for case, kind, s, bh in cases:
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
    record[f"{key}_max_abs_err"] = errors
    record[f"{key}_rel_l2"] = rels
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


def check_backward(record, cases=RESIDENT_CASES, key="k2_vs_plain"):
    """K2 against flash_mha_bwd_reference at the main paths' shapes (and the
    masked text case; or at `cases`, recorded under `key`), fp32 and bf16,
    gradient by gradient."""
    from meant_tpu_torch.ops.flash.kernel import (BWD_BF16_ATOL,
                                                  BWD_BF16_REL_L2)
    gen = torch.Generator(device="cuda").manual_seed(2)
    errors, rels = {}, {}
    for case, kind, s, bh in cases:
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
    record[f"{key}_max_abs_err"] = errors
    record[f"{key}_rel_l2"] = rels
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


def run_online_k45(c):
    """K4 + K5 as the main path launches them (`_backward_online`): one
    call (`flash_bwd_dq_dkdv`), which forms S and dP once where the chain
    body takes them and else launches K4, then K5; returns (dq, dk, dv),
    each (b, h, s, d)."""
    from meant_tpu_torch.ops.flash import flash_bwd_dq_dkdv
    grads = flash_bwd_dq_dkdv(*_online_bwd_args(c), scale=c["scale"],
                              causal=c["causal"], num_heads=c["q"].shape[1])
    return [g.reshape(c[n].shape) for g, n in zip(grads, "qkk")]


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


def long_case(kind, dtype, gen, bh, s=LONG_SEQ, **shape):
    """One text-tower launch of src4096 (s=4096, causal xPos; or the
    length s given, and kind "vision" for a launch that is not causal)
    with dO;
    `text_masked` has a padding mask of a random length per batch row (at
    least one key). A batch row with every key masked is checked by
    tests/test_torch_cuda.py with the pixel rotary: under causal xPos at
    s=4096 its dq sums terms up to some 300 in size, where one bf16 step
    of a dS entry moves an element by 0.6 (PERF.md). lse and delta for the
    backward come from the plain forward and carry a non-zero lse
    cotangent: delta = rowsum(dO * out) - g_lse."""
    c = backward_case(kind, dtype, gen, s=s, bh=bh, **shape)
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
    from meant_tpu_torch.ops.flash.kernel import (BF16_REL_L2,
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
                kernel = {"out": "K3", "dq": "K4"}.get(g, "K5")
                errors[f"{name}/{g}"], rels[f"{name}/{g}"] = hold(
                    kernel, name, g, a, want[g], dtype, BF16_REL_L2)
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


def check_adamw(record, n: int, clip: bool = True) -> float:
    """A1 against adamw_reference on the card over n parameters, AdamW and
    coupled Adam, clipped to norm 1 or (clip=False, the NER trainer's
    default) with no norm; max relative error of p, m and v."""
    from meant_tpu_torch.ops.adamw import (adamw_reference, update_scalars,
                                           adamw_update)
    gen = torch.Generator(device="cuda").manual_seed(3)
    worst_abs, worst_rel = 0.0, 0.0
    for coupled in (False, True):
        p, g, m, v = adamw_case(n, gen)
        ref = [t.clone() for t in (p, m, v)]
        norm = torch.linalg.vector_norm(g) if clip else None
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
            label = (("Adam (coupled)" if coupled else "AdamW")
                     + ("" if clip else ", no clip"))
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

def build_flagship(seq: int = SEQ, text_dim: int = DIM, **kw):
    """The flagship meant_src; at seq > 512 the fusion projection is
    max(512, seq) wide, as bench.py's build_src makes it; text_dim widens
    or narrows the language tower and its embedding (--text_dim)."""
    from meant_tpu_torch.models import EmbeddingConfig, meant_src
    kw.setdefault("num_encoders", ENCODERS)
    kw.setdefault("num_heads", HEADS)
    return meant_src(text_dim=text_dim, image_dim=DIM, price_dim=5,
                     height=IMAGE, width=IMAGE, patch_res=PATCH, lag=LAG,
                     num_classes=2,
                     embedding=EmbeddingConfig(hidden_size=text_dim),
                     channels=3,
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


def write_tempstock(path: str, n: int, seed: int, seq: int = PAPER_SEQ,
                    min_len: int = None):
    """A TempStock-small set at full shape in its layout: graphs_5.npy (n,
    5, 4, 224, 224) fp32, tweets_5.npy (n, 5, seq) int64 (128 tokens a day
    unless `seq` says otherwise) with trailing pad id 1 where
    attention_masks_5.npy is 0, macds_5.npy (n, 5, 4) and
    y_resampled_5.npy (n,). Each day holds 1-seq tokens, or with `min_len`
    each row's last day min_len-seq tokens and its other days
    min_len up to that many (a row's content length spread evenly)."""
    import os
    rng = np.random.default_rng(seed)
    if min_len is None:
        lengths = rng.integers(1, seq + 1, size=(n, LAG))
    else:
        top = rng.integers(min_len, seq + 1, size=(n, 1))
        lengths = np.minimum(rng.integers(min_len, seq + 1, size=(n, LAG)),
                             top)
        lengths[:, -1] = top[:, 0]
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
    from meant_tpu_torch.ops.flash.kernel import HEAD_DIMS, K1_BF16_REL_L2
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
                kernel = "R1 + K1" if g == "out" else "R1 + K2"
                errors[f"{label}/{g}"], rels[f"{label}/{g}"] = hold(
                    kernel, label, g, a, b, dtype, K1_BF16_REL_L2,
                    group_unit(name, b))
            del c, got, want
            torch.cuda.empty_cache()
    record["shapes_vs_plain_max_abs_err"] = errors
    record["shapes_vs_plain_rel_l2"] = rels
    return errors


def count_new_hgmma() -> dict:
    """wgmma in every instantiation at head dims 64 and 128: K1, K3 (the
    forward body), K2's two kernels and K4 + K5; and at 192 and 256 (the
    bf16 bodies past d = 128) in K3's, K2's dq and dk/dv and K4's and K5's
    own, each apart; K1's at 192, 256, 384 and 768 and K3's at 384 and 768
    (the forwards' body, on its sliced ring past 256), each apart; the
    sliced dq and dk/dv kernels at 384 of K2 and of K4 and K5, and the
    chain body's products at 768 in K2's library and in K4's and K5's."""
    counts = {}
    for d in (64, 128):
        for label, lib, function in (
                ("K1", "flash_fwd", f"flash_fwd_wgmma_kernelILi{d}E"),
                ("K3", "flash_fwd", f"flash_fwd_lse_wgmma_kernelILi{d}E"),
                ("K2", "flash_bwd", f"ILb1ELi{d}E"),
                ("K4+K5", "flash_bwd_online", f"ILb0ELi{d}E")):
            counts[f"{label} d{d}"] = count_hgmma(lib, function)
    for d in WIDE_WGMMA_DIMS:
        counts[f"K3 d{d}"] = count_hgmma(
            "flash_fwd", f"flash_fwd_lse_wgmma_kernelILi{d}E")
        for label, lib, kernel, stats in (
                ("K2 dq", "flash_bwd", "dq", 1),
                ("K2 dk/dv", "flash_bwd", "dkdv", 1),
                ("K4", "flash_bwd_online", "dq", 0),
                ("K5", "flash_bwd_online", "dkdv", 0)):
            function = f"flash_bwd_{kernel}_wgmma_kernelILb{stats}ELi{d}E"
            counts[f"{label} d{d}"] = count_hgmma(lib, function)
    for label, function, widths in (
            ("K1", "flash_fwd_wgmma_kernel", FWD_WGMMA_DIMS),
            ("K3", "flash_fwd_lse_wgmma_kernel", SLICED_DIMS)):
        for d in widths:
            counts[f"{label} d{d}"] = count_hgmma(
                "flash_fwd", f"{function}ILi{d}E")
    for label, lib, kernel, stats in (
            ("K2 dq", "flash_bwd", "dq", 1),
            ("K2 dk/dv", "flash_bwd", "dkdv", 1),
            ("K4", "flash_bwd_online", "dq", 0),
            ("K5", "flash_bwd_online", "dkdv", 0)):
        counts[f"{label} d384"] = count_hgmma(
            lib, f"flash_bwd_{kernel}_sliced_kernelILb{stats}ELi384E")
    for label, lib in (("K2", "flash_bwd"), ("K4+K5", "flash_bwd_online")):
        counts[f"{label} chain products d768"] = count_hgmma(
            lib, "chain_products_kernel")
    return counts


def src_launches(heads: int, train: bool) -> dict:
    """The launches of one meant_src forward (or training step) at the
    flagship's width and `heads` heads: each tower's 12 encoders take the
    path `uses_online` picks at its length and head dim, as JAX's rule
    does (resident: R1 + K1, and K2; streaming: R1 + K3, and R1 + K4 + K5;
    at d = 768 the text tower's s=512 streams). 24 R1 + 24 K1 a forward,
    24 R1, 24 K1, 24 K2 and 1 A1 a step up to d = 384."""
    from meant_tpu_torch.ops.flash import uses_online
    want = {"A1": 1} if train else {}
    for s in (SEQ, N_PATCHES):
        if uses_online(s, DIM // heads):
            names = ("R1", "K3") + (("R1", "K4", "K5") if train else ())
        else:
            names = ("R1", "K1") + (("K2",) if train else ())
        for name in names:
            want[name] = want.get(name, 0) + ENCODERS
    return want


def serve_src_heads(res, heads: int, rows: int, compare: bool):
    """build_model(-mn meant_src --num_heads heads --flash true) at the
    flagship's width serves `rows` rows in requests of BATCH (exactly
    `src_launches` a request: 24 R1 + 24 K1 up to d = 384); with `compare`,
    the towers and probabilities of one request against the same weights
    at flash=False."""
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
    want = {name: -(-rows // BATCH) * n
            for name, n in src_launches(heads, False).items()}
    print(f"served {label}: {rows} rows, launches {counts}", flush=True)
    check_counts(counts, want, f"serving {label}")
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
    `steps` trainer steps with exactly `src_launches` a step (24 R1, 24 K1,
    24 K2 and 1 A1 up to d = 384; a falling loss past 2 steps)."""
    serve = serve_src_heads(res, heads, rows, compare=grads)
    model = build_flagship(flash=True, fixed_proj=True, num_heads=heads)
    step = src_launches(heads, True)
    if grads:
        res["step_gradients"] = compare_step_gradients(
            model, to_card(train_batch(GRAD_ROWS, seed=6)),
            {k: n for k, n in step.items() if k != "A1"},
            lambda: build_flagship(flash=False, fixed_proj=True,
                                   num_heads=heads),
            f"meant_src --num_heads {heads} train step")
    res["train"], _, _ = train_steps(
        model, train_batch(BATCH, seed=7), steps, step,
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


def run_long_heads(res, heads: int = SRC6_HEADS):
    """src4096 at --num_heads `heads` (6: d = 128; 4: d = 192) with
    LONG_GRAD_ENCODERS encoders a tower, the streaming path at that head
    dim from the user's entry points: one request of LONG_BATCH rows
    through Predictor (exactly 2 K3 + 2 K1 + 4 R1) and 2 trainer steps (2
    K3, 2 K1, 6 R1, 2 K4, 2 K5, 2 K2 and 1 A1 a step)."""
    from meant_tpu_torch.serve import Predictor
    n = LONG_GRAD_ENCODERS
    model = build_flagship(LONG_SEQ, flash=True, fixed_proj=True,
                           num_heads=heads, num_encoders=n)
    predictor = Predictor(model, "meant_src", batch_size=LONG_BATCH)
    rows = request_batch(LONG_BATCH, seed=50, seq=LONG_SEQ)
    predictor(rows)     # warm-up
    torch.cuda.synchronize()
    reset_counts()
    probs = predictor(rows)
    torch.cuda.synchronize()
    counts = read_counts()
    print(f"served src4096 --num_heads {heads} at {n} encoders: "
          f"launches {counts}", flush=True)
    check_counts(counts, {"K3": n, "K1": n, "R1": 2 * n},
                 f"serving src4096 at {heads} heads")
    if not (np.isfinite(probs).all() and ((probs > 0) & (probs < 1)).all()):
        fail(f"bad src4096 probabilities at {heads} heads")
    res["serve_launches"] = counts
    del predictor
    res["train"], _, _ = train_steps(
        model, train_batch(LONG_BATCH, seed=51, seq=LONG_SEQ), 2,
        {"K3": n, "K1": n, "R1": 3 * n, "K4": n, "K5": n, "K2": n, "A1": 1},
        f"learn src4096 --num_heads {heads}", falling=False)
    del model
    torch.cuda.empty_cache()
    return {"R1": counts["R1"] + res["train"]["launches"]["R1"],
            **{k: res["train"]["launches"][k] for k in ("K4", "K5")},
            "K3": counts["K3"] + res["train"]["launches"]["K3"],
            "serve": counts, "steps": res["train"]["launches"]}


def time_shapes(out, n_params) -> list:
    """The rows of the new shapes: R1 + K1, K2 and R1 at d = 64 (s=512 and
    196, BH = 960), d = 128 (s=512, BH = 480) and the TimeSformer group
    (256 x 257, d = 64, BH = 640), each with the launches of the run that
    reaches it (meant_src --num_heads 12, --num_heads 6, meant_timesformer
    --image_size 256); R1 + K3, R1, K4 and K5 at src4096's launch at 6
    heads (BH = 60, d = 128) with the launches of that drive; A1 with a
    bf16 first moment at the flagship's count."""
    gen = torch.Generator(device="cuda").manual_seed(15)
    rows = []
    for name, label, (serve, steps) in (
            ("text_d64", "s512 causal xPos d64", out["src12"]),
            ("vision_d64", "s196 pixel rotary d64", out["src12"]),
            ("text_d128", "s512 causal xPos d128", out["src6"]),
            ("group_256x257", "s256x257 d64 TimeSformer group",
             out["timesformer"])):
        c = shape_case(name, torch.bfloat16, gen)
        d = c["q"].shape[-1]
        key = shape_key(c["s"], c["causal"], c["s_k"], d)
        rows += resident_rows(
            c, label, serve["K1_by_shape"].get(key, 0),
            steps["K2_by_shape"].get(key, 0),
            steps["R1_by_shape"].get(r1_key(c["s"], c["s_k"], d), 0))
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
    check_shapes(res)
    out = {"long_errors": check_long_kernels(
        res, bh=LONG6_BH, kinds=("text",), tag="long_d128", seed=13, d=128,
        heads=SRC6_HEADS)}
    out["src12"] = run_src_heads(res.setdefault("src_heads12", {}),
                                 SRC12_HEADS, REQUEST_ROWS, SRC12_STEPS, True)
    out["src6"] = run_src_heads(res.setdefault("src_heads6", {}),
                                SRC6_HEADS, BATCH, 2, False)
    out["timesformer"] = run_timesformer_256(
        res.setdefault("timesformer_256", {}))
    out["long6"] = run_long_heads(res.setdefault("long_heads6", {}))
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


# ---- phase 14: token classification, the last harnesses, HF caches ------

# bench.py's ner cell (build_ner, bench.py:472-502): TokenClassifier 768
# wide, 12 layers of 12 heads, vocab 64001, 9 tags, bf16 with fp32 params,
# s=256, batch 32, about 45% of the positions labelled (never the first or
# the last), ner_trainer's lr 5e-5 unclipped; 8 steps on the one batch, cut
# from a benchmark's run length. Adam's first update is lr times the sign
# of every gradient entry, so over 134M parameters the loss rises for a
# step or two before it falls (tools/ner_first_steps.py): 3 steps would not
# see it fall.
NER_BATCH, NER_SEQ, NER_TAGS, NER_STEPS = 32, 256, 9, 8
NER_CLI_ROWS = 64          # the harnesses' synthetic sets (--synthetic_n)
CACHE_ROWS = 32            # the --hf_cache runs: 19 train rows, one step
# `hug_train -mn roberta_tweet` at its config's widths (1024 wide, 24
# layers of 16 heads, vocab 50265, 15 tags), s=128, -tb 16
ROBERTA_TWEET = {"vocab_size": 50265, "hidden_size": 1024,
                 "num_hidden_layers": 24, "num_attention_heads": 16}
# vinai/bertweet-base's geometry, whose cache the phase writes
BERTWEET = {"model_type": "roberta", "vocab_size": 64001,
            "hidden_size": DIM, "num_hidden_layers": ENCODERS,
            "num_attention_heads": 12, "intermediate_size": 4 * DIM,
            "max_position_embeddings": 130, "type_vocab_size": 1,
            "pad_token_id": 1}
CRF_TIMING_ITERS = 5
# HF RoBERTa names -> the port's RobertaModel names, in this order
HF_TO_PORT = (("embeddings.LayerNorm", "embeddings.layer_norm"),
              ("attention.self.", "attention."),
              ("attention.output.dense", "attention.out"),
              ("attention.output.LayerNorm", "attention_norm"),
              ("intermediate.dense", "intermediate"),
              ("output.dense", "output"),
              ("output.LayerNorm", "output_norm"),
              ("encoder.layer.", "layer_"), ("pooler.dense", "pooler"))


def ner_batch() -> dict:
    """bench.py's build_ner batch, drawn in its order."""
    b, s = NER_BATCH, NER_SEQ
    rng = np.random.RandomState(0)
    labels = rng.randint(0, NER_TAGS, size=(b, s)).astype(np.int32)
    labels[rng.rand(b, s) >= 0.45] = -100
    labels[:, 0] = -100
    labels[:, -1] = -100
    return {"input_ids": rng.randint(2, 64000, size=(b, s)).astype(np.int32),
            "attention_mask": np.ones((b, s), np.float32),
            "labels": labels}


def learn_ner(res) -> int:
    """NER_STEPS ner_trainer steps at bench.py's ner geometry on one
    replayed batch: one A1 (with no norm) a step and no other launch, a
    finite, falling loss; a profiled step. Returns the A1 launches."""
    from meant_tpu_torch.data.loader import ArrayLoader
    from meant_tpu_torch.train.ner import TokenClassifier, ner_trainer
    model = TokenClassifier(num_labels=NER_TAGS, vocab_size=64001,
                            hidden_size=DIM, num_layers=ENCODERS,
                            num_heads=12, dtype=torch.bfloat16,
                            device="cuda", seed=0)
    res["n_params"] = sum(p.numel() for p in model.parameters())
    host = ner_batch()
    trainer = ner_trainer({"model": model,
                           "train_data": ArrayLoader(host, NER_BATCH),
                           "lrst": "constant", "seed": 0})
    train, trainer, batch = timed_steps(trainer, host, NER_STEPS, {"A1": 1},
                                        "learn ner (bench.py's ner cell)")
    if trainer.optimizer.clip_norm is not None:
        fail("ner_trainer clips its gradient")
    res["train"] = train
    res["train_profile"] = profile_calls(lambda: trainer.train_step(batch),
                                         1, "step", rows=NER_BATCH)
    del model, trainer, batch
    torch.cuda.empty_cache()
    return train["launches"]["A1"]


def cli_run(label: str, main, argv, res) -> dict:
    """main(argv) with the counts set to 0 just before and read just after:
    exactly one A1 a step and no other launch, at least one step, a finite
    first-epoch loss. Returns the results."""
    reset_counts()
    results = main(argv)
    counts = read_counts()
    steps = results["trainer"].optimizer.step_count
    check_counts(counts, {"A1": steps}, label)
    loss = results["history"][0]["train_loss"]
    if steps < 1 or not np.isfinite(loss):
        fail(f"{label}: {steps} steps, loss {loss}")
    res[label] = {"steps": steps, "launches": counts,
                  "history": results["history"],
                  "checkpoint": results.get("checkpoint")}
    print(f"{label}: {steps} steps, loss {loss:.5f}, launches {counts}",
          flush=True)
    return results


def host_ms(fn, iters: int = CRF_TIMING_ITERS) -> float:
    """Median host-clock ms of fn(), the device synchronized around each
    call (one warm-up call first)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def tweet7_crf(res, d: str):
    """cli.tweet7 --crf --impl_crf -nc 15 at the CLI's widths: one epoch
    (one A1 a step); every row of its set decoded by viterbi under the BIO
    mask takes no transition the mask forbids; the CRF's NLL (forward and
    backward) and decode beside a whole step, and a profiled step."""
    from meant_tpu_torch.cli import in_loop_genia, tweet7
    from meant_tpu_torch.data.loader import host_tensor
    argv = ["-rid", "smoke", "--crf", "--impl_crf", "-nc", "15", "-tb",
            str(BATCH), "-ne", "1", "--synthetic_n", str(NER_CLI_ROWS),
            "-fp", d]
    results = cli_run("cli.tweet7 --crf --impl_crf", tweet7.main, argv, res)
    trainer = results["trainer"]
    model, cm = trainer.model, trainer.constraint_mask
    if cm is None:
        fail("cli.tweet7 -nc 15 decodes without the BIO mask")
    data = in_loop_genia.load_data(tweet7.tweet7_parser().parse_args(argv))
    T = model.crf.num_tags
    for i in range(0, NER_CLI_ROWS, BATCH):
        ids = host_tensor(data["input_ids"][i:i + BATCH]).cuda()
        mask = host_tensor(data["attention_mask"][i:i + BATCH]).cuda()
        paths, _ = model.decode(ids, mask, constraint_mask=cm)
        for row, m in zip(paths.cpu().numpy(), mask.cpu().numpy()):
            tags = row[m > 0]
            if not (cm[T, tags[0]] and cm[tags[-1], T + 1]
                    and all(cm[a, b] for a, b in zip(tags, tags[1:]))):
                fail(f"viterbi decoded a forbidden path {tags.tolist()}")
    batch = {k: host_tensor(v[:BATCH]).cuda() for k, v in data.items()}
    with torch.no_grad():
        model.eval()
        emissions = model.token_classifier(batch["input_ids"],
                                           batch["attention_mask"])
    leaf = emissions.float().requires_grad_(True)
    crf = model.crf
    timing = {
        "step_ms": host_ms(lambda: trainer.train_step(batch)),
        "nll_fwd_bwd_ms": host_ms(lambda: crf.neg_log_likelihood(
            leaf, batch["labels"], batch["attention_mask"]).backward()),
        "decode_ms": host_ms(lambda: crf.viterbi(
            emissions, batch["attention_mask"], constraint_mask=cm))}
    timing["crf_share_of_step"] = timing["nll_fwd_bwd_ms"] / \
        timing["step_ms"]
    res["crf"] = timing
    res["crf_step_profile"] = profile_calls(
        lambda: trainer.train_step(batch), 1, "step")
    print(f"CRF at b={BATCH}, s={PAPER_SEQ}, 15 tags (host clock, "
          f"synchronized, median of {CRF_TIMING_ITERS}): "
          f"{json.dumps(timing)}", flush=True)
    del results, trainer, model, batch
    torch.cuda.empty_cache()


def checkpoint_resume(res, d: str):
    """cli.checkpoint_train one epoch, then --epoch 1: before its first step
    the model holds epoch 1's checkpoint bit for bit; it trains on."""
    from meant_tpu_torch.cli import checkpoint_train
    from meant_tpu_torch.cli.in_loop_genia import finish
    from meant_tpu_torch.train import checkpoint as ckpt
    argv = ["-rid", "smoke", "-ne", "1", "-tb", str(BATCH),
            "--synthetic_n", str(NER_CLI_ROWS), "-fp", d]
    first = cli_run("cli.checkpoint_train", checkpoint_train.main, argv,
                    res)
    saved = ckpt.restore(first["checkpoint"], "cuda")["params"]
    trainer, val_loader, nl = checkpoint_train.prepare(argv + ["--epoch",
                                                               "1"])
    trainer._init_state()
    now = trainer.model.state_dict()
    if not all(torch.equal(now[k], v) for k, v in saved.items()):
        fail("checkpoint_train --epoch 1 did not load epoch 1's checkpoint")
    cli_run("cli.checkpoint_train --epoch 1",
            lambda _: finish(trainer, val_loader, nl), None, res)
    print(f"checkpoint_train --epoch 1 resumed from "
          f"{os.path.basename(first['checkpoint'])} bit for bit", flush=True)
    del first, trainer, saved, now
    torch.cuda.empty_cache()


def write_legacy_shards(path: str):
    """Two .npz ticker shards of 16 TempStock-shaped rows at the CLI's
    widths."""
    from meant_tpu_torch.data.datasets import synthetic_tempstock
    for i in range(2):
        np.savez(os.path.join(path, f"ticker{i}.npz"), **synthetic_tempstock(
            n=BATCH, lag=LAG, seq=PAPER_SEQ, channels=4, size=IMAGE,
            vocab=64000))


def other_harnesses(res, d: str):
    """in_loop_genia -js 2, hug_pretrain_mlm with and without --fixed_loss,
    hug_train -t classification -mn bertweet, run_other_models -mn
    meant_tweet and train_legacy over .npz shards written here, each at its
    CLI defaults on a small synthetic set, on the card."""
    from meant_tpu_torch.cli import (hug_pretrain_mlm, hug_train,
                                     in_loop_genia, run_other_models,
                                     train_legacy)
    small = ["-ne", "1", "-tb", str(BATCH), "--synthetic_n",
             str(NER_CLI_ROWS), "-fp", d]
    cli_run("cli.in_loop_genia -js 2", in_loop_genia.main,
            ["-rid", "smoke", "-js", "2", *small], res)
    for extra in ([], ["--fixed_loss"]):
        cli_run(" ".join(["cli.hug_pretrain_mlm", *extra]),
                hug_pretrain_mlm.main,
                ["-rid", "smoke", "-b", str(BATCH), *small, *extra], res)
    cli_run("cli.hug_train -t classification -mn bertweet", hug_train.main,
            ["-rid", "smoke", "-t", "classification", "-mn", "bertweet",
             *small], res)
    out = cli_run("cli.run_other_models -mn meant_tweet",
                  run_other_models.main,
                  ["-rid", "smoke", "-mn", "meant_tweet", *small], res)
    if out["trainer"].seed != 42:
        fail("run_other_models did not pin seed 42")
    shards = os.path.join(d, "shards")
    os.makedirs(shards)
    write_legacy_shards(shards)
    cli_run("cli.train_legacy", train_legacy.main,
            ["-rid", "smoke", "--data_dir", shards, *small], res)
    torch.cuda.empty_cache()


def hf_roberta_state_dict(cfg: dict, seed: int) -> dict:
    """An HF RobertaModel state dict (no prefix, a pooler) at `cfg`'s
    geometry with a 130-row position table, drawn N(0, 0.02^2) on the card
    from `seed` (norm weights around 1), as CPU tensors."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    d, ff = cfg["hidden_size"], 4 * cfg["hidden_size"]

    def draw(*shape, base=0.0):
        return (base + 0.02 * torch.randn(shape, generator=gen,
                                          device="cuda")).cpu()

    sd = {"embeddings.word_embeddings.weight": draw(cfg["vocab_size"], d),
          "embeddings.position_embeddings.weight": draw(130, d),
          "embeddings.token_type_embeddings.weight": draw(1, d),
          "embeddings.LayerNorm.weight": draw(d, base=1.0),
          "embeddings.LayerNorm.bias": draw(d),
          "pooler.dense.weight": draw(d, d), "pooler.dense.bias": draw(d)}
    for i in range(cfg["num_hidden_layers"]):
        p = f"encoder.layer.{i}."
        for name, (n_out, n_in) in (
                ("attention.self.query", (d, d)),
                ("attention.self.key", (d, d)),
                ("attention.self.value", (d, d)),
                ("attention.output.dense", (d, d)),
                ("intermediate.dense", (ff, d)), ("output.dense", (d, ff))):
            sd[f"{p}{name}.weight"] = draw(n_out, n_in)
            sd[f"{p}{name}.bias"] = draw(n_out)
        for name in ("attention.output.LayerNorm", "output.LayerNorm"):
            sd[f"{p}{name}.weight"] = draw(d, base=1.0)
            sd[f"{p}{name}.bias"] = draw(d)
    return sd


def port_key(hf_key: str) -> str:
    for a, b in HF_TO_PORT:
        hf_key = hf_key.replace(a, b)
    return hf_key


def check_grafted(model, file_sd: dict, keys: dict, label: str) -> int:
    """Every `keys` entry (file key -> model key) of the model equals the
    file's tensor bit for bit (a bf16 tensor widened to fp32). Returns how
    many were held."""
    own = model.state_dict()
    for src, dst in keys.items():
        want = file_sd[src].to(device=own[dst].device, dtype=torch.float32)
        if not torch.equal(own[dst], want):
            fail(f"{label}: {dst} is not the file's {src}")
    print(f"{label}: {len(keys)} grafted tensors equal the file's bit for "
          f"bit before the first step", flush=True)
    return len(keys)


def roberta_tweet_pretrained(res, d: str) -> int:
    """cli.hug_train -mn roberta_tweet -nc 15 --pretrained true -cl DIR at
    the config's widths, from a roberta_tweet.bin written here (`roberta.`
    keys, a 130-row position table, a pooler the model has not): the
    backbone equals the file bit for bit before the first step, one epoch
    trains with one A1 a step and saves. Returns the parameter count."""
    from meant_tpu_torch.cli import hug_train
    from meant_tpu_torch.cli.in_loop_genia import finish
    sd = {f"roberta.{k}": v
          for k, v in hf_roberta_state_dict(ROBERTA_TWEET, 7).items()}
    path = os.path.join(d, "roberta_tweet.bin")
    t0 = time.perf_counter()
    torch.save(sd, path)
    write_s = time.perf_counter() - t0
    argv = ["-rid", "smoke", "-mn", "roberta_tweet", "-nc", "15",
            "--pretrained", "true", "-cl", d, "-tb", str(BATCH), "-ne", "1",
            "--synthetic_n", str(NER_CLI_ROWS), "-fp", d]
    t0 = time.perf_counter()
    _, trainer, test_loader, nl = hug_train.prepare(argv)
    trainer._init_state()
    load_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in trainer.model.parameters())
    held = check_grafted(trainer.model, sd, {
        k: port_key(k) for k in sd if "pooler" not in k},
        "hug_train --pretrained (roberta_tweet.bin)")
    del sd
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = cli_run("cli.hug_train -mn roberta_tweet",
                  lambda _: finish(trainer, test_loader, nl), None, res)
    peak = torch.cuda.max_memory_allocated()
    if out["checkpoint"] is None or not os.path.exists(out["checkpoint"]):
        fail("hug_train -mn roberta_tweet saved no checkpoint")
    steps = trainer.optimizer.step_count
    batch = to_card(next(iter(trainer.train_data)))
    res["roberta_tweet"] = {
        "n_params": n_params, "grafted": held, "peak_memory_bytes": peak,
        "bin_write_s": write_s, "graft_load_s": load_s, "steps": steps,
        "step_ms": host_ms(lambda: trainer.train_step(batch)),
        "step_profile": profile_calls(lambda: trainer.train_step(batch), 1,
                                      "step")}
    print(f"hug_train -mn roberta_tweet: {n_params} parameters, peak memory "
          f"{peak / 2 ** 30:.2f} GiB, the .bin written in {write_s:.1f} s "
          f"and grafted in {load_s:.1f} s, a step "
          f"{res['roberta_tweet']['step_ms']:.3f} ms (host clock)",
          flush=True)
    del out, trainer, batch
    torch.cuda.empty_cache()
    return n_params


def write_safetensors(path: str, tensors: dict):
    """The safetensors format, written here (no package): an 8-byte
    little-endian header length, the JSON header (dtype, shape, byte
    range of each tensor, padded with spaces to 8 bytes), the raw bytes."""
    import struct
    names = {torch.float32: "F32", torch.bfloat16: "BF16"}
    header, blobs, offset = {}, [], 0
    for name, t in tensors.items():
        t = t.contiguous().cpu()
        raw = (t.view(torch.uint16) if t.dtype == torch.bfloat16
               else t).numpy().tobytes()
        header[name] = {"dtype": names[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(raw)]}
        blobs.append(raw)
        offset += len(raw)
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for raw in blobs:
            f.write(raw)


def write_bertweet_cache(root: str, sd: dict, shards: int = 3):
    """vinai/bertweet-base in the hub layout: refs/main naming a snapshot
    with config.json, `shards` safetensors files and their index."""
    mdir = os.path.join(root, "models--vinai--bertweet-base")
    snap = os.path.join(mdir, "snapshots", "smoke")
    os.makedirs(snap)
    os.makedirs(os.path.join(mdir, "refs"))
    with open(os.path.join(mdir, "refs", "main"), "w") as f:
        f.write("smoke")
    with open(os.path.join(snap, "config.json"), "w") as f:
        json.dump(BERTWEET, f)
    keys = sorted(sd)
    per = -(-len(keys) // shards)
    weight_map = {}
    for i in range(shards):
        fname = f"model-{i + 1:05d}-of-{shards:05d}.safetensors"
        part = {k: sd[k] for k in keys[i * per:(i + 1) * per]}
        write_safetensors(os.path.join(snap, fname), part)
        weight_map.update({k: fname for k in part})
    with open(os.path.join(snap, "model.safetensors.index.json"), "w") as f:
        json.dump({"weight_map": weight_map}, f)


def hf_cache_grafts(res, d: str):
    """A hub-layout vinai/bertweet-base written here (3 safetensors shards,
    the word table in bf16) grafted by cli.in_loop_train --hf_cache into -mn
    bertweet --num_heads 12 (the whole backbone) and -mn meant (the
    embedding): bit for bit before the first step, then one epoch (one A1
    a step, no flash kernel at s=128)."""
    from meant_tpu_torch.cli import in_loop_train
    sd = hf_roberta_state_dict(BERTWEET, 8)
    words = "embeddings.word_embeddings.weight"
    sd[words] = sd[words].to(torch.bfloat16)
    root = os.path.join(d, "hub")
    write_bertweet_cache(root, sd)
    flows = {
        "bertweet": (["-mn", "bertweet", "--num_heads", "12"],
                     {k: "bertweet." + port_key(k) for k in sd}),
        "meant": (["-mn", "meant"],
                  {k: "embedding." + port_key(k)[len("embeddings."):]
                   for k in sd if k.startswith("embeddings.")})}
    for name, (extra, keys) in flows.items():
        argv = ["-rid", "smoke", *extra, "--hf_cache", root, "-ne", "1",
                "-tb", str(BATCH), "--synthetic_n", str(CACHE_ROWS), "-fp",
                d, "-lrst", "constant"]
        trainer = in_loop_train.prepare(argv)
        trainer._init_state()
        held = check_grafted(trainer.model, sd, keys,
                             f"in_loop_train -mn {name} --hf_cache")

        def train(_, trainer=trainer):
            results = trainer.train()
            results["trainer"] = trainer
            return results

        label = f"cli.in_loop_train -mn {name} --hf_cache"
        cli_run(label, train, None, res)
        res[label]["grafted"] = held
        del trainer
        torch.cuda.empty_cache()


def run_ner(record) -> dict:
    """Phase 14: bench.py's ner cell through ner_trainer; hug_train -mn
    roberta_tweet at 1024 x 24 from a pretrained .bin; tweet7's CRF; the
    other harnesses; the hub cache grafted by --hf_cache; A1 at the two new
    parameter counts, clipped and with no norm. Returns what the timing
    rows report."""
    t0 = time.perf_counter()
    res = {}
    record["ner"] = res
    ner = res.setdefault("bench_ner", {})
    launches = learn_ner(ner)
    cli = res.setdefault("cli", {})
    with tempfile.TemporaryDirectory() as d:
        n_tweet = roberta_tweet_pretrained(cli, d)
        tweet7_crf(cli, d)
        checkpoint_resume(cli, d)
        other_harnesses(cli, d)
        hf_cache_grafts(cli, d)
    out = {"a1": {}}
    for name, n, steps in (("ner", ner["n_params"], launches),
                           ("roberta_tweet", n_tweet,
                            cli["roberta_tweet"]["steps"])):
        err = max(check_adamw(res.setdefault(f"a1 {name}", {}), n),
                  check_adamw(res.setdefault(f"a1 {name} no clip", {}), n,
                              clip=False))
        out["a1"][name] = (n, steps, err)
    res["wall_s"] = time.perf_counter() - t0
    print(f"phase ner: {res['wall_s']:.1f} s", flush=True)
    return out


# ---- phase 15: length-bucketed training and the host data path ----------

# bench.py's src_bucketed cell (bench.py:242-292): the flagship fed by the
# BucketedLoader at b=16 over n=256 rows (16 rows replicated) whose
# content lengths are drawn uniform 64-512 from RandomState(7)
# (meant_tpu_torch/configs/length_hist_uniform64_512.json), buckets 128 /
# 256 / 384 / 512; the text tower runs causal xPos at the bucket's length.
BUCKETS = (128, 256, 384, 512)
BUCKET_ROWS = 256
BUCKET_EPOCHS = 2          # the loss must fall over the second
BUCKET_GRAD_ENCODERS = 2   # the plain attention's step at 12 is not needed
BUCKET_CASES = (("text_s256", "text", 256, MAIN_BH),
                ("text_s384", "text", 384, MAIN_BH))
# the CLI on 80 TempStock-small rows whose longest day holds 10-128 tokens:
# 48 training rows over four buckets of 32 tokens, batches of 4
BUCKET_CLI_ARGS = ["--buckets", "32,64,96,128"]
BUCKET_CLI_BATCH = 4
BUCKET_CLI_MIN_LEN = 10
PREFETCH_ROWS = 64         # charts read from a memmap: 193 MB
PREFETCH_WORKERS = 4


def bucketed_rows() -> dict:
    """bench.py's src_bucketed rows: the learn phase's 16 rows replicated
    to BUCKET_ROWS, with `attention_masks` of RandomState(7)'s lengths on
    every day. meant_src reads `attention_mask`, which these rows lack, as
    bench.py's do: the flash path drops the mask either way."""
    base = train_batch(BATCH, seed=1)
    del base["attention_mask"]
    data = {k: np.repeat(v, BUCKET_ROWS // BATCH, axis=0)
            for k, v in base.items()}
    lengths = np.random.RandomState(7).randint(64, SEQ + 1,
                                               size=BUCKET_ROWS)
    data["attention_masks"] = np.ascontiguousarray(np.broadcast_to(
        (np.arange(SEQ)[None, None, :] < lengths[:, None, None]),
        (BUCKET_ROWS, LAG, SEQ))).astype(np.float32)
    return data


def bucket_step_want(s: int, encoders: int = ENCODERS) -> dict:
    """The launches of one training step at text length s: R1, K1 and K2
    once per encoder of each tower (text at s causal xPos, charts at 196),
    one A1."""
    shapes = {shape_key(s, True): encoders,
              shape_key(N_PATCHES, False): encoders}
    return {"R1": 2 * encoders, "K1": 2 * encoders, "K2": 2 * encoders,
            "A1": 1, "K3": 0, "K4": 0, "K5": 0, "K1_by_shape": shapes,
            "K2_by_shape": dict(shapes),
            "R1_by_shape": {f"s{s}": encoders, f"s{N_PATCHES}": encoders}}


def count_delta(before: dict, after: dict) -> dict:
    """read_counts() after minus before, by-shape entries that moved only."""
    out = {}
    for k, v in after.items():
        if isinstance(v, dict):
            moved = {kk: n - before[k].get(kk, 0) for kk, n in v.items()}
            out[k] = {kk: n for kk, n in moved.items() if n}
        else:
            out[k] = v - before[k]
    return out


def counted_steps(trainer, log: list):
    """trainer.train_step, synchronized, appending (s, ms, launches) of
    each step to `log`."""
    step = trainer.train_step

    def counted(batch):
        s = batch["input_ids"].shape[-1]
        before = read_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step(batch)
        torch.cuda.synchronize()
        log.append((s, (time.perf_counter() - t0) * 1e3,
                    count_delta(before, read_counts())))
        return out
    return counted


def check_step_log(log, label):
    for i, (s, _, got) in enumerate(log):
        want = bucket_step_want(s)
        if got != want:
            fail(f"{label}: step {i} at s={s} launched {got}, want {want}")


def bucket_batch(data, rows, s):
    """The rows `rows` of `data` with the sequence arrays cut to s."""
    return {k: (v[rows][..., :s] if k in ("input_ids", "attention_masks")
                else v[rows]) for k, v in data.items()}


def bucketed_epochs(res, data):
    """BUCKET_EPOCHS epochs of meant_trainer.train() on BucketedLoader(
    shuffle=True): rows and steps per bucket, exact launches by shape each
    step, a finite loss falling over the second epoch; beside the second
    epoch's samples/s, those of the same rows at s=512 only (every step
    then costs what a 512-bucket step costs). Returns the trainer, the
    loader and the epochs' launch counts."""
    from meant_tpu_torch.data.loader import BucketedLoader
    from meant_tpu_torch.train.classify import meant_trainer
    loader = BucketedLoader(data, BATCH, buckets=BUCKETS, shuffle=True)
    rows_by = {b: len(ix) for b, ix in loader.index.items()}
    steps_by = {b: n // BATCH for b, n in rows_by.items()}
    lengths = data["attention_masks"].sum(-1).max(-1)
    want_rows = {b: sum(1 for n in lengths
                        if n <= b and not any(n <= c for c in BUCKETS
                                              if c < b))
                 for b in BUCKETS}
    if rows_by != want_rows:
        fail(f"BucketedLoader's rows by bucket {rows_by}, want {want_rows}")
    # a bucket too thin for one batch would drop out of the epoch, and the
    # length mix measured would not be the one labelled (bench.py:279-287)
    thin = {b: n for b, n in rows_by.items() if n < BATCH}
    if thin or sorted(rows_by) != list(BUCKETS):
        fail(f"buckets {thin} cannot fill one batch of {BATCH} (rows by "
             f"bucket {rows_by})")
    print(f"BucketedLoader: rows by bucket {rows_by}, steps by bucket "
          f"{steps_by} ({len(loader)} a epoch)", flush=True)
    model = build_flagship(flash=True, fixed_proj=True)
    log = []
    with tempfile.TemporaryDirectory() as d:
        trainer = meant_trainer({
            "model": model, "model_name": "meant_src",
            "train_loader": loader, "epochs": BUCKET_EPOCHS,
            "lrst": "constant", "lr": LEARN_LR, "seed": 0,
            "test_model": False, "file_path": d, "run_id": "buckets"})
        trainer.train_step = counted_steps(trainer, log)
        reset_counts()
        t0 = time.perf_counter()
        results = trainer.train()
        epochs_s = time.perf_counter() - t0
        counts = read_counts()
    del trainer.train_step           # the class's own method again
    check_step_log(log, "the bucketed epochs")
    per_epoch = len(loader)
    for b in BUCKETS:
        n = sum(1 for s, _, _ in log if s == b)
        if n != steps_by[b] * BUCKET_EPOCHS:
            fail(f"bucket {b} ran {n} steps, want "
                 f"{steps_by[b] * BUCKET_EPOCHS}")
    losses = [h["train_loss"] for h in results["history"]]
    print(f"bucketed epochs: {len(log)} steps in {epochs_s:.1f} s, epoch "
          f"losses {losses}; launches {counts}", flush=True)
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        fail(f"the bucketed epochs' loss is not finite and falling: "
             f"{losses}")
    second = log[per_epoch:]
    ms_by = {b: statistics.median(ms for s, ms, _ in second if s == b)
             for b in BUCKETS}
    bucketed_rate = BATCH * len(second) / sum(ms for _, ms, _ in second) \
        * 1e3
    full_rate = BATCH / ms_by[SEQ] * 1e3     # the work bucketing saves
    print(f"second bucketed epoch: {bucketed_rate:.2f} samples/s (host "
          f"clock, synchronized steps; median step ms by bucket {ms_by}); "
          f"the same rows at s=512 only: {full_rate:.2f} samples/s; "
          f"{bucketed_rate / full_rate:.2f}x", flush=True)
    res.update({"rows_by_bucket": rows_by, "steps_by_bucket": steps_by,
                "epoch_losses": losses, "launches": counts,
                "step_ms_median_by_bucket": ms_by,
                "bucketed_samples_per_s": bucketed_rate,
                "s512_only_samples_per_s": full_rate,
                "step_log": [(s, ms) for s, ms, _ in log]})
    return trainer, loader, counts


def profile_buckets(trainer, loader, data, res):
    """One profiled step of each bucket and of the same rows at s=512, and
    one step under the port's profile_trace, whose trace must name K1 and
    K2."""
    from meant_tpu_torch.utils.observability import profile_trace
    prof = {}
    for b in BUCKETS:
        rows = loader.index[b][:BATCH]
        for s in ((b, SEQ) if b != SEQ else (SEQ,)):
            batch = to_card(bucket_batch(data, rows, s))
            print(f"bucket {b} rows at s={s}:", flush=True)
            p = profile_calls(lambda: trainer.train_step(batch), 1,
                              "step")
            prof[f"bucket{b}_s{s}"] = {
                k: p[k] for k in ("wall_ms_per_step",
                                  "device_busy_ms_per_step",
                                  "device_idle_share",
                                  "by_kind_ms_per_step")}
    res["profile"] = prof
    batch = to_card(bucket_batch(data, loader.index[256][:BATCH], 256))
    with tempfile.TemporaryDirectory() as d:
        with profile_trace(d):
            trainer.train_step(batch)
        files = [f for f in os.listdir(d) if f.endswith(".json")]
        if len(files) != 1:
            fail(f"profile_trace wrote {files}")
        with open(os.path.join(d, files[0])) as f:
            events = json.load(f)["traceEvents"]
    kinds = {_kind(e.get("name", "")) for e in events}
    named = [k for k in ("flash_fwd (K1)", "flash_bwd (K2)") if k in kinds]
    print(f"profile_trace: {len(events)} events, names {named}", flush=True)
    if len(named) != 2:
        fail(f"profile_trace's trace names {named} of K1 and K2")
    res["trace_events"] = len(events)


def background_save(trainer, batch, res):
    """save(block=False), one more A1 step at once, wait_for_saves: the
    checkpoint holds the parameters and moments of before the step, bit
    for bit."""
    from meant_tpu_torch.train import checkpoint as ckpt
    opt = trainer.optimizer
    before = {"params": {k: v.detach().clone() for k, v in
                         trainer.model.state_dict().items()},
              "m": opt.m.clone(), "v": opt.v.clone()}
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "checkpoint")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ckpt.save(path, {"params": trainer.model.state_dict(),
                         "opt_state": opt.state_dict()}, block=False,
                  lane="params")
        return_ms = (time.perf_counter() - t0) * 1e3
        trainer.train_step(batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ckpt.wait_for_saves()
        wait_ms = (time.perf_counter() - t0) * 1e3
        saved = ckpt.restore(path)
    same = (all(torch.equal(saved["params"][k], v.cpu())
                for k, v in before["params"].items())
            and torch.equal(saved["opt_state"]["m"], before["m"].cpu())
            and torch.equal(saved["opt_state"]["v"], before["v"].cpu()))
    moved = not torch.equal(opt.m, before["m"])
    print(f"background save: returned in {return_ms:.1f} ms (host "
          f"snapshot), written {wait_ms:.1f} ms after the next step; the "
          f"checkpoint is the pre-step state bit for bit: {same}; the step "
          f"moved the moments: {moved}", flush=True)
    if not (same and moved):
        fail("the background save does not hold the state of before the "
             "next A1 step")
    res["background_save"] = {"return_ms": return_ms, "wait_ms": wait_ms}


def buckets_through_cli(res):
    """cli.in_loop_train -mn meant --flash true --data_dir --buckets on
    TempStock-small rows of 10-128 tokens: R1 + K1 and K2 at each bucket
    that got a batch, exactly; the background save restores to the
    trained parameters bit for bit; the confusion PNG drawn, or skipped
    where matplotlib is missing; cli.eval gives the test confusion."""
    import importlib.util
    from meant_tpu_torch.cli import eval as eval_cli
    from meant_tpu_torch.cli import in_loop_train
    from meant_tpu_torch.data.loader import BucketedLoader
    from meant_tpu_torch.train import checkpoint as ckpt
    with tempfile.TemporaryDirectory() as d:
        data = os.path.join(d, "data")
        os.makedirs(data)
        write_tempstock(data, PAPER_DATA_ROWS, seed=17,
                        min_len=BUCKET_CLI_MIN_LEN)
        argv = PAPER_ARGV + ["--data_dir", data, "-ne", "1", "-tb",
                             str(BUCKET_CLI_BATCH), "-fp", d, "-lrst",
                             "constant", "-l", str(LEARN_LR)] \
            + BUCKET_CLI_ARGS
        reset_counts()
        results = in_loop_train.main(argv)
        counts = read_counts()
        trainer = results["trainer"]
        loader = trainer.train_loader
        if not isinstance(loader, BucketedLoader):
            fail(f"--buckets gave the trainer a {type(loader).__name__}")
        steps_by = {b: len(ix) // BUCKET_CLI_BATCH
                    for b, ix in loader.index.items()}
        steps = sum(steps_by.values())
        forwards = len(trainer.val_loader) + len(trainer.test_loader)
        text = {shape_key(b, True): ENCODERS * n
                for b, n in steps_by.items() if n}
        want_k2 = dict(text, **{shape_key(N_PATCHES, False):
                                ENCODERS * steps})
        want_k1 = dict(want_k2)
        want_k1[shape_key(PAPER_SEQ, True)] = \
            want_k1.get(shape_key(PAPER_SEQ, True), 0) + ENCODERS * forwards
        want_k1[shape_key(N_PATCHES, False)] += ENCODERS * forwards
        got = {"K1": counts["K1_by_shape"], "K2": counts["K2_by_shape"],
               "A1": counts["A1"]}
        print(f"cli.in_loop_train --buckets: steps by bucket {steps_by}, "
              f"{forwards} evaluation forwards at s={PAPER_SEQ}; launches "
              f"{got}", flush=True)
        if (got != {"K1": want_k1, "K2": want_k2, "A1": steps}
                or counts["K3"] or counts["K4"] or counts["K5"]
                or counts["R1"] != counts["K1"] or len(text) < 2):
            fail(f"the bucketed CLI launched {counts}, want K1 {want_k1}, "
                 f"K2 {want_k2}, A1 {steps}")
        if results["checkpoint"] is None:
            fail("the bucketed CLI saved no checkpoint")
        saved = ckpt.restore(results["checkpoint"], "cuda")["params"]
        live = trainer.model.state_dict()
        if set(saved) != set(live) or not all(
                torch.equal(saved[k], v) for k, v in live.items()):
            fail("the background save does not restore to the trained "
                 "parameters")
        png = os.path.join(d, "output_files", trainer.dataset, "plots",
                           f"confusion_meant_{trainer.run_id}.png")
        plotted = os.path.exists(png)
        if plotted != (importlib.util.find_spec("matplotlib") is not None):
            fail(f"confusion PNG written: {plotted}, matplotlib present: "
                 f"{not plotted}")
        metrics = eval_cli.main(argv + ["-ptm", results["checkpoint"]])
        if metrics["confusion"] != results["test"]["confusion"]:
            fail(f"cli.eval's confusion {metrics['confusion']} is not the "
                 f"trainer's {results['test']['confusion']}")
    print(f"cli.in_loop_train --buckets: checkpoint restores bit for bit, "
          f"confusion PNG {'written' if plotted else 'skipped'}, cli.eval "
          f"gives the test confusion {metrics['confusion']}", flush=True)
    res["cli"] = {"steps_by_bucket": steps_by, "launches": counts,
                  "png": plotted, "test": results["test"]}
    del trainer, results
    torch.cuda.empty_cache()


def prefetch_memmap(res):
    """Prefetcher(workers=4) over a loader of charts read from an
    np.memmap delivers workers=1's batches in its order, bit for bit on
    the card; an error raised in a worker reaches the consumer."""
    from meant_tpu_torch.data.loader import ArrayLoader, Prefetcher
    rng = np.random.RandomState(3)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "graphs.npy")
        np.save(path, rng.randn(PREFETCH_ROWS, LAG, 3, IMAGE, IMAGE).astype(
            np.float32))
        arrays = {"pixels": np.load(path, mmap_mode="r"),
                  "input_ids": rng.randint(2, 64000, (PREFETCH_ROWS, LAG,
                                                      SEQ)).astype(np.int32),
                  "y": rng.randint(0, 2, PREFETCH_ROWS).astype(np.int32)}

        def epoch(workers):
            loader = ArrayLoader(arrays, BATCH, shuffle=True, seed=5)
            t0 = time.perf_counter()
            out = [{k: v.cpu() for k, v in b.items()}
                   for b in Prefetcher(loader, "cuda", workers=workers)]
            return out, (time.perf_counter() - t0) * 1e3

        one, one_ms = epoch(1)
        many, many_ms = epoch(PREFETCH_WORKERS)
    same = len(one) == len(many) == PREFETCH_ROWS // BATCH and all(
        a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
        for a, b in zip(one, many))

    class Broken:
        def __len__(self):
            return 3

        def __iter__(self):
            yield {"x": np.zeros(4, np.float32)}
            yield {"x": np.array(["not a number"], dtype=object)}
            yield {"x": np.zeros(4, np.float32)}

    got, raised = [], None
    try:
        for b in Prefetcher(Broken(), "cuda", workers=PREFETCH_WORKERS):
            got.append(b)
    except TypeError as e:
        raised = e
    print(f"Prefetcher over a memmap: workers={PREFETCH_WORKERS} "
          f"{'equal to' if same else 'DIFFERS from'} workers=1 over "
          f"{len(one)} batches ({many_ms:.1f} vs {one_ms:.1f} ms an epoch); "
          f"a worker's error reached the consumer after {len(got)} "
          f"batch(es): {raised!r}", flush=True)
    if not same or raised is None or len(got) != 1:
        fail("Prefetcher(workers>1) does not deliver workers=1's batches "
             "in order, or swallows a worker's error")
    res["prefetch"] = {"workers": PREFETCH_WORKERS, "ms": many_ms,
                       "workers1_ms": one_ms}


def native_library(res):
    """The data path's C++ library builds and loads on this machine, and
    its tokenizer gives the numpy path's ids on space-split text."""
    from meant_tpu_torch import native
    if not native.available():
        fail("the native collate library does not build")
    texts = [f"w{i} tok{i % 7} $AAPL {'x' * (i % 5)}" for i in range(2000)]
    t0 = time.perf_counter()
    ids, mask = native.fnv1a_tokenize(texts, PAPER_SEQ, 64001)
    lib_ms = (time.perf_counter() - t0) * 1e3
    lib = native._lib
    native._lib = None                # the numpy path, once
    try:
        native._tried = True
        t0 = time.perf_counter()
        ref = native.fnv1a_tokenize(texts, PAPER_SEQ, 64001)
        numpy_ms = (time.perf_counter() - t0) * 1e3
    finally:
        native._lib = lib
    if not (np.array_equal(ids, ref[0]) and np.array_equal(mask, ref[1])):
        fail("the native tokenizer differs from its numpy path on "
             "space-split text")
    print(f"native library {native.library_path().name}: built; "
          f"{len(texts)} texts tokenized in {lib_ms:.2f} ms (numpy path "
          f"{numpy_ms:.2f} ms), the same ids", flush=True)
    res["native"] = {"library_ms": lib_ms, "numpy_ms": numpy_ms}


def run_buckets(record) -> dict:
    """Phase 15: R1 + K1 and R1 + K2 at the new bucket lengths, bucketed
    epochs of the flagship, profiles, a background save against the next
    A1 step, each bucket's gradients against the plain attention, the CLI
    with --buckets, the threaded Prefetcher and the native library."""
    t0 = time.perf_counter()
    res, marks = {}, {}
    record["buckets"] = res

    def mark(name):
        marks[name] = time.perf_counter() - t0 - sum(marks.values())

    check_kernel(res, BUCKET_CASES, "kernel_vs_plain")
    check_backward(res, BUCKET_CASES, "k2_vs_plain")
    mark("kernel checks")
    data = bucketed_rows()
    trainer, loader, counts = bucketed_epochs(res, data)
    mark("bucketed epochs")
    profile_buckets(trainer, loader, data, res)
    mark("profiles")
    background_save(trainer, to_card(bucket_batch(
        data, loader.index[384][:BATCH], 384)), res)
    del trainer
    torch.cuda.empty_cache()
    mark("background save")
    res["step_gradients"] = {}
    model = build_flagship(flash=True, fixed_proj=True,
                           num_encoders=BUCKET_GRAD_ENCODERS)
    plain = build_flagship(flash=False, fixed_proj=True,
                           num_encoders=BUCKET_GRAD_ENCODERS)
    want = {k: v for k, v in bucket_step_want(
        SEQ, BUCKET_GRAD_ENCODERS).items() if k in ("R1", "K1", "K2")}
    for b in BUCKETS:
        res["step_gradients"][b] = compare_step_gradients(
            model, to_card(bucket_batch(data, loader.index[b][:GRAD_ROWS],
                                        b)), want, lambda: plain,
            f"bucket s={b} step at {BUCKET_GRAD_ENCODERS} encoders")
    del model, plain
    torch.cuda.empty_cache()
    mark("gradients")
    buckets_through_cli(res)
    mark("CLI")
    prefetch_memmap(res)
    native_library(res)
    mark("prefetch and native")
    res["wall_s"] = time.perf_counter() - t0
    res["wall_s_by_part"] = marks
    print(f"phase buckets: {res['wall_s']:.1f} s ("
          + ", ".join(f"{k} {v:.1f}" for k, v in marks.items()) + ")",
          flush=True)
    return {"counts": counts}


def time_buckets(buckets) -> list:
    """The resident rows at the new bucket lengths, s=256 and 384 causal
    xPos at BH=640, with the bucketed epochs' launches."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    rows = []
    counts = buckets["counts"]
    for _, kind, s, bh in BUCKET_CASES:
        c = backward_case(kind, torch.bfloat16, gen, s=s, bh=bh)
        key = shape_key(s, True)
        rows += resident_rows(
            c, f"s{s} causal xPos bucket", counts["K1_by_shape"].get(key, 0),
            counts["K2_by_shape"].get(key, 0),
            counts["R1_by_shape"].get(f"s{s}", 0))
        del c
    return rows


# ---- phase 16: the parallel layouts at one card ----------------------

LAYOUT_STEPS = 3
LAYOUT_STEP = {"K1": 24, "R1": 24, "K2": 24, "A1": 1}
LAYOUT_K1_BY_SHAPE = {shape_key(SEQ, True): ENCODERS,
                      shape_key(N_PATCHES, False): ENCODERS}
# The world-1 layouts must equal the plain paths bit for bit: every
# collective is a copy and the arithmetic is the plain path's (the norm
# under FSDP is sqrt(|g|^2), which is |g| in binary floating point). The
# flagship's step itself repeats bit for bit only under
# torch.use_deterministic_algorithms: the default CUDA backward of the
# position and token-type embeddings (many repeats of few rows) sums in
# no fixed order (tools/step_determinism.py), so phase 16a runs in that
# mode.
RING_RANKS = 4             # the played ring: src4096's text attention
RING_CHUNK = LONG_SEQ // RING_RANKS
RING_BH = LONG_TIME_BH     # (10, 8, 4096, 96): 80 (b*lag, head) rows
RING_TIME_ITERS = 3


def layout_run(res, way, host, model=None, **extra):
    """The flagship (fixed_proj=True; `model` if given) trained
    LAYOUT_STEPS steps on the replayed batch `host` by meant_trainer with
    the trainer parameters `extra`, with phase 4's launches a step (K1 by
    shape too); records res[way] and returns (losses, the flat
    parameters, the moments' local size)."""
    model = model or build_flagship(flash=True, fixed_proj=True)
    out, trainer, _ = train_steps(model, host, LAYOUT_STEPS, LAYOUT_STEP,
                                  f"layout {way}", falling=False, **extra)
    want = {k: n * LAYOUT_STEPS for k, n in LAYOUT_K1_BY_SHAPE.items()}
    if out["launches"]["K1_by_shape"] != want:
        fail(f"layout {way}: K1 launched "
             f"{out['launches']['K1_by_shape']}, want {want}")
    trainer.optimizer.gather()
    run = (out["losses"], trainer.optimizer.flat_p[
        :trainer.optimizer.n].clone(), trainer.optimizer.m.numel())
    res[way] = {k: out[k] for k in ("losses", "step_ms_median",
                                    "peak_memory_bytes")}
    res[way]["m_local"] = run[2]
    del model, trainer, out
    torch.cuda.empty_cache()
    return run


def deterministic(fn):
    """fn() under torch.use_deterministic_algorithms (warn only)."""
    kept = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        return fn()
    finally:
        torch.use_deterministic_algorithms(kept)


def layout_runs(res):
    """Phase 16a: the flagship (fixed_proj=True) trained LAYOUT_STEPS steps
    by the plain meant_trainer, with a world-1 data-parallel mesh and with
    fsdp=True, from the same weights on the same replayed batch, under
    deterministic algorithms: each with phase 4's launches a step (K1 by
    shape too) and the losses and parameters of the plain run bit for
    bit. Returns the mesh, the batch and the plain run."""
    from meant_tpu_torch.parallel import make_mesh
    mesh = make_mesh()
    host = train_batch(BATCH, seed=1)
    ways = {"plain": {}, "mesh": {"mesh": mesh},
            "fsdp": {"mesh": mesh, "fsdp": True}}
    runs = deterministic(lambda: {
        way: layout_run(res, way, host, **extra)
        for way, extra in ways.items()})
    losses, params, _ = runs["plain"]
    for way in ("mesh", "fsdp"):
        got_losses, got, _ = runs[way]
        exact = got_losses == losses and torch.equal(got, params)
        rel = rel_l2(got, params)
        res[way].update(bit_for_bit=exact, params_rel_l2=rel)
        print(f"layout {way} at one rank vs plain: losses {got_losses} "
              f"vs {losses}, params rel L2 {rel:.3e}, bit for bit "
              f"{exact}", flush=True)
        if not exact:
            fail(f"layout {way} differs from the plain trainer: params "
                 f"rel L2 {rel}, losses {got_losses} vs {losses}")
    return mesh, host, runs["plain"]


def layout_serving(res):
    """Phase 16b: Predictor(tensor_parallel=True) on a (1, 1) (data,
    model) mesh answers one 16-row request through 24 R1 + 24 K1, bit for
    bit the plain Predictor whose row-parallel Linears add their bias
    after the product (`bias_behind`, as 16d), and within twice that
    Predictor's distance of the plain one's probabilities."""
    from meant_tpu_torch.parallel import make_mesh
    from meant_tpu_torch.serve import Predictor
    chunk = request_batch(BATCH, seed=3)
    mesh = make_mesh(("data", "model"), (1, 1))
    want = {}
    for name, shape in (("plain", lambda m: m),
                        ("bias_behind", lambda m: bias_behind(m, mesh))):
        plain = Predictor(shape(build_flagship(flash=True, fixed_proj=True)),
                          "meant_src", batch_size=BATCH)
        want[name] = plain.forward(chunk).float()
        del plain
        torch.cuda.empty_cache()
    model = build_flagship(flash=True, fixed_proj=True)
    tp = Predictor(model, "meant_src", batch_size=BATCH, mesh=mesh,
                   tensor_parallel=True)
    reset_counts()
    got = tp.forward(chunk).float()
    torch.cuda.synchronize()
    counts = read_counts()
    check_counts(counts, {"K1": 24, "R1": 24}, "tensor-parallel request")
    exact = torch.equal(got, want["bias_behind"])
    err = (got - want["plain"]).abs().max().item()
    behind = (want["bias_behind"] - want["plain"]).abs().max().item()
    res["tp"] = {"bit_for_bit_bias_behind": exact,
                 "max_abs_err_vs_plain": err,
                 "bias_behind_max_abs_err_vs_plain": behind,
                 "launches": counts,
                 "heads_per_rank": model.languageEncoders[0].attn.num_heads}
    print(f"tensor-parallel Predictor at (1, 1): bit for bit the plain "
          f"Predictor with its row biases after the product: {exact}; max "
          f"abs err vs the plain Predictor {err:.3e} (that Predictor's "
          f"{behind:.3e}); launches {counts}", flush=True)
    if not exact or err > 2 * behind:
        fail(f"tensor-parallel serving differs from the plain Predictor "
             f"with its row biases after the product (max abs err vs "
             f"plain {err}, the rerun's {behind})")
    del tp, model
    torch.cuda.empty_cache()


# The played ring's gradients against the ring's plain engine: its
# backward takes its own forward's out and lse, whose K3 difference (held
# to BF16_REL_L2) reaches every chunk's dO and lse cotangent through the
# combine, so the gradients are held to BF16_REL_L2 there; against the
# plain backward on the kernels' forward (R1 + K3's out and lse), which
# leaves K4 and K5 the one difference, to their own BWD_BF16_REL_L2.
RING_PLAIN_GRAD_REL_L2 = 5e-3


class _PlainOnline(torch.autograd.Function):
    """The streaming path's plain versions with its autograd Function's
    arithmetic: the ring's plain engine; with `kernel_forward` the forward
    is R1 + K3 and only the backward (K4 + K5's) is plain."""

    @staticmethod
    def forward(ctx, kernel_forward, q, k, v, kmask, qcos, qsin, kcos,
                ksin, scale, causal):
        from meant_tpu_torch.ops.flash import flash_mha_online_reference
        from meant_tpu_torch.ops.flash.kernel import flash_fwd_lse_op
        if kernel_forward:
            out, lse = flash_fwd_lse_op(q, k, v, kmask, qcos, qsin, kcos,
                                        ksin, scale, causal)
        else:
            out, lse = flash_mha_online_reference(
                q, k, v, kmask, qcos, qsin, kcos, ksin, scale=scale,
                causal=causal)
        ctx.save_for_backward(q, k, v, kmask, qcos, qsin, kcos, ksin, out,
                              lse)
        ctx.scale, ctx.causal = scale, causal
        return out, lse

    @staticmethod
    def backward(ctx, g, g_lse):
        from meant_tpu_torch.ops.flash.kernel import (
            flash_mha_bwd_online_reference)
        q, k, v, kmask, qcos, qsin, kcos, ksin, out, lse = ctx.saved_tensors
        delta = (g.float() * out.float()).sum(-1) - g_lse.float()
        grads = flash_mha_bwd_online_reference(
            q, k, v, g, lse, delta, kmask, qcos, qsin, kcos, ksin,
            scale=ctx.scale, causal=ctx.causal)
        return (None, *grads, None, None, None, None, None, None, None)


def plain_engine(kernel_forward: bool):
    """flash_mha(..., return_lse=True) as `_PlainOnline` computes it."""
    def engine(q, k, v, *, scale, causal, attention_mask, qcos, qsin, kcos,
               ksin, **_):
        out, lse = _PlainOnline.apply(kernel_forward, q, k, v,
                                      attention_mask, qcos, qsin, kcos, ksin,
                                      scale, causal)
        return out, lse[..., None]
    return engine


def ring_case(dtype, gen, heads: int = HEADS):
    """src4096's text attention, (10, 8, 4096, 96) q/k/v (or at `heads`
    heads of 768 / heads), a dO, the whole sequence's causal xPos tables,
    scale 1/sqrt(768)."""
    from meant_tpu_torch.ops import lang_freqs
    from meant_tpu_torch.ops.flash.flash_attention import _tables
    d = DIM // heads
    shape = (LONG_BATCH * LAG, heads, LONG_SEQ, d)
    q, k, v, do = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
                   for _ in range(4))
    return dict(q=q, k=k, v=v, do=do, scale=1.0 / DIM ** 0.5,
                tables=_tables(LONG_SEQ, d, lang_freqs(d // 2, device="cuda"),
                               True, 512.0))


def played_ring(c, dense=False, grad=False):
    """The ring of RING_RANKS ranks played in this process: each rank's
    body (`ring_flash_local`, or the dense `ring_attention_local` on q and
    k rotated at global positions) gets a shift that hands it chunk (idx -
    i) mod n of k, v and the mask at step i. Returns the whole output
    (the ranks' chunks in order) and the leaves (q, k, v)."""
    from meant_tpu_torch.ops.flash.kernel import _rotate
    from meant_tpu_torch.ops.ring import (ring_attention_local,
                                          ring_flash_local)
    n, s_loc = RING_RANKS, RING_CHUNK
    leaves = [c[t].detach().requires_grad_(grad) for t in ("q", "k", "v")]
    q, k, v = leaves
    tables = c["tables"]
    if dense:
        q = _rotate(q, tables[0], tables[1])
        k = _rotate(k, tables[2], tables[3])
    rows = [slice(j * s_loc, (j + 1) * s_loc) for j in range(n)]
    mask = torch.ones((q.shape[0], LONG_SEQ), device="cuda")
    held = [(k[:, :, r], v[:, :, r], mask[:, r]) for r in rows]
    outs = []
    for idx in range(n):
        kw = dict(scale=c["scale"], causal=True, index=idx, size=n,
                  shift=lambda i, _, idx=idx: held[(idx - i) % n])
        if dense:
            out = ring_attention_local(q[:, :, rows[idx]], *held[idx], **kw)
        else:
            out = ring_flash_local(
                q[:, :, rows[idx]], *held[idx], **kw,
                tables=lambda j: tuple(t[rows[j]] for t in tables))
        outs.append(out)
    return torch.cat(outs, dim=2), leaves


def _with_engine(engine, fn):
    """fn() with `engine` as the ring's per-chunk flash_mha."""
    import meant_tpu_torch.ops.ring as ring
    kept = ring.flash_mha
    ring.flash_mha = engine
    try:
        return fn()
    finally:
        ring.flash_mha = kept


def layout_ring(res, mesh):
    """Phase 16c: ring_attend at one rank over NCCL bit for bit
    flash_mha(force_online=True); the ring of RING_RANKS ranks played in
    one process at src4096's attention, bf16: 16 R1 + 16 K3 forward and
    16 R1 + 16 K4 + 16 K5 backward at (80, 1024, 96), the output against
    the unsplit R1 + K3, the plain ring in fp32 and the ring's plain
    engine at BF16_REL_L2, the gradients against the plain engine at
    RING_PLAIN_GRAD_REL_L2 and against the plain backward on the kernels'
    forward at BWD_BF16_REL_L2, the same case in fp32 against the plain
    ring at FP32_RTOL / FP32_ATOL;
    then the timings. Returns the counts for the kernel rows."""
    from meant_tpu_torch.ops.flash import flash_mha
    from meant_tpu_torch.ops.flash.kernel import (BF16_REL_L2,
                                                  BWD_BF16_REL_L2)
    from meant_tpu_torch.ops.ring import ring_attend
    gen = torch.Generator(device="cuda").manual_seed(16)
    # 1. one rank over NCCL: the ring is flash_mha
    c = ring_case(torch.bfloat16, gen)
    q, k, v = (c[t][:2] for t in ("q", "k", "v"))
    got = ring_attend(q, k, v, mesh=mesh, scale=c["scale"], causal=True,
                      use_flash=True)
    want = flash_mha(q, k, v, scale=c["scale"], causal=True,
                     force_online=True)
    if not torch.equal(got, want):
        fail("ring_attend at one rank differs from flash_mha(force_online"
             f"=True): max abs err {(got - want).abs().max().item()}")
    res["ring_world1_bit_for_bit"] = True
    print("ring_attend at one rank over NCCL: bit for bit "
          "flash_mha(force_online=True)", flush=True)
    del q, k, v, got, want
    # 2. the played ring: forward, then backward from dO
    lse_grads = []

    def watched(*args, **kw):
        out, lse = flash_mha(*args, **kw)
        if lse.requires_grad:
            lse.register_hook(
                lambda g: lse_grads.append(g.abs().max().item()))
        return out, lse

    reset_counts()
    out, leaves = _with_engine(watched, lambda: played_ring(c, grad=True))
    torch.cuda.synchronize()
    fwd = read_counts()
    reset_counts()
    out.backward(c["do"])
    torch.cuda.synchronize()
    bwd = read_counts()
    n2 = RING_RANKS ** 2
    check_counts(fwd, {"R1": n2, "K3": n2}, "played ring forward")
    check_counts(bwd, {"R1": n2, "K4": n2, "K5": n2}, "played ring backward")
    chunk = f"s{RING_CHUNK}"
    if fwd["R1_by_shape"] != {chunk: n2} or bwd["R1_by_shape"] != {
            chunk: n2}:
        fail(f"played ring R1 by shape {fwd['R1_by_shape']}, "
             f"{bwd['R1_by_shape']}")
    live = sum(g > 0 for g in lse_grads)
    # nonzero at the chunks at or before each rank's own, n (n + 1) / 2 of
    # n^2, but rank 0's lone diagonal chunk: its output does not depend on
    # that chunk's lse
    want_live = RING_RANKS * (RING_RANKS + 1) // 2 - 1
    print(f"played ring: {len(lse_grads)} lse cotangents, {live} of them "
          f"nonzero (want {n2}, {want_live})", flush=True)
    if len(lse_grads) != n2 or live != want_live:
        fail(f"lse cotangents {lse_grads}: want {n2}, {want_live} of them "
             f"nonzero")
    grads = [t.grad for t in leaves]
    whole = flash_mha(c["q"], c["k"], c["v"], scale=c["scale"],
                      causal=True, force_online=True, qcos=c["tables"][0],
                      qsin=c["tables"][1], kcos=c["tables"][2],
                      ksin=c["tables"][3])
    c32 = {**c, **{t: c[t].float() for t in ("q", "k", "v", "do")}}
    plain_ring, _ = played_ring(c32, dense=True)
    checks = {"out_vs_unsplit": rel_l2(out, whole),
              "out_vs_plain_ring_fp32": rel_l2(out, plain_ring)}
    del whole
    torch.cuda.empty_cache()
    bars = {"out_vs_unsplit": BF16_REL_L2,
            "out_vs_plain_ring_fp32": BF16_REL_L2,
            "out_vs_plain_engine": BF16_REL_L2}
    for tag, kernel_forward, bar in (
            ("plain_engine", False, RING_PLAIN_GRAD_REL_L2),
            ("plain_backward", True, BWD_BF16_REL_L2)):
        plain_out, plain_leaves = _with_engine(
            plain_engine(kernel_forward), lambda: played_ring(c, grad=True))
        plain_out.backward(c["do"])
        for name, a, b in zip(("dq", "dk", "dv"), grads,
                              (t.grad for t in plain_leaves)):
            checks[f"{name}_vs_{tag}"] = rel_l2(a, b)
            bars[f"{name}_vs_{tag}"] = bar
        if not kernel_forward:
            checks["out_vs_plain_engine"] = rel_l2(out, plain_out)
        del plain_out, plain_leaves
        torch.cuda.empty_cache()
    for name, rel in checks.items():
        ok = rel <= bars[name] and bool(torch.isfinite(out).all())
        print(f"played ring bf16 {name}: rel L2 {rel:.3e} (bar "
              f"{bars[name]}) {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            fail(f"played ring {name}: rel L2 {rel} > {bars[name]}")
    # 3. the same case in fp32 through the kernels' fp32 bodies
    with torch.no_grad():
        out32, _ = played_ring(c32)
        ok = torch.allclose(out32, plain_ring, rtol=FP32_RTOL,
                            atol=FP32_ATOL)
    err32 = (out32 - plain_ring).abs().max().item()
    print(f"played ring fp32 vs plain ring: max abs err {err32:.3e} "
          f"(rtol {FP32_RTOL}, atol {FP32_ATOL}) {'ok' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        fail(f"played ring in fp32 differs from the plain ring (max abs "
             f"err {err32})")
    res["ring"] = {"rel_l2": checks, "fp32_max_abs_err": err32,
                   "forward_launches": fwd, "backward_launches": bwd,
                   "lse_cotangent_max": lse_grads}
    del out, leaves, grads, plain_ring, out32, c32
    torch.cuda.empty_cache()
    time_ring(res, c)
    return {name: fwd[name] + bwd[name] for name in ("R1", "K3", "K4",
                                                     "K5")}


def time_ring(res, c):
    """The played ring's forward and backward against the unsplit R1 +
    K3 and R1 + K4 + K5 at (80, 4096, 96), and the world-1 collectives of
    the flagship's flat buffer, on the card."""
    from meant_tpu_torch.ops.flash import flash_mha
    card = card_line()
    tables = dict(zip(("qcos", "qsin", "kcos", "ksin"), c["tables"]))

    def ring_fwd():
        with torch.no_grad():
            played_ring(c)

    def ring_fwd_bwd():
        out, _ = played_ring(c, grad=True)
        out.backward(c["do"])

    def whole_fwd():
        with torch.no_grad():
            flash_mha(c["q"], c["k"], c["v"], scale=c["scale"], causal=True,
                      force_online=True, **tables)

    def whole_fwd_bwd():
        leaves = [c[t].detach().requires_grad_() for t in ("q", "k", "v")]
        out = flash_mha(*leaves, scale=c["scale"], causal=True,
                        force_online=True, **tables)
        out.backward(c["do"])

    t = {name: event_ms(fn, iters=RING_TIME_ITERS, warmup=1)
         for name, fn in (("ring_fwd", ring_fwd),
                          ("ring_fwd_bwd", ring_fwd_bwd),
                          ("whole_fwd", whole_fwd),
                          ("whole_fwd_bwd", whole_fwd_bwd))}
    t["ring_bwd"] = t["ring_fwd_bwd"] - t["ring_fwd"]
    t["whole_bwd"] = t["whole_fwd_bwd"] - t["whole_fwd"]
    print(f"played ring of {RING_RANKS} at (80, 4096, 96) bf16 causal "
          f"xPos: forward {t['ring_fwd']:.4f} ms, backward "
          f"{t['ring_bwd']:.4f} ms; unsplit R1 + K3 {t['whole_fwd']:.4f} "
          f"ms, R1 + K4 + K5 {t['whole_bwd']:.4f} ms (backward as forward "
          f"+ backward less forward) on {card}", flush=True)
    import torch.distributed as dist
    n = res["n_params"]
    flat = torch.zeros(n, device="cuda")
    other = torch.zeros(n, device="cuda")
    for name, fn in (("all_reduce", lambda: dist.all_reduce(flat)),
                     ("reduce_scatter", lambda: dist.reduce_scatter_tensor(
                         other, flat)),
                     ("all_gather", lambda: dist.all_gather_into_tensor(
                         other, flat))):
        t[name] = event_ms(fn, iters=10)
        print(f"world-1 NCCL {name} of the flagship's flat buffer ({n} "
              f"fp32): {t[name]:.4f} ms on {card}", flush=True)
    res["ms"] = t
    del flat, other
    torch.cuda.empty_cache()


# ---- phases 16d-16f: tensor-parallel training and int8, the pipeline ----

# 16d: tensor parallelism at a (1, 1) (data, model) mesh changes the
# association of two sums against the plain step: a row-parallel layer adds
# its bias after the sum over the model axis (F.linear(x, w) + b, where the
# plain Linear's F.linear(x, w, b) adds it inside the product's epilogue in
# fp32 before the one rounding to bf16), and the clip's norm^2 is summed
# from sharded and replicated parts (at one model rank every entry counts
# on rank 0 and sqrt(fl(n * n)) == n, so the norm itself is exact). So the
# TP step is held bit for bit to the plain step rerun with its row-parallel
# biases added after the product (`bias_behind`), and its distance from
# the plain step to at most twice that rerun's (the one change of
# rounding). The plain step rerun under default (nondeterministic)
# algorithms is recorded beside them.
TP_TRAIN_MESH = (1, 1)
# 16f: the flagship's language tower (12 LanguageEncoders, 768 wide, 8
# heads of 96, causal xPos, bf16) with a key mask (the kernels take it),
# over 80 sequences of 512 (16 rows x lag 5), played as 4 stages of 3
# layers at 4 and 8 microbatches (BH = 160 and 80), against the sequential
# stack on the same kernels. A microbatch's rows go through the same
# per-row arithmetic (the products at other row counts), so the output and
# the input's gradient are held to the kernels' own bars, BF16_REL_L2 and
# BWD_BF16_REL_L2; a weight's gradient is the fp32 sum over the
# microbatches of bf16 products, each rounded to bf16 (2^-9 relative)
# where the sequential stack rounds one product over all rows, so the
# parameters' gradients are held to one bf16 step, 2^-8.
PIPE_STAGES = 4
PIPE_MICROBATCHES = (4, 8)
PIPE_ROWS = BATCH * LAG
PIPE_PARAM_GRAD_REL_L2 = 2.0 ** -8
PIPE_TIME_ITERS = 3
PIPE_CASES = tuple((f"text_bh{PIPE_ROWS // m * HEADS}", "text", SEQ,
                    PIPE_ROWS // m * HEADS) for m in PIPE_MICROBATCHES)


def bias_behind(model, mesh):
    """The plain model whose row-parallel Linears (the tensor-parallel
    rules' Shard(1) weights on `mesh`) add their bias after the product,
    as tensor parallelism adds it after the sum: the plain path with 16d's
    association."""
    import torch.nn.functional as F
    from meant_tpu_torch.nn.layers import Linear
    from meant_tpu_torch.parallel import param_shardings
    from meant_tpu_torch.parallel.sharding_rules import _model_shard
    specs = param_shardings(model, mesh)
    for name, m in model.named_modules():
        if not isinstance(m, Linear):
            continue
        shard = _model_shard(specs[f"{name}.weight"], mesh)
        if shard is not None and shard.dim == 1:
            def forward(x, m=m):
                dt = m.dtype or torch.promote_types(x.dtype, m.weight.dtype)
                y = F.linear(x.to(dt), m.weight.to(dt))
                return y if m.bias is None else y + m.bias.to(dt)
            m.forward = forward
    return model


def layout_tp_train(res, host, plain):
    """Phase 16d: the flagship cut by `parallelize_model` over a (1, 1)
    (data, model) mesh, trained LAYOUT_STEPS steps by meant_trainer on
    that mesh (FlatAdam with the tensor-parallel norm), with phase 4's
    launches a step, under deterministic algorithms: bit for bit the plain
    step with its row-parallel biases after the product, and within twice
    that rerun's distance of the plain step (TP_TRAIN_MESH's notes)."""
    from meant_tpu_torch.parallel import make_mesh, parallelize_model
    mesh = make_mesh(("data", "model"), TP_TRAIN_MESH)

    def tp_run():
        model = parallelize_model(build_flagship(flash=True,
                                                 fixed_proj=True), mesh)
        return layout_run(res, "tp_train", host, model=model, mesh=mesh)

    def behind_run():
        model = bias_behind(build_flagship(flash=True, fixed_proj=True),
                            mesh)
        return layout_run(res, "plain_bias_behind", host, model=model)

    tp = deterministic(tp_run)
    behind = deterministic(behind_run)
    rerun = layout_run(res, "plain_default_algorithms", host)
    losses, params, _ = plain
    dists = {name: rel_l2(run[1], params)
            for name, run in (("tp", tp), ("plain_bias_behind", behind),
                              ("plain_default_algorithms", rerun))}
    exact = tp[0] == behind[0] and torch.equal(tp[1], behind[1])
    res["tp_train"].update(bit_for_bit_bias_behind=exact,
                           params_rel_l2_vs_plain=dists)
    print(f"tensor-parallel training at {TP_TRAIN_MESH}: losses {tp[0]}; "
          f"bit for bit the plain step with its row biases after the "
          f"product: {exact}; params rel L2 vs the plain step: TP "
          f"{dists['tp']:.3e}, the bias-behind rerun "
          f"{dists['plain_bias_behind']:.3e}, a default-algorithms rerun "
          f"{dists['plain_default_algorithms']:.3e}; plain losses {losses}",
          flush=True)
    if not exact:
        fail(f"tensor-parallel training differs from the plain step with "
             f"its row biases after the product: losses {tp[0]} vs "
             f"{behind[0]}, params rel L2 {rel_l2(tp[1], behind[1])}")
    if dists["tp"] > 2 * dists["plain_bias_behind"]:
        fail(f"tensor-parallel training is {dists['tp']} from the plain "
             f"step, more than twice the rerun's "
             f"{dists['plain_bias_behind']}")
    return mesh


def layout_tp_int8(res, mesh):
    """Phase 16e: Predictor(tensor_parallel=True, quantize="int8") on the
    (1, 1) mesh answers one 16-row request through 24 R1 + 24 K1 with the
    plain int8 Predictor's probabilities and int8 products, bit for bit."""
    from meant_tpu_torch.serve import Predictor
    chunk = request_batch(BATCH, seed=3)
    plain = Predictor(build_flagship(flash=True, fixed_proj=True),
                      "meant_src", batch_size=BATCH, quantize="int8")
    reset_int8_counts()
    want = plain.forward(chunk).float()
    want_products = int8_counts()
    del plain
    torch.cuda.empty_cache()
    tp = Predictor(build_flagship(flash=True, fixed_proj=True), "meant_src",
                   batch_size=BATCH, mesh=mesh, tensor_parallel=True,
                   quantize="int8")
    reset_counts()
    reset_int8_counts()
    got = tp.forward(chunk).float()
    torch.cuda.synchronize()
    counts = read_counts()
    products = int8_counts()
    check_counts(counts, {"K1": 24, "R1": 24}, "tensor-parallel int8 request")
    exact = torch.equal(got, want)
    err = (got - want).abs().max().item()
    res["tp_int8"] = {"bit_for_bit": exact, "max_abs_err": err,
                      "launches": counts,
                      "int8_products": sum(products.values()),
                      "int8_products_plain": sum(want_products.values())}
    print(f"tensor-parallel int8 Predictor at {TP_TRAIN_MESH} vs plain "
          f"int8: max abs err {err:.3e}, bit for bit {exact}; int8 "
          f"products {sum(products.values())} (plain "
          f"{sum(want_products.values())}); launches {counts}", flush=True)
    if not exact or products != want_products or not products:
        fail(f"tensor-parallel int8 serving differs from the plain int8 "
             f"Predictor (max abs err {err}; products {products} vs "
             f"{want_products})")
    del tp
    torch.cuda.empty_cache()


def pipe_tower():
    """The flagship's language tower (its weights from seed 0), the key
    mask handed to the kernels, dropout off."""
    tower = build_flagship(flash=True, fixed_proj=True).languageEncoders
    for enc in tower:
        enc.mask_in_flash = True
    return tower.eval()


def pipe_inputs(gen):
    """80 sequences of 512 x 768 bf16 hidden states, key masks of lengths
    uniform in [256, 512], and a dO."""
    shape = (PIPE_ROWS, SEQ, DIM)
    x = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    lengths = torch.randint(SEQ // 2, SEQ + 1, (PIPE_ROWS,), generator=gen,
                            device="cuda")
    mask = (torch.arange(SEQ, device="cuda")[None, :]
            < lengths[:, None]).to(torch.float32)
    do = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    return x, mask, do


def pipe_pass(tower, x, mask, do=None, **kw):
    """The tower over (x, mask): sequential without `kw`, else
    `pipeline_apply(..., **kw)` of its stacked layers; with `do` the
    backward too. Returns (output, the input's gradient, the parameters'
    gradients by name)."""
    from meant_tpu_torch.parallel import pipeline_apply, stack_layer_params
    leaf = x.detach().requires_grad_(do is not None)
    with torch.set_grad_enabled(do is not None):
        if kw:
            template = tower[0]

            def layer(params, state):
                h, m = state
                return torch.func.functional_call(template, params,
                                                  (h, m)), m
            out, _ = pipeline_apply(layer, stack_layer_params(list(tower)),
                                    (leaf, mask), **kw)
        else:
            out = leaf
            for enc in tower:
                out = enc(out, mask)
    if do is None:
        return out, None, None
    out.backward(do)
    grads = {n: p.grad for n, p in tower.named_parameters()}
    for p in tower.parameters():
        p.grad = None
    return out.detach(), leaf.grad, grads


def layout_pipeline(res):
    """Phase 16f: the tower (`pipe_tower`) played as PIPE_STAGES stages at
    each of PIPE_MICROBATCHES, and over a real one-rank ("pipe",) mesh at
    4, forward and backward from one dO, against the sequential stack on
    the same kernels (PIPE_STAGES' notes), with exactly (m + n - 1) * 12
    launches each of R1, K1 and K2 when played (m * 12 over the one-rank
    mesh); then the timings. Returns the played runs' launches by BH."""
    from meant_tpu_torch.ops.flash.kernel import (BF16_REL_L2,
                                                  BWD_BF16_REL_L2)
    from meant_tpu_torch.parallel import make_mesh
    gen = torch.Generator(device="cuda").manual_seed(17)
    tower = pipe_tower()
    x, mask, do = pipe_inputs(gen)
    want = pipe_pass(tower, x, mask, do)
    layers = len(tower)
    pipe = make_mesh(("pipe",))
    runs = [(f"played m={m}", dict(stages=PIPE_STAGES, microbatches=m),
             (m + PIPE_STAGES - 1) * layers, PIPE_ROWS // m * HEADS)
            for m in PIPE_MICROBATCHES]
    runs.append(("one-rank mesh m=4", dict(mesh=pipe, microbatches=4),
                 4 * layers, PIPE_ROWS // 4 * HEADS))
    by_bh, checks = {}, {}
    for label, kw, n, bh in runs:
        reset_counts()
        got = pipe_pass(tower, x, mask, do, **kw)
        torch.cuda.synchronize()
        counts = read_counts()
        check_counts(counts, {"R1": n, "K1": n, "K2": n},
                     f"pipeline {label}")
        if label.startswith("played"):
            by_bh[bh] = counts
        rel = {"out": rel_l2(got[0], want[0]),
               "dx": rel_l2(got[1], want[1]),
               "params": max(rel_l2(g, want[2][k])
                             for k, g in got[2].items())}
        bars = {"out": BF16_REL_L2, "dx": BWD_BF16_REL_L2,
                "params": PIPE_PARAM_GRAD_REL_L2}
        ok = (all(rel[k] <= bars[k] for k in rel)
              and bool(torch.isfinite(got[0]).all()))
        checks[label] = {"rel_l2": rel, "bars": bars, "launches": counts}
        print(f"pipeline {label} vs the sequential stack: output rel L2 "
              f"{rel['out']:.3e} (bar {bars['out']}), input gradient "
              f"{rel['dx']:.3e} (bar {bars['dx']}), worst parameter "
              f"gradient {rel['params']:.3e} (bar {bars['params']}); "
              f"{n} launches each of R1, K1, K2 "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            fail(f"pipeline {label} differs from the sequential stack: "
                 f"{rel}")
        del got
        torch.cuda.empty_cache()
    del want
    torch.cuda.empty_cache()
    card = card_line()
    ms = {}
    for label, kw in [("sequential", {})] + [
            (f"played m={m}", dict(stages=PIPE_STAGES, microbatches=m))
            for m in PIPE_MICROBATCHES]:
        fwd = event_ms(lambda: pipe_pass(tower, x, mask, **kw),
                       iters=PIPE_TIME_ITERS, warmup=1)
        both = event_ms(lambda: pipe_pass(tower, x, mask, do, **kw),
                        iters=PIPE_TIME_ITERS, warmup=1)
        ms[label] = {"fwd": fwd, "fwd_bwd": both, "bwd": both - fwd}
        print(f"{label} tower of {layers} at ({PIPE_ROWS}, {SEQ}, {DIM}) "
              f"bf16: forward {fwd:.4f} ms, forward + backward "
              f"{both:.4f} ms on {card}", flush=True)
    res["pipeline"] = {"checks": checks, "ms": ms}
    del tower, x, mask, do
    torch.cuda.empty_cache()
    return by_bh


def run_layouts(record) -> dict:
    """Phase 16: data parallel and FSDP of the flagship (16a),
    tensor-parallel serving (16b) and ring attention (16c), at one card;
    the ring's kernels checked at their chunk shape against their plain
    versions; then R1 + K1 and K2 at the pipeline's microbatch shapes
    against their plain versions, tensor-parallel training (16d) and int8
    serving (16e) at (1, 1), and the GPipe pipeline (16f)."""
    import torch.distributed as dist
    t0 = time.perf_counter()
    res = {"n_params": record["n_params"]}
    record["layouts"] = res
    mesh, host, plain = layout_runs(res)
    layout_serving(res)
    counts = layout_ring(res, mesh)
    errors = check_long_kernels(res, kinds=("vision",), tag="ring",
                                s=RING_CHUNK)
    res["wall_s_16abc"] = time.perf_counter() - t0
    check_kernel(res, PIPE_CASES, "pipe_kernel_vs_plain")
    check_backward(res, PIPE_CASES, "pipe_k2_vs_plain")
    tp_mesh = layout_tp_train(res, host, plain)
    layout_tp_int8(res, tp_mesh)
    pipe_counts = layout_pipeline(res)
    dist.destroy_process_group()
    res["wall_s"] = time.perf_counter() - t0
    print(f"phase layouts: {res['wall_s']:.1f} s (16a-16c "
          f"{res['wall_s_16abc']:.1f} s)", flush=True)
    return {"errors": errors, "counts": counts, "pipe_counts": pipe_counts}


def time_layouts(layouts) -> list:
    """R1 + K3, R1, K4 and K5 at the ring's chunk shape (80, 1024, 96), a
    chunk of earlier keys (not causal; 12 of the ring's 16 launches), with
    the played ring's launches; then the resident rows (R1 + K1, K2, R1)
    at the pipeline's microbatch shapes (160 and 80, 512, 96) causal xPos,
    with the played pipeline's launches at each."""
    rows = time_long_kernels(layouts["errors"], layouts["counts"],
                             bh=RING_BH, tag="ring", kind="vision",
                             label=f"ring chunk s{RING_CHUNK}",
                             s=RING_CHUNK)
    gen = torch.Generator(device="cuda").manual_seed(18)
    key = shape_key(SEQ, True)
    for _, kind, s, bh in PIPE_CASES:
        counts = layouts["pipe_counts"][bh]
        c = backward_case(kind, torch.bfloat16, gen, s=s, bh=bh)
        rows += resident_rows(
            c, f"s{s} causal xPos BH{bh} pipeline",
            counts["K1_by_shape"].get(key, 0),
            counts["K2_by_shape"].get(key, 0),
            counts["R1_by_shape"].get(f"s{s}", 0))
        del c
    return rows


# ---- phase 17: every head dim ----------------------------------------------

# The flash path at the head dims the CLI's free --num_heads and --text_dim
# reach beside 64, 96 and 128: odd d (the lanes' wrap in the rotation and
# its adjoint) and d past 128 (the wgmma bodies built at 192 and 256, and
# for K1 and K3 at 384 and 768; the wide bodies of csrc/flash_wide.cuh at
# the other widths, in fp32, and for the backwards at an odd d or past
# 256).
# Kernel level: R1 + K1 and K2 through flash_mha at HD_DIMS, causal xPos
# with a key mask at s=200 (a ragged tile) and plain (the identity tables,
# no mask, not causal: the TimeSformer group's form); R1 + K3, K4 and K5 at
# HD_LONG_CASES: (d, s, BH, heads) at s=4096, BH = 4, and d = 768 at the
# shape --num_heads 1 streams its s=512 text tower at, (80, 512, 768). BH =
# 16 and 4: each case under a second.
HD_DIMS = (7, 95, 130, 192, 256, 257, 384, 768)
HD_S, HD_BH, HD_HEADS = 200, 16, 4
HD_LONG_BH = 4
HD_LONG_CASES = ((95, LONG_SEQ, HD_LONG_BH, HD_HEADS),
                 (192, LONG_SEQ, HD_LONG_BH, HD_HEADS),
                 (384, LONG_SEQ, HD_LONG_BH, HD_HEADS),
                 (768, SEQ, BATCH * LAG, 1),
                 (256, LONG_SEQ, HD_LONG_BH, HD_HEADS))
SRC4_HEADS = 4             # meant_src --num_heads 4: 4 heads of 192
SRC4_STEPS = 5
SRC3_HEADS = 3             # meant_src --num_heads 3: 3 heads of 256
SRC2_HEADS = 2             # meant_src --num_heads 2: 2 heads of 384
FULL_STEPS = 3             # src4096 at 4 and 2 heads, 12 + 12 encoders:
                           # the median of steps 2-3
WIDE_WGMMA_DIMS = (192, 256)   # K2-K5's bf16 wgmma bodies past d = 128
SLICED_DIMS = (384, 768)       # K1's and K3's sliced ring
FWD_WGMMA_DIMS = WIDE_WGMMA_DIMS + SLICED_DIMS   # K1's past d = 128
# d = 384 and 768: one request and 2 steps each, the towers and one step's
# gradients against flash=False
WIDE_SERVE_HEADS = (2, 1)
ODD_DIM, ODD_HEADS = 760, 8   # --text_dim 760: 8 heads of 95
ODD_STEPS = 2
RING4_BH = LONG_BATCH * LAG * SRC4_HEADS   # (10, 4, 4096, 192): 40


def padded(c):
    """c's q, k, v, dO and tables as flash_mha hands them to the kernels:
    (b*h, s, width) at kernel_head_dim(d) with zero columns, the tables
    padded with the identity; stored as c["p"]."""
    from meant_tpu_torch.ops.flash.kernel import (_flat, _kernel_tables,
                                                  kernel_head_dim)
    d = c["q"].shape[-1]
    width = kernel_head_dim(d)
    q, k, v = _flat(width, c["q"], c["k"], c["v"])
    do = _flat(width, c["do"])[0] if "do" in c else None
    mask, *tables = _kernel_tables(width, c["mask"], *c["tables"])
    c["p"] = dict(q=q, k=k, v=v, do=do, mask=mask, tables=tables, d=d,
                  width=width)
    return c["p"]


def rotate_padded(c):
    """R1 on the padded q and k with the caller's head dim (c["p"])."""
    from meant_tpu_torch.ops.flash import rotate_qk
    p = c["p"]
    p["qr"], p["kr"] = rotate_qk(p["q"], p["k"], *p["tables"],
                                 head_dim=p["d"])
    return p["qr"], p["kr"]


def k1_padded(c):
    """K1 alone on rotate_padded's Qr and Kr."""
    from meant_tpu_torch.ops.flash import flash_fwd
    p = c["p"]
    return flash_fwd(p["qr"], p["kr"], p["v"], p["mask"], scale=c["scale"],
                     causal=c["causal"], num_heads=c["q"].shape[1])


def k2_padded(c):
    """K2 alone on rotate_padded's Qr and Kr, at the caller's head dim."""
    from meant_tpu_torch.ops.flash import flash_bwd
    p = c["p"]
    return flash_bwd(p["qr"], p["kr"], p["v"], p["do"], p["mask"],
                     *p["tables"], scale=c["scale"], causal=c["causal"],
                     num_heads=c["q"].shape[1], head_dim=p["d"])


def check_r1_padded(c, label) -> float:
    """R1 at the padded width against `_rotate` at the caller's d: bit for
    bit on the first d columns (the lanes' wrap at an odd d included), zero
    on the rest."""
    padded(c)
    d = c["p"]["d"]
    got = rotate_padded(c)
    err = 0.0
    for a, b in zip(got, rotate_plain(c)):
        err = max(err, (a[..., :d].float() - b.float()).abs().max().item(),
                  a[..., d:].float().abs().max().item() if a.shape[-1] > d
                  else 0.0)
    print(f"R1 vs plain {label}: max_abs_err {err:.3e} (bar 0) "
          f"{'ok' if err == 0 else 'FAIL'}", flush=True)
    if err != 0:
        fail(f"R1 differs from _rotate ({label}, max abs err {err})")
    return err


def nowrap_bwd(c):
    """The plain backward without the lanes' wrap at an odd d: the inputs
    padded by one zero column (pairs stay whole), sliced back."""
    from meant_tpu_torch.ops.flash import flash_mha_bwd_reference
    from meant_tpu_torch.ops.flash.kernel import _kernel_tables
    pad = torch.nn.functional.pad
    d = c["q"].shape[-1]
    _, *tables = _kernel_tables(d + 1, None, *c["tables"])
    grads = flash_mha_bwd_reference(
        *(pad(c[n], (0, 1)) for n in ("q", "k", "v", "do")), c["mask"],
        *tables, scale=c["scale"], causal=c["causal"])
    return [t[..., :d] for t in grads]


def check_head_dims(res) -> dict:
    """R1 + K1 and K2 through flash_mha (one launch of each a call) at
    HD_DIMS against flash_mha_reference and flash_mha_bwd_reference, fp32
    and bf16, causal xPos with a key mask and plain; R1 bit for bit at the
    padded width; at an odd d the wrap term of column d-1 of dq and dk (the
    plain backward's, against its value without the wrap) reproduced.
    Records the body each launch ran."""
    from meant_tpu_torch.ops.flash.kernel import K1_BF16_REL_L2
    gen = torch.Generator(device="cuda").manual_seed(17)
    errors, rels, wrap, bodies = {}, {}, {}, {}
    for d in HD_DIMS:
        for kind in ("text_masked", "group"):
            for dtype in (torch.float32, torch.bfloat16):
                c = backward_case(kind, dtype, gen, s=HD_S, bh=HD_BH, d=d,
                                  heads=HD_HEADS)
                form = "plain" if kind == "group" else "xpos_masked"
                label = f"d{d}_{form}/{str(dtype).split('.')[-1]}"
                reset_counts()
                got = run_autograd(c)
                torch.cuda.synchronize()
                check_counts(read_counts(), {"R1": 1, "K1": 1, "K2": 1},
                             f"flash_mha at {label}")
                want = [run_plain(c), *run_bwd_plain(c)]
                unit = group_unit(kind, want[1])
                for g, a, b in zip(("out", "dq", "dk", "dv"), got, want):
                    kernel = "R1 + K1" if g == "out" else "R1 + K2"
                    errors[f"{label}/{g}"], rels[f"{label}/{g}"] = hold(
                        kernel, label, g, a, b, dtype, K1_BF16_REL_L2, unit)
                errors[f"{label}/rot"] = check_r1_padded(c, label)
                bodies[label] = {k: wrappers()[k].last_source
                                 for k in ("K1", "K2")}
                if d % 2 and kind != "group":
                    nowrap = nowrap_bwd(c)
                    for i, g in ((0, "dq"), (1, "dk")):
                        term = (want[1 + i][..., d - 1].float()
                                - nowrap[i][..., d - 1].float()).abs().max()
                        err = (got[1 + i][..., d - 1].float()
                               - want[1 + i][..., d - 1].float()).abs().max()
                        wrap[f"{label}/{g}"] = {"term": term.item(),
                                                "err": err.item()}
                        ok = term.item() > 10 * max(err.item(), 1e-30)
                        print(f"wrap term {label} {g}[:, d-1]: max "
                              f"|sin0 g0| {term.item():.3e}, kernel's "
                              f"column vs plain's {err.item():.3e} "
                              f"{'ok' if ok else 'FAIL'}", flush=True)
                        if not ok:
                            fail(f"the wrap term of {g} at {label} is not "
                                 f"reproduced ({term.item()} vs "
                                 f"{err.item()})")
                del c, got, want
                torch.cuda.empty_cache()
    res["head_dims_vs_plain_max_abs_err"] = errors
    res["head_dims_vs_plain_rel_l2"] = rels
    res["wrap"] = wrap
    res["head_dims_bodies"] = bodies
    return errors


# K2 past d = 256 at the main path's launches: --num_heads 2's text tower
# (160, 512, 384) causal xPos with a key mask and charts (160, 196, 384),
# --num_heads 1's charts (80, 196, 768) pixel rotary
WIDE_K2_CASES = (("text_masked", SEQ, 2), ("vision", N_PATCHES, 2),
                 ("vision", N_PATCHES, 1))


def check_wide_k2(res) -> dict:
    """R1 + K1 and K2 through flash_mha and autograd at WIDE_K2_CASES in
    bf16 (one launch of each a call) against flash_mha_reference and
    flash_mha_bwd_reference at the bars in force (K2: 2e-2 + 2e-2 |ref| an
    element, BWD_BF16_REL_L2 a gradient); records the elements past the
    element bar (none may be) and the body K2 ran."""
    from meant_tpu_torch.ops.flash.kernel import (BWD_BF16_ATOL,
                                                  K1_BF16_REL_L2)
    gen = torch.Generator(device="cuda").manual_seed(24)
    errors, rels, past, bodies = {}, {}, {}, {}
    for kind, s, heads in WIDE_K2_CASES:
        d = DIM // heads
        c = backward_case(kind, torch.bfloat16, gen, s=s,
                          bh=BATCH * LAG * heads, d=d, heads=heads)
        label = f"({BATCH * LAG * heads}, {s}, {d}) {kind}"
        reset_counts()
        got = run_autograd(c)
        torch.cuda.synchronize()
        check_counts(read_counts(), {"R1": 1, "K1": 1, "K2": 1},
                     f"flash_mha at {label}")
        bodies[label] = wrappers()["K2"].last_source
        want = [run_plain(c), *run_bwd_plain(c)]
        for g, a, b in zip(("out", "dq", "dk", "dv"), got, want):
            errors[f"{label}/{g}"], rels[f"{label}/{g}"] = hold(
                "R1 + K1" if g == "out" else "R1 + K2", label, g, a, b,
                torch.bfloat16, K1_BF16_REL_L2)
            if g != "out":
                past[f"{label}/{g}"] = int(
                    ((a.float() - b.float()).abs()
                     > BWD_BF16_ATOL + BF16_TOL * b.float().abs()).sum())
        del c, got, want
        torch.cuda.empty_cache()
    print(f"K2 past d = 256 at the main path's launches: bodies {bodies}, "
          f"elements past the element bar {past}", flush=True)
    res["wide_k2_vs_plain_max_abs_err"] = errors
    res["wide_k2_vs_plain_rel_l2"] = rels
    res["wide_k2_past_element_bar"] = past
    res["wide_k2_bodies"] = bodies
    return errors


def run_online_autograd(c):
    """flash_mha(return_lse=True) forward (R1 + K3) and its autograd
    backward (R1 + K4 + K5) with cotangents (dO, g_lse): (out, lse, dq, dk,
    dv)."""
    from meant_tpu_torch.ops.flash import flash_mha
    qcos, qsin, kcos, ksin = c["tables"]
    leaves = [c[n].detach().requires_grad_(True) for n in "qkv"]
    out, lse = flash_mha(*leaves, scale=c["scale"], causal=c["causal"],
                         attention_mask=c["mask"], qcos=qcos, qsin=qsin,
                         kcos=kcos, ksin=ksin, return_lse=True)
    grads = torch.autograd.grad((out, lse), leaves,
                                (c["do"], c["g_lse"][..., None]))
    return (out.detach(), lse.detach()[..., 0], *grads)


def check_head_dims_long(res) -> dict:
    """R1 + K3 (out, lse), R1 + K4 + K5 through flash_mha(return_lse=True)
    and autograd at HD_LONG_CASES, causal xPos with and
    without a key mask, fp32 and bf16: out at BF16_REL_L2 (and at
    K3_TILED_REL_L2 against K3's tiled order), lse within LSE_ATOL, the
    gradients at K2's bars against the plain backward fed the kernels' lse
    and delta = rowsum(dO * out) - g_lse; R1 bit for bit. Records the body
    each launch ran."""
    from meant_tpu_torch.ops.flash.kernel import (
        BF16_REL_L2, K3_TILED_REL_L2, LSE_ATOL,
        flash_mha_bwd_online_reference)
    gen = torch.Generator(device="cuda").manual_seed(18)
    errors, rels, bodies = {}, {}, {}
    for d, s, bh, heads in HD_LONG_CASES:
        tag = f"long_d{d}" if s == LONG_SEQ else f"long_d{d}_s{s}"
        for kind in ("text", "text_masked"):
            for dtype in (torch.float32, torch.bfloat16):
                c = backward_case(kind, dtype, gen, s=s, bh=bh, d=d,
                                  heads=heads)
                c["g_lse"] = torch.randn(c["q"].shape[:3], generator=gen,
                                         device="cuda")
                label = f"{tag}_{kind}/{str(dtype).split('.')[-1]}"
                reset_counts()
                out, lse, *grads = run_online_autograd(c)
                torch.cuda.synchronize()
                check_counts(read_counts(),
                             {"R1": 2, "K3": 1, "K4": 1, "K5": 1},
                             f"flash_mha(return_lse=True) at {label}")
                ref, ref_lse = run_online_plain(c)
                lse_err = (lse - ref_lse).abs().max().item()
                ok = lse_err <= LSE_ATOL and bool(torch.isfinite(lse).all())
                print(f"R1 + K3 vs plain {label} lse: max_abs_err "
                      f"{lse_err:.3e} (bar {LSE_ATOL}) "
                      f"{'ok' if ok else 'FAIL'}", flush=True)
                if not ok:
                    fail(f"K3's lse disagrees with its plain version "
                         f"({label}, max abs err {lse_err})")
                errors[f"{label}/lse"] = lse_err
                errors[f"{label}/out"], rels[f"{label}/out"] = hold(
                    "R1 + K3", label, "out", out, ref, dtype, BF16_REL_L2)
                if dtype == torch.bfloat16:
                    rel = rel_l2(out, run_online_tiled_plain(c))
                    print(f"R1 + K3 vs plain in K3's tiled order {label} "
                          f"out: rel_l2 {rel:.3e} (bar {K3_TILED_REL_L2}) "
                          f"{'ok' if rel <= K3_TILED_REL_L2 else 'FAIL'}",
                          flush=True)
                    if rel > K3_TILED_REL_L2:
                        fail(f"K3 disagrees with its tiled plain version "
                             f"({label}, rel L2 {rel})")
                    rels[f"{label}/out_tiled"] = rel
                del ref
                delta = (c["do"].float() * out.float()).sum(-1) - c["g_lse"]
                want = flash_mha_bwd_online_reference(
                    c["q"], c["k"], c["v"], c["do"], lse, delta, c["mask"],
                    *c["tables"], scale=c["scale"], causal=c["causal"])
                for g, a, b in zip(("dq", "dk", "dv"), grads, want):
                    kernel = "R1 + K4" if g == "dq" else "R1 + K5"
                    errors[f"{label}/{g}"], rels[f"{label}/{g}"] = hold(
                        kernel, label, g, a, b, dtype, BF16_REL_L2)
                errors[f"{label}/rot"] = check_r1_padded(c, label)
                bodies[label] = {k: wrappers()[k].last_source
                                 for k in ("K3", "K4", "K5")}
                del c, out, lse, grads, want
                torch.cuda.empty_cache()
    res["long_head_dims_vs_plain_max_abs_err"] = errors
    res["long_head_dims_vs_plain_rel_l2"] = rels
    res["long_head_dims_bodies"] = bodies
    return errors


def check_k45_chain_call(res, d=DIM, s=SEQ, bh=BATCH * LAG, heads=1):
    """K4 + K5 in one call where the chain body takes it (bf16, d = 768:
    --num_heads 1's streaming text tower, (80, 512, 768) causal xPos), with
    and without a key mask: the call runs the chain body, counts one launch
    of K4 and one of K5, and is bit for bit K4 and K5 apart (each of which
    forms S and dP itself)."""
    from meant_tpu_torch.ops.flash.kernel import CHAIN_SOURCE
    gen = torch.Generator(device="cuda").manual_seed(26)
    same = {}
    for kind in ("text", "text_masked"):
        c = long_case(kind, torch.bfloat16, gen, bh, s=s, d=d, heads=heads)
        rotate_case(c)
        name = f"(BH {bh}, s {s}, d {d}) {kind}"
        reset_counts()
        joint = run_online_k45(c)
        torch.cuda.synchronize()
        check_counts(read_counts(), {"K4": 1, "K5": 1},
                     f"K4 + K5 in one call at {name}")
        bodies = {k: wrappers()[k].last_source for k in ("K4", "K5")}
        if set(bodies.values()) != {CHAIN_SOURCE}:
            fail(f"K4 + K5 at {name} ran {bodies}, not the chain body")
        apart = (run_online_dq_kernel(c), *run_online_dkdv_kernel(c))
        torch.cuda.synchronize()
        same[kind] = all(torch.equal(a, b) for a, b in zip(joint, apart))
        print(f"K4 + K5 in one call (chain body) vs K4 and K5 apart at "
              f"{name}: {'bit for bit' if same[kind] else 'FAIL'}",
              flush=True)
        if not same[kind]:
            fail(f"K4 + K5 in one call differ from K4 and K5 apart ({name})")
        del c, joint, apart
        torch.cuda.empty_cache()
    res["k45_chain_call_equals_apart"] = same


def run_odd_width(res):
    """build_model(-mn meant_src --text_dim 760 --flash true) at s=512: a
    language tower of 8 heads of 95 (R1 and K1 at width 128, K2 on the wide
    body, whose adjoint wraps), the vision tower at 96. One request of
    BATCH rows (exactly 24 R1 + 24 K1) against the same weights at
    flash=False; at fixed_proj=True one step's gradients against the plain
    attention and ODD_STEPS trainer steps (24 R1, 24 K1, 24 K2, 1 A1 a
    step)."""
    from meant_tpu_torch.serve import Predictor
    args = ("--seq_len", str(SEQ), "--text_dim", str(ODD_DIM), "--flash")
    model = build_zoo("meant_src", *args, "true")
    predictor = Predictor(model, "meant_src", batch_size=BATCH)
    chunk = request_batch(BATCH, seed=70)
    predictor(chunk)        # warm-up
    torch.cuda.synchronize()
    reset_counts()
    probs = predictor(chunk)
    torch.cuda.synchronize()
    counts = read_counts()
    print(f"served --text_dim {ODD_DIM}: launches {counts}", flush=True)
    check_counts(counts, {"K1": 2 * ENCODERS, "R1": 2 * ENCODERS},
                 f"serving --text_dim {ODD_DIM}")
    if not (np.isfinite(probs).all() and ((probs > 0) & (probs < 1)).all()):
        fail(f"bad --text_dim {ODD_DIM} probabilities")
    plain = build_zoo("meant_src", *args, "false")
    plain.load_state_dict(model.state_dict())
    compare_slice(f"text_dim{ODD_DIM}",
                  towers_and_probs(model, predictor, chunk),
                  towers_and_probs(plain, Predictor(plain, "meant_src",
                                                    batch_size=BATCH), chunk),
                  res)
    res["serve_launches"] = counts
    del model, plain, predictor
    torch.cuda.empty_cache()
    model = build_flagship(flash=True, fixed_proj=True, text_dim=ODD_DIM)
    res["step_gradients"] = compare_step_gradients(
        model, to_card(train_batch(GRAD_ROWS, seed=71)),
        {k: n for k, n in STEP.items() if k != "A1"},
        lambda: build_flagship(flash=False, fixed_proj=True,
                               text_dim=ODD_DIM),
        f"meant_src --text_dim {ODD_DIM} train step")
    res["train"], _, _ = train_steps(
        model, train_batch(BATCH, seed=72), ODD_STEPS, STEP,
        f"learn meant_src --text_dim {ODD_DIM}", falling=False)
    del model
    torch.cuda.empty_cache()
    return counts, res["train"]["launches"]


def ring_head_dim(res):
    """The ring of RING_RANKS ranks played in one process at src4096's
    text attention at 4 heads of 192, bf16: 16 R1 + 16 K3 forward and 16
    R1 + 16 K4 + 16 K5 backward at (40, 1024, 192); the output against the
    unsplit R1 + K3 at BF16_REL_L2, the gradients against the plain
    backward on the kernels' forward at BWD_BF16_REL_L2; then both timed
    against the unsplit call. Returns the launches for the chunk's kernel
    rows."""
    from meant_tpu_torch.ops.flash import flash_mha
    from meant_tpu_torch.ops.flash.kernel import (BF16_REL_L2,
                                                  BWD_BF16_REL_L2)
    gen = torch.Generator(device="cuda").manual_seed(19)
    c = ring_case(torch.bfloat16, gen, heads=SRC4_HEADS)
    reset_counts()
    out, leaves = played_ring(c, grad=True)
    torch.cuda.synchronize()
    fwd = read_counts()
    reset_counts()
    out.backward(c["do"])
    torch.cuda.synchronize()
    bwd = read_counts()
    n2 = RING_RANKS ** 2
    check_counts(fwd, {"R1": n2, "K3": n2}, "played ring forward at d=192")
    check_counts(bwd, {"R1": n2, "K4": n2, "K5": n2},
                 "played ring backward at d=192")
    tables = dict(zip(("qcos", "qsin", "kcos", "ksin"), c["tables"]))
    with torch.no_grad():
        whole = flash_mha(c["q"], c["k"], c["v"], scale=c["scale"],
                          causal=True, force_online=True, **tables)
    checks = {"out_vs_unsplit": rel_l2(out, whole)}
    bars = {"out_vs_unsplit": BF16_REL_L2}
    del whole
    plain_out, plain_leaves = _with_engine(plain_engine(True),
                                           lambda: played_ring(c, grad=True))
    plain_out.backward(c["do"])
    for name, a, b in zip(("dq", "dk", "dv"), (t.grad for t in leaves),
                          (t.grad for t in plain_leaves)):
        checks[f"{name}_vs_plain_backward"] = rel_l2(a, b)
        bars[f"{name}_vs_plain_backward"] = BWD_BF16_REL_L2
    del plain_out, plain_leaves
    torch.cuda.empty_cache()
    for name, rel in checks.items():
        ok = rel <= bars[name] and bool(torch.isfinite(out).all())
        print(f"played ring d=192 bf16 {name}: rel L2 {rel:.3e} (bar "
              f"{bars[name]}) {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            fail(f"played ring at d=192 {name}: rel L2 {rel} > {bars[name]}")

    def ring_fwd_bwd():
        o, _ = played_ring(c, grad=True)
        o.backward(c["do"])

    def whole_fwd_bwd():
        lv = [c[t].detach().requires_grad_() for t in ("q", "k", "v")]
        o = flash_mha(*lv, scale=c["scale"], causal=True, force_online=True,
                      **tables)
        o.backward(c["do"])

    t = {name: event_ms(fn, iters=RING_TIME_ITERS, warmup=1)
         for name, fn in (("ring_fwd_bwd", ring_fwd_bwd),
                          ("whole_fwd_bwd", whole_fwd_bwd))}
    print(f"played ring of {RING_RANKS} at ({RING4_BH}, 4096, 192) bf16 "
          f"causal xPos: forward + backward {t['ring_fwd_bwd']:.4f} ms; "
          f"unsplit {t['whole_fwd_bwd']:.4f} ms on {card_line()}",
          flush=True)
    res["ring"] = {"rel_l2": checks, "forward_launches": fwd,
                   "backward_launches": bwd, "ms": t}
    del out, leaves, c
    torch.cuda.empty_cache()
    return {name: fwd[name] + bwd[name] for name in ("R1", "K3", "K4",
                                                     "K5")}


def learn_long_heads_full(res, heads: int = SRC4_HEADS):
    """src4096 at --num_heads `heads` at full depth (ENCODERS encoders a
    tower) and batch LONG_BATCH, the flash path alone (no plain
    comparison): FULL_STEPS trainer steps, exactly 12 K3, 12 K1, 36 R1,
    12 K4, 12 K5, 12 K2 and 1 A1 a step, and the median step time."""
    model = build_flagship(LONG_SEQ, flash=True, fixed_proj=True,
                           num_heads=heads)
    res["train"], _, _ = train_steps(
        model, train_batch(LONG_BATCH, seed=53, seq=LONG_SEQ), FULL_STEPS,
        {"K1": ENCODERS, "K2": ENCODERS, "K3": ENCODERS, "R1": 3 * ENCODERS,
         "K4": ENCODERS, "K5": ENCODERS, "A1": 1},
        f"learn src4096 --num_heads {heads} at {ENCODERS} encoders",
        falling=False)
    del model
    torch.cuda.empty_cache()


def run_head_dims(record) -> dict:
    """Phase 17: the flash path at every head dim. The kernels at HD_DIMS
    and HD_LONG_CASES against their plain versions; meant_src --num_heads
    4 (d = 192) served, one step's gradients and SRC4_STEPS steps at the
    flagship's width; --num_heads 2 and 1 (d = 384, 768) the same with two
    steps; src4096 at 4, 3 and 2 heads (d = 192, 256, 384: K4 and K5 on
    their wgmma bodies), and at 4 and 2 heads full-depth steps timed;
    --text_dim
    760 (d = 95); --num_heads 3 (d = 256) served and 2 steps, the launches
    of the d = 256 resident rows; the played ring at d = 192. R1, K3, K4
    and K5 against
    their plain versions at the shapes the main path launches them at
    past d = 128: the ring's chunk (40, 1024, 192) and src4096's (40, 4096,
    192), (30, 4096, 256) and (20, 4096, 384), with and without a key
    mask, whose errors time_head_dims' rows print."""
    t0 = time.perf_counter()
    res = {}
    record["head_dims"] = res
    check_head_dims(res)
    check_wide_k2(res)
    out = {"long_errors": check_head_dims_long(res)}
    out["src4"] = run_src_heads(res.setdefault("src_heads4", {}),
                                SRC4_HEADS, REQUEST_ROWS, SRC4_STEPS, True)
    for heads in WIDE_SERVE_HEADS:
        out[f"src{heads}"] = run_src_heads(
            res.setdefault(f"src_heads{heads}", {}), heads, BATCH, 2, True)
    out["src3"] = run_src_heads(res.setdefault("src_heads3", {}), SRC3_HEADS,
                                BATCH, 2, False)
    out["long4"] = run_long_heads(res.setdefault("long_heads4", {}),
                                  SRC4_HEADS)
    out["long3"] = run_long_heads(res.setdefault("long_heads3", {}),
                                  SRC3_HEADS)
    out["long2"] = run_long_heads(res.setdefault("long_heads2", {}),
                                  SRC2_HEADS)
    learn_long_heads_full(res.setdefault("long_heads4_full", {}))
    learn_long_heads_full(res.setdefault("long_heads2_full", {}),
                          SRC2_HEADS)
    out["odd"] = run_odd_width(res.setdefault("text_dim760", {}))
    out["ring4"] = ring_head_dim(res)
    out["ring_errors"] = check_long_kernels(
        res, bh=RING4_BH, kinds=("vision",), tag="ring_d192", s=RING_CHUNK,
        d=192, heads=SRC4_HEADS)
    out["src4096_errors"] = {
        **check_long_kernels(res, bh=RING4_BH, tag="src4096_d192", seed=21,
                             d=192, heads=SRC4_HEADS),
        **check_long_kernels(res, bh=LONG_BATCH * LAG * SRC3_HEADS,
                             tag="src4096_d256", seed=22, d=256,
                             heads=SRC3_HEADS),
        **check_long_kernels(res, bh=LONG_BATCH * LAG * SRC2_HEADS,
                             tag="src4096_d384", seed=25, d=384,
                             heads=SRC2_HEADS)}
    check_k45_chain_call(res)
    res["wall_s"] = time.perf_counter() - t0
    print(f"phase head_dims: {res['wall_s']:.1f} s", flush=True)
    return out


def time_head_dims(out) -> list:
    """The rows of the new head dims, each with the launches of the run
    that reaches it: R1 + K1, K2 and R1 at d = 192 (s=512 causal xPos and
    s=196 pixel rotary, BH = 320: meant_src --num_heads 4), d = 256 (s=512,
    BH = 240: --num_heads 3; s=196, BH = 30: src4096's vision tower at 3
    heads), d = 384 (s=512 and s=196, BH = 160: --num_heads 2), d = 768
    (s=196, BH = 80: --num_heads 1, whose s=512 text tower streams, as JAX
    routes it)
    and d = 95 (s=512, BH = 640: --text_dim 760; K1 and R1 at width 128,
    K2 on the wide body);
    R1 + K3, R1, K4 and K5 at src4096's launch at 4 heads (BH = 40, d =
    192), 3 heads (BH = 30, d = 256) and 2 heads (BH = 20, d = 384), at
    the played ring's chunk at 4
    heads (40, 1024, 192, not causal) and at --num_heads 1's streaming
    s=512 text tower (BH = 80, d = 768); each streaming row's error is its
    kernels' against their plain versions at the row's own shape."""
    from meant_tpu_torch.ops.flash.kernel import kernel_head_dim
    gen = torch.Generator(device="cuda").manual_seed(20)
    rows = []
    long3 = (out["long3"]["serve"], out["long3"]["steps"])
    for kind, s, heads, label, (serve, steps), batch in (
            ("text", SEQ, SRC4_HEADS, "s512 causal xPos d192", out["src4"],
             BATCH),
            ("vision", N_PATCHES, SRC4_HEADS, "s196 pixel rotary d192",
             out["src4"], BATCH),
            ("text", SEQ, 2, "s512 causal xPos d384", out["src2"], BATCH),
            ("vision", N_PATCHES, 1, "s196 pixel rotary d768", out["src1"],
             BATCH),
            ("vision", N_PATCHES, 2, "s196 pixel rotary d384", out["src2"],
             BATCH),
            ("text", SEQ, ODD_HEADS, "s512 causal xPos d95 (--text_dim 760)",
             out["odd"], BATCH),
            ("text", SEQ, SRC3_HEADS, "s512 causal xPos d256", out["src3"],
             BATCH),
            ("vision", N_PATCHES, SRC3_HEADS,
             "s196 pixel rotary d256 (src4096)", long3, LONG_BATCH)):
        d = (ODD_DIM if heads == ODD_HEADS else DIM) // heads
        c = backward_case(kind, torch.bfloat16, gen, s=s,
                          bh=batch * LAG * heads, d=d, heads=heads)
        width = kernel_head_dim(d)
        key = shape_key(s, c["causal"], s, width)
        rows += resident_rows(
            c, label, serve["K1_by_shape"].get(key, 0),
            steps["K2_by_shape"].get(key, 0),
            steps["R1_by_shape"].get(r1_key(s, s, width), 0))
        del c
        torch.cuda.empty_cache()
    rows += time_long_kernels(out["src4096_errors"], out["long4"],
                              bh=RING4_BH, small_bh=SRC4_HEADS,
                              tag="src4096_d192",
                              label="s4096 causal xPos d192", d=192,
                              heads=SRC4_HEADS)
    rows += time_long_kernels(out["src4096_errors"], out["long3"],
                              bh=LONG_BATCH * LAG * SRC3_HEADS,
                              small_bh=SRC3_HEADS, tag="src4096_d256",
                              label="s4096 causal xPos d256", d=256,
                              heads=SRC3_HEADS)
    rows += time_long_kernels(out["src4096_errors"], out["long2"],
                              bh=LONG_BATCH * LAG * SRC2_HEADS,
                              small_bh=SRC2_HEADS, tag="src4096_d384",
                              label="s4096 causal xPos d384", d=384,
                              heads=SRC2_HEADS)
    rows += time_long_kernels(out["ring_errors"], out["ring4"],
                              bh=RING4_BH, tag="ring_d192", kind="vision",
                              label=f"ring chunk s{RING_CHUNK} d192",
                              s=RING_CHUNK, d=192, heads=SRC4_HEADS)
    serve, steps = out["src1"]
    rows += time_long_kernels(
        out["long_errors"],
        {"K3": serve["K3"], "K4": steps["K4"], "K5": steps["K5"],
         "R1": steps["R1_by_shape"].get(r1_key(SEQ, SEQ, DIM), 0)},
        bh=BATCH * LAG, small_bh=BATCH * LAG, tag=f"long_d{DIM}_s{SEQ}",
        label=f"s{SEQ} causal xPos d{DIM} streaming", s=SEQ, d=DIM, heads=1)
    return rows


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


def resident_rows(c, label, fwd_launches, bwd_launches, r1_launches) -> list:
    """The three rows of one resident shape: R1 + K1 (K1 alone beside it)
    against rotation + SDPA, K2 (R1 + K2 beside it) against the SDPA
    backward, and R1; each with its launches on the main path, its error
    against the plain version on the row's own inputs (out, dq, dk and dv
    through flash_mha and autograd held by `hold` at the bars in force, R1
    bit for bit), its bound, its plain version's time, and the source of
    the body its launch ran (the wrapper's `last_source`). A head dim the
    kernels take only padded (`kernel_head_dim`) times K1, K2 and R1 alone
    on the padded inputs, as flash_mha hands them over."""
    from meant_tpu_torch.ops.flash import flash_bwd, flash_fwd
    from meant_tpu_torch.ops.flash.kernel import (CHAIN_SOURCE,
                                                  K1_BF16_REL_L2,
                                                  kernel_head_dim)
    got = run_autograd(c)
    want = [run_plain(c), *run_bwd_plain(c)]
    unit = group_unit(c["kind"], want[1])
    err = {g: hold("R1 + K1" if g == "out" else "R1 + K2", label, g, a, b,
                   c["q"].dtype, K1_BF16_REL_L2, unit)[0]
           for g, a, b in zip(("out", "dq", "dk", "dv"), got, want)}
    rot_err = check_r1_padded(c, label)
    del got, want
    rows = []
    if kernel_head_dim(c["q"].shape[-1]) != c["q"].shape[-1]:
        padded(c)
        rotate, k1, k2 = rotate_padded, k1_padded, k2_padded
    else:
        rotate, k1, k2 = rotate_case, run_k1, run_bwd_k2
    nbytes, flops = attention_cost(c)
    with_r1 = event_ms(lambda: run_kernel(c), iters=20)
    rotate(c)
    k1_ms = event_ms(lambda: k1(c), iters=20)
    library_ms = event_ms(lambda: run_library(c), iters=20)
    print(f"resident forward at {label}: R1 + K1 {with_r1:.4f} ms "
          f"(K1 alone {k1_ms:.4f} ms) against rotation + SDPA's "
          f"{library_ms:.4f} ms ({with_r1 / library_ms:.2f}x)", flush=True)
    rows.append(kernel_row(
        f"flash_fwd[{label}]", flash_fwd.last_source,
        "meant_tpu/ops/flash/kernel.py:89", fwd_launches, err["out"], with_r1,
        event_ms(lambda: run_plain(c), iters=5), library_ms, nbytes, flops,
        PEAK_BF16_FLOPS, shape=list(c["q"].shape), s_k=c["s_k"],
        dtype="bfloat16", k1_alone_ms=k1_ms,
        library_call="rotation + scaled_dot_product_attention"))
    nbytes, flops = attention_cost(c, backward=True)
    library = run_library_bwd(c)
    library_ms = event_ms(library, iters=10)
    rotate(c)
    k2_ms = event_ms(lambda: k2(c), iters=10)
    k2_source = flash_bwd.last_source
    with_r1 = event_ms(lambda: (rotate(c), k2(c)), iters=10)
    chain = {}
    if k2_source == CHAIN_SOURCE:
        # the bound stays the function's (all five products at the bf16
        # tensor peak); beside it, the floor of the body's own design,
        # which sums S and dP (two of the five) by fp32 FMA chains
        chain = dict(chain_floor_ms=2 / 5 * flops / PEAK_FP32_FLOPS * 1e3)
    rows.append(kernel_row(
        f"flash_bwd[{label}]", k2_source,
        "meant_tpu/ops/flash/kernel.py:321", bwd_launches,
        max(err[g] for g in ("dq", "dk", "dv")), k2_ms,
        event_ms(lambda: run_bwd_plain(c), iters=3), library_ms, nbytes,
        flops, PEAK_BF16_FLOPS, shape=list(c["q"].shape), s_k=c["s_k"],
        dtype="bfloat16", r1_plus_k2_ms=with_r1, **chain))
    print(f"resident backward at {label}: K2 {k2_ms:.4f} ms, R1 + K2 "
          f"{with_r1:.4f} ms against the SDPA backward's "
          f"{library_ms:.4f} ms ({with_r1 / library_ms:.2f}x)", flush=True)
    nbytes, flops = rotation_cost(c)
    r1_ms = event_ms(lambda: rotate(c), iters=20)
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


def time_kernels(record, launches_by_shape, train_counts, a1_err, n_params,
                 paper, pretrain, zoo, hf_vqa, ner):
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
            steps["R1_by_shape"].get(f"s{c['s']}", 0))

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
    for name, (count, launches, err) in ner["a1"].items():
        # the NER trainer's A1 runs with no norm (clip_norm=None)
        rows.append(adamw_row(f"adamw[{name}]", count, launches, err, gen,
                              clip=False))
    record["kernels"] = rows
    return rows


def adamw_row(name, n_params, launches, err, gen, mu_bf16=False,
              clip=True):
    """A1 over n_params (with a bf16 first moment when mu_bf16; with no
    norm, as the NER trainer runs it, when not clip): its ms, its plain
    version's and torch.optim.AdamW(fused=True)'s (fp32 moments: torch has
    no bf16 one)."""
    from meant_tpu_torch.ops.adamw import (adamw_reference, update_scalars,
                                           adamw_update)
    p, g, m, v = adamw_case(n_params, gen)
    if mu_bf16:
        m = m.to(torch.bfloat16)
    norm = torch.linalg.vector_norm(g) if clip else None
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
        m_dtype="bfloat16" if mu_bf16 else "float32", clipped=clip)
    del p, g, m, v, param, library
    torch.cuda.empty_cache()
    return row


def long_cost(c, kernel: str) -> tuple:
    """(bytes, flops) a streaming launch must move and compute, each input
    read once and each output written once: K3 reads qr, kr, v and writes o
    and lse (its tables are on R1's row); K4 reads qr, kr, v, dO, lse,
    delta and the q tables (the adjoint's) and writes dq; K5 reads the same
    and writes dk, dv; K4 + K5 in one call ("K4+K5", the chain body's)
    reads them once and writes dq, dk, dv; the tables counted as four.
    Products over the causal triangle: 2 (K3: S, PV), 3 (K4: S, dP, dS
    Kr), 4 (K5: S, dP, P^T dO, dS^T Qr), 5 (K4+K5: S and dP once)."""
    q = c["q"]
    bh, s, d = q.shape[0] * q.shape[1], c["s"], q.shape[-1]
    tensors = {"K3": 4, "K4": 5, "K5": 6, "K4+K5": 7}[kernel]
    rows = {"K3": 1, "K4": 2, "K5": 2, "K4+K5": 2}[kernel]
    tables = 0 if kernel == "K3" else sum(t.numel() * 4 for t in c["tables"])
    nbytes = tensors * q.numel() * q.element_size() + rows * bh * s * 4
    nbytes += tables
    pairs = s * (s + 1) // 2 if c["causal"] else s * s
    products = {"K3": 2, "K4": 3, "K5": 4, "K4+K5": 5}[kernel]
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
                      label="s4096 causal xPos", kind="text", **shape):
    """R1 + K3, R1, K4 and K5 at the main path's launch (BH=80, s=4096,
    bf16, causal xPos; or the BH, head dim, length and `long_case` kind
    given): ms per launch,
    bound, plain version, and the yardstick: rotation + causal SDPA (R1 +
    K3 together; K3 alone beside it), its backward (R1, K4 and K5
    together); R1 has no single PyTorch call of its own."""
    from meant_tpu_torch.ops.flash.kernel import CHAIN_SOURCE
    gen = torch.Generator(device="cuda").manual_seed(9)
    big = long_case(kind, torch.bfloat16, gen, bh, **shape)
    small = long_case(kind, torch.bfloat16, gen, small_bh, **shape)
    rotate_case(big)
    shape, rows = list(big["q"].shape), []
    library_fwd = event_ms(lambda: run_library(big), iters=10)
    library = run_library_bwd(big)
    library_bwd = event_ms(library, iters=5)
    del library
    torch.cuda.empty_cache()
    plans = (
        ("K3", "flash_fwd_online", "meant_tpu/ops/flash/kernel.py:127",
         run_online_kernel, run_online_plain, f"{tag}_{kind}/bfloat16/out",
         library_fwd, 10),
        ("K4", "flash_bwd_dq", "meant_tpu/ops/flash/kernel.py:456",
         run_online_dq_kernel, run_online_dq_plain,
         f"{tag}_{kind}/bfloat16/dq", library_bwd, 5),
        ("K5", "flash_bwd_dkdv", "meant_tpu/ops/flash/kernel.py:527",
         run_online_dkdv_kernel, run_online_dkdv_plain,
         (f"{tag}_{kind}/bfloat16/dk", f"{tag}_{kind}/bfloat16/dv"),
         library_bwd, 5))
    for (kernel, name, replaces, run, plain, err_keys, library_ms,
         iters) in plans:
        ms = event_ms(lambda: run(big), iters=iters)
        source = wrappers()[kernel].last_source
        extra = {}
        if kernel == "K3":     # the row is R1 + K3; K3 alone beside it
            extra["k3_alone_ms"] = event_ms(lambda: run_online_k3(big),
                                            iters=iters)
            print(f"streaming forward at {label}: R1 + K3 "
                  f"{ms:.4f} ms (K3 alone {extra['k3_alone_ms']:.4f} ms) "
                  f"against rotation + SDPA's {library_ms:.4f} ms "
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
    k4, k5 = rows[1], rows[2]
    # K4 + K5 as the main path launches them: one call on the chain body
    k5["k4_k5_ms"] = event_ms(lambda: run_online_k45(big), iters=5)
    k5["k4_k5_bound_ms"] = k4["bound_ms"] + k5["bound_ms"]
    if k4["source"] == CHAIN_SOURCE:
        # one call: its inputs read once, the three gradients written, the
        # five products; beside that bound the chain body's own floor: S
        # and dP of every tile pair it forms (the causal triangle's) summed
        # by fp32 FMAs, once for K4 or K5 alone and once for both
        nbytes, flops = long_cost(big, "K4+K5")
        k5["k4_k5_bound_ms"] = max(nbytes / PEAK_BYTES_PER_S,
                                   flops / PEAK_BF16_FLOPS) * 1e3
        n = -(-big["s"] // 64)
        pairs = n * (n + 1) // 2 if big["causal"] else n * n
        fmas = 2 * shape[0] * shape[1] * pairs * 64 * 64 * shape[-1]
        floor = 2 * fmas / PEAK_FP32_FLOPS * 1e3
        k4["chain_floor_ms"] = k5["chain_floor_ms"] = floor
        k5["k4_k5_chain_floor_ms"] = floor
    print(f"K4 + K5 at {label}: {k5['k4_k5_ms']:.4f} ms together (K4 "
          f"{k4['ms']:.4f} + K5 {k5['ms']:.4f} apart; bound "
          f"{k5['k4_k5_bound_ms']:.4f} ms) against the SDPA backward's "
          f"{library_bwd:.4f} ms ({k5['k4_k5_ms'] / library_bwd:.2f}x); "
          f"bodies {k4['source']}, {k5['source']}", flush=True)
    nbytes, flops = rotation_cost(big)
    rows.insert(1, kernel_row(
        f"rotate_qk[{label}]",
        "meant_tpu_torch/csrc/flash_bwd_online.cu",
        "meant_tpu/ops/flash/kernel.py:152", long_counts["R1"],
        long_errors[f"{tag}_{kind}/bfloat16/rot"],
        event_ms(lambda: rotate_case(big), iters=20),
        event_ms(lambda: rotate_plain(big), iters=5), None, nbytes, flops,
        PEAK_FP32_FLOPS, shape=shape, dtype="bfloat16",
        library_call=None))
    backward = rows[1]["ms"] + k5["k4_k5_ms"]
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
    for name, log in logs.items():     # ptxas -v: registers and spills
        function = ""                    # of each entry function
        for line in log.splitlines():
            if "Compiling entry function" in line or (
                    "Function properties for" in line):
                function = (line.split("'")[1] if "'" in line
                            else line.split()[-1])
            elif "registers" in line or "spill" in line:
                print(f"  {name}: {function}: {line.strip()}")
    record["hgmma"] = {name: count_hgmma(name) for name in WGMMA_LIBRARIES}
    record["hgmma"]["K1"] = count_hgmma("flash_fwd", "flash_fwd_wgmma_kernel")

    check_kernel(record)
    check_backward(record)
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
    ner = run_ner(record)
    buckets = run_buckets(record)
    layouts = run_layouts(record)
    head_dims = run_head_dims(record)
    rows = time_kernels(record, by_shape, train_counts, a1_err,
                        record["n_params"], paper, pretrain, zoo, hf_vqa, ner)
    at = [r["name"] for r in rows].index("adamw")
    rows[at:at] = time_long_kernels(long_errors, long_counts)  # before A1
    rows += time_shapes(shapes, record["n_params"])
    rows += time_buckets(buckets)
    rows += time_layouts(layouts)
    rows += time_head_dims(head_dims)
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
