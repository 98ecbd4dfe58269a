#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (meant_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--out DIR]

Phases, in order; any failure raises and the script exits non-zero:

1. build   -- nvcc builds every kernel of the serving path from csrc/.
2. kernels -- each kernel's wrapper against its plain PyTorch version on
              the card, at the main path's shapes, fp32 and bf16.
3. slice   -- flagship meant_src (768 wide, 8 heads of 96, 12+12 encoders,
              s=512 text, 196-patch charts, bf16, seeded random weights)
              serves 40 rows through Predictor(batch_size=16): three
              requests, the last padded. The kernel's launch count must
              rise by exactly 3 x 24 and the probabilities must be finite
              and agree with the plain attention (towers and probabilities,
              at fixed_proj False and True).
4. timing  -- median request time, the kernel's time per launch at both
              shapes beside its bound, its plain version's time and that
              of rotation + torch's scaled_dot_product_attention (a
              yardstick the port never calls).
5. profile -- torch.profiler over 3 forwards of one 16-row request: device
              time per forward by kind (the flash kernel, matrix products,
              the rest), the device's idle share, and the top kernels.

It prints the card's name and power limit, one JSON line describing each
kernel, and last `{"ok": true, "device": {...}}`. `--out DIR` also writes
the full record (with nvcc's register report and the profile) to
DIR/chip_smoke.json.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s of HBM3 and bf16
# tensor-core FLOP/s.
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12

BATCH, LAG, SEQ, IMAGE, PATCH, HEADS, DIM = 16, 5, 512, 224, 16, 8, 768
HEAD_DIM = DIM // HEADS
N_PATCHES = (IMAGE // PATCH) ** 2
ENCODERS = 12
REQUEST_ROWS = 40          # three requests at batch 16, the last padded
PROFILE_FORWARDS = 3

# Bars. fp32: the kernel and the plain version differ only in summation
# order (online vs two-pass softmax). bf16: P is rounded to bf16 before P@V
# at a running max in the kernel and after normalising in the plain
# version, one bf16 step (2^-8 relative) apart; each element is held to
# 2e-2 relative + absolute, and the whole output to BF16_REL_L2 relative L2.
FP32_RTOL, FP32_ATOL = 1e-4, 1e-5
BF16_TOL = 2e-2
# The slice in bf16, flash kernel vs plain attention through 12 layers:
# relative L2 error of each tower's output, and absolute error of the
# probabilities (sigmoid outputs; one bf16 step near 0.5 is 3.9e-3).
TOWER_REL_L2 = 3e-2
PROBS_ATOL = 2e-2


def fail(msg: str):
    raise RuntimeError(f"chip_smoke: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def event_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of fn() in ms over `iters` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---- phase 2: the kernel against its plain version ---------------------

def attention_case(kind: str, dtype, gen):
    """Inputs of one attention launch at the main path's shapes:
    (b*lag, heads, s, 96) q/k/v, tables, mask."""
    from meant_tpu_torch.ops import lang_freqs, pixel_freqs
    from meant_tpu_torch.ops.flash.flash_attention import _tables

    s = N_PATCHES if kind == "vision" else SEQ
    shape = (BATCH * LAG, HEADS, s, HEAD_DIM)
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
        lengths = torch.randint(1, s + 1, (BATCH * LAG,), generator=gen,
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


def check_kernel(record):
    from meant_tpu_torch.ops.flash.kernel import BF16_REL_L2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    errors, rels = {}, {}
    for kind in ("text", "vision", "text_masked"):
        for dtype in (torch.float32, torch.bfloat16):
            c = attention_case(kind, dtype, gen)
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
                                     atol=BF16_TOL) and rel <= BF16_REL_L2)
                bar = f"rtol/atol {BF16_TOL}, rel L2 {BF16_REL_L2}"
            name = f"{kind}/{str(dtype).split('.')[-1]}"
            print(f"kernel vs plain {name}: max_abs_err {err:.3e} rel_l2 "
                  f"{rel:.3e} ({bar}) {'ok' if ok else 'FAIL'}", flush=True)
            if not ok or not torch.isfinite(out).all():
                fail(f"kernel disagrees with its plain version ({name}, "
                     f"max abs err {err})")
            errors[name], rels[name] = err, rel
            del c, out, ref
    record["kernel_vs_plain_max_abs_err"] = errors
    record["kernel_vs_plain_rel_l2"] = rels
    return errors


# ---- phase 3: the slice ------------------------------------------------

def build_flagship(**kw):
    from meant_tpu_torch.models import EmbeddingConfig, meant_src
    return meant_src(text_dim=DIM, image_dim=DIM, price_dim=5, height=IMAGE,
                     width=IMAGE, patch_res=PATCH, lag=LAG, num_classes=2,
                     embedding=EmbeddingConfig(), num_heads=HEADS,
                     num_encoders=ENCODERS, channels=3, seq_len=SEQ,
                     dtype=torch.bfloat16, device="cuda", seed=0, **kw)


def request_batch(n: int, seed: int = 0):
    rng = np.random.RandomState(seed)
    return {
        "input_ids": rng.randint(2, 64000, size=(n, LAG, SEQ)).astype(
            np.int32),
        "pixels": rng.randn(n, LAG, 3, IMAGE, IMAGE).astype(np.float32),
        "prices": rng.randn(n, LAG, 5).astype(np.float32),
        "attention_mask": np.ones((n, LAG, SEQ), np.float32),
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
    flash_fwd.launches = 0
    flash_fwd.launches_by_shape.clear()
    probs = predictor(batch)
    torch.cuda.synchronize()
    launches = flash_fwd.launches
    by_shape = dict(flash_fwd.launches_by_shape)
    n_requests = -(-REQUEST_ROWS // BATCH)
    want = n_requests * 2 * ENCODERS
    print(f"served {REQUEST_ROWS} rows in {n_requests} requests: probs "
          f"{probs.shape}, flash_fwd launches {launches} (want {want}), by "
          f"(s, causal) {by_shape}; {n_params} parameters", flush=True)
    if launches != want:
        fail(f"flash_fwd launched {launches} times, want {want}")
    if probs.shape != (REQUEST_ROWS, 2) or not np.isfinite(probs).all():
        fail(f"bad probabilities {probs.shape}")
    if not ((probs > 0) & (probs < 1)).all():
        fail("sigmoid outputs outside (0, 1)")
    record.update(n_params=n_params, launches=launches,
                  launches_by_shape={f"s{s} causal={c}": n
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


# ---- phase 4: timing ---------------------------------------------------

def attention_cost(c) -> tuple:
    """(bytes, flops) the launch must move and compute: q, k, v read once,
    o written once, tables and mask read once; QK^T and P@V over the
    causal triangle (s(s+1)/2 pairs) or the full square."""
    q = c["q"]
    bh = q.shape[0] * q.shape[1]
    s, d = c["s"], q.shape[-1]
    nbytes = 4 * q.numel() * q.element_size()
    nbytes += sum(t.numel() * 4 for t in c["tables"])
    if c["mask"] is not None:
        nbytes += c["mask"].numel() * 4
    pairs = s * (s + 1) // 2 if c["causal"] else s * s
    return nbytes, 4 * bh * pairs * d


def time_kernels(record, errors, launches_by_shape):
    from meant_tpu_torch.ops.flash import flash_fwd
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = []
    for kind, label in (("text", "s512 causal xPos"),
                        ("vision", "s196 pixel rotary")):
        c = attention_case(kind, torch.bfloat16, gen)
        before = flash_fwd.launches
        ms = event_ms(lambda: run_kernel(c), iters=20)
        timed = flash_fwd.launches - before
        plain_ms = event_ms(lambda: run_plain(c), iters=5)
        library_ms = event_ms(lambda: run_library(c), iters=20)
        nbytes, flops = attention_cost(c)
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_BF16_FLOPS * 1e3
        key = (c["s"], c["causal"])
        rows.append({
            "name": f"flash_fwd[{label}]", "route": "cuda",
            "source": "meant_tpu_torch/csrc/flash_fwd.cu",
            "replaces": "meant_tpu/ops/flash/kernel.py:89",
            "launches": launches_by_shape.get(key, 0),
            "max_abs_err": errors[f"{kind}/bfloat16"],
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms,
            "shape": list(c["q"].shape), "dtype": "bfloat16",
            "bytes": nbytes, "flops": flops, "timed_launches": timed,
        })
        del c
    record["kernels"] = rows
    return rows


def time_requests(predictor, chunk, record, iters: int = 7):
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
    print(f"request (16 rows, host clock incl. copies) median "
          f"{statistics.median(times):.3f} ms over {iters}: "
          f"{[round(t, 3) for t in times]}; forward alone (device events) "
          f"{fwd_ms:.3f} ms", flush=True)


# ---- phase 5: where a request's device time goes -----------------------

def _kind(name: str) -> str:
    low = name.lower()
    if "flash_fwd" in low:
        return "flash_fwd (K1)"
    if any(t in low for t in ("gemm", "xmma", "cutlass", "sm90", "cublas",
                              "nvjet")):
        return "matrix products"
    return "other (elementwise, norms, copies, reductions)"


def profile_forward(predictor, chunk, record):
    """Device time per forward by kernel and kind, from torch.profiler's
    device-side events (kernels, copies); the host-side ops above them
    would count the same time again."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    predictor.forward(chunk)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILE_FORWARDS):
            predictor.forward(chunk)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / PROFILE_FORWARDS
    kernels = sorted(
        ((e.key, e.self_device_time_total / 1e3 / PROFILE_FORWARDS,
          e.count // PROFILE_FORWARDS)
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
    record["profile"] = {
        "forwards": PROFILE_FORWARDS, "rows": BATCH,
        "device_ops_per_forward": launches,
        "wall_ms_per_forward": wall_ms, "device_busy_ms_per_forward": busy,
        "device_idle_share": idle, "by_kind_ms_per_forward": by_kind,
        "top_kernels": [{"name": k[:120], "ms_per_forward": ms, "calls": n}
                        for k, ms, n in kernels[:25]]}
    print(f"profile, per forward of {BATCH} rows: wall {wall_ms:.3f} ms, "
          f"device busy {busy:.3f} ms in {launches} kernels and copies, "
          f"idle share {idle:.3f}", flush=True)
    for kind, ms in sorted(by_kind.items(), key=lambda kv: -kv[1]):
        print(f"  {kind}: {ms:.3f} ms ({ms / busy:.1%})")
    for name, ms, n in kernels[:12]:
        print(f"  {ms:9.3f} ms x{n:<5} {name[:100]}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="directory for chip_smoke.json (full record)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    from meant_tpu_torch.cuda_build import build

    t_start = time.perf_counter()
    card = card_line()
    record = {"card": card, "device": torch.cuda.get_device_name(0),
              "torch": torch.__version__, "cuda": torch.version.cuda}
    print(f"card: {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    log = build("flash_fwd")
    record["build_s"] = time.perf_counter() - t0
    record["nvcc_log"] = log
    print(f"phase build: {record['build_s']:.1f} s", flush=True)
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  flash_fwd: {line.strip()}")

    errors = check_kernel(record)
    predictor, chunk, by_shape = run_slice(record)
    rows = time_kernels(record, errors, by_shape)
    time_requests(predictor, chunk, record)
    profile_forward(predictor, chunk, record)
    for r in rows:
        print(f"{r['name']}: {r['ms']:.4f} ms/launch (bound "
              f"{r['bound_ms']:.4f} ms by {r['bound_by']}, plain "
              f"{r['plain_ms']:.4f} ms, rotation+SDPA "
              f"{r['library_ms']:.4f} ms) on {card}", flush=True)
    record["wall_s"] = time.perf_counter() - t_start
    if args.out:
        import os
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
