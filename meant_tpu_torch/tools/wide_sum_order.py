"""The order of the wide bodies' sums over the head dim, on the card.

    python -m meant_tpu_torch.tools.wide_sum_order     (from the repo root)

The wide bodies (csrc/flash_wide.cuh) form S = Qr Kr^T and dP = dO V^T
over the whole head dim before P and dS are rounded to bf16. At d = 768 a
small change in those fp32 sums flips the rounding of single dS entries,
and one flip moves a dq element by some 0.025, past the gradients'
element bar (2e-2 + 2e-2 |ref|) where the element is small. This builds
the backwards' wide bodies with three orders of that sum (`dp_mm`), runs
them at chip_smoke.py's two d = 768 cases, and holds their gradients to
the plain versions; then it holds plain versions that sum in other
orders to the plain version itself:

* fma_chain: scalar FMAs in column order (the source as it is);
* tensor_cores: mma.sync m16n8k16 chained through one fp32 accumulator;
* k16_from_zero: each k16 step's mma.sync into zero, added in fp32;
* plain_fp64: the plain version with S and dP summed in fp64;
* plain_k16: the plain version with S and dP summed from exact 16-column
  partials, added in column order in fp32.

The cases, bf16, made as chip_smoke.py makes them:

* K4 + K5 at (80, 512, 768) causal xPos with a key mask
  (check_head_dims_long's, the shape --num_heads 1 streams its text tower
  at) and K2 at (80, 196, 768) pixel rotary (time_head_dims' row for
  --num_heads 1's charts);
* K4 + K5 at the streaming widths 192 and 256: check_head_dims_long's
  (4, 4096, 192) and (4, 4096, 256) causal xPos with a key mask,
  src4096's launch at --num_heads 4, (40, 4096, 192) causal xPos
  (time_long_kernels'), and the played ring's chunk at that width, (40,
  1024, 192) pixel rotary, not causal;
* K3 (out and lse, from R1's Qr and Kr) at src4096's launches at
  --num_heads 4 and 3, (40, 4096, 192) and (30, 4096, 256) causal xPos,
  each with and without a key mask, and at the ring's chunk (40, 1024,
  192), not causal; out held to the element bar 2e-2 + 2e-2 |ref|,
  BF16_REL_L2 and, against K3's tiled plain version, K3_TILED_REL_L2;
  lse to LSE_ATOL;
* K2 at meant_src --num_heads 4's launches (320, 512, 192) causal xPos
  with a key mask and (320, 196, 192) pixel rotary, and at d = 256:
  src4096 --num_heads 3's vision tower (30, 196, 256) and meant_src
  --num_heads 3's text tower (240, 512, 256) causal xPos with a key mask;
  at d = 384 (--num_heads 2) its (160, 512, 384) causal xPos with a key
  mask and (160, 196, 384) pixel rotary, and K4 + K5 at
  check_head_dims_long's (4, 4096, 384) with a key mask;
* K1 (R1 + K1 through flash_mha, out only) at the resident launches past
  d = 128: (320, 512, 192), (240, 512, 256) and (160, 512, 384) causal
  xPos with a key mask, (320, 196, 192) and (80, 196, 768) pixel rotary;
  out held to the element bar and K1_BF16_REL_L2;
* K3 at --num_heads 1's streaming text tower (80, 512, 768) causal xPos
  with a key mask and at check_head_dims_long's (4, 4096, 384) with a key
  mask, at K3's bars as above.

`--cases` runs only the cases whose name holds one of the words given
(`k1`, `k3`, `k2`, `192`, ...). Each line names the body its kernels ran
(the wrappers' last_source): where a wgmma body takes a width (csrc/
flash_fwd.cu, flash_bwd.cu, flash_bwd_wgmma.cuh: bf16 at 192 and 256,
K1's and K3's at 384 and 768, and K2's at 384) or K2's chain body takes
768 (csrc/flash_bwd_chain.cuh, whose own FMA chains sum in column order),
the patch of dp_mm does not reach it, and all three orders read that
body's own sums.

`--cases chain` (also run without `--cases`) holds the chain body to the
wide body it replaced: it builds a patched flash_bwd whose takes_wide
still sends K2 in bf16 at 768 to the wide body (`WIDE_K2_768`), runs K2
alone on both at (80, 196, 768) pixel rotary (the case above) and at
chip_smoke.py phase 17's masked d = 768 case (check_head_dims' (16, 200,
768) causal xPos with a key mask), and compares the statistics planes m,
1/l and delta bit for bit and dq, dk, dv at the element bar (each body's
also against the plain version).
"""

from __future__ import annotations

import argparse
import json

import torch

import chip_smoke
from meant_tpu_torch import cuda_build
from meant_tpu_torch.ops.flash import kernel
from meant_tpu_torch.tools.k2_faults import patched_sources, use_sources

_SIGNATURE = ("__device__ __forceinline__ void dp_mm(float (&c)[NT][4], "
              "const bf16* A,\n" + " " * 38 + "int lda, const bf16* B, "
              "int ldb) {")

# the bodies of dp_mm's bf16 overload for the other orders
BODIES = {
    "tensor_cores": """
  warp_mm<NT, K>(c, A, lda, B, ldb);
}
""",
    "k16_from_zero": """
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kc = 0; kc < K / 16; ++kc) {
    const bf16* a = A + g * lda + kc * 16 + 2 * t;
    const uint32_t af[4] = {ld_pair(a), ld_pair(a + 8 * lda), ld_pair(a + 8),
                            ld_pair(a + 8 * lda + 8)};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const bf16* b = B + (j * 8 + g) * ldb + kc * 16 + 2 * t;
      float step[4] = {0.f, 0.f, 0.f, 0.f};
      mma_bf16(step, af, ld_pair(b), ld_pair(b + 8));
#pragma unroll
      for (int e = 0; e < 4; ++e) c[j][e] = __fadd_rn(c[j][e], step[e]);
    }
  }
}
"""}
# the libraries of the forwards and backwards, which the orders are built
# into (the streaming case's plain backward takes the kernels' own lse and
# delta)
LIBRARIES = {"flash_fwd": ("flash_fwd", "flash_fwd_online"),
             "flash_bwd": ("flash_bwd",),
             "flash_bwd_online": ("rotate_qk", "flash_bwd_dq",
                                  "flash_bwd_dkdv")}


# K2 in bf16 at 768 back on the wide body
WIDE_K2_768 = [(
    "flash_wide.cuh",
    "if (dp == 384 || dp == 768) return kernel == kK4 || kernel == kK5;",
    "if (dp == 384 || dp == 768)\n"
    "    return kernel == kK4 || kernel == kK5 || (kernel == kK2 && dp == 768);")]


def order_patch(order: str) -> list:
    """(file, old, new) replacing the body of dp_mm's bf16 overload."""
    text = (cuda_build.PACKAGE_DIR / "csrc" / "flash_wide.cuh").read_text()
    start = text.index(_SIGNATURE) + len(_SIGNATURE)
    end = text.index("\n}\n", start) + 3
    return [("flash_wide.cuh", text[start:end], BODIES[order])]


def use_order(order: str) -> None:
    """Build and load the backwards' libraries with `order` from now
    on."""
    root = (patched_sources(order, {order: order_patch(order)})
            if order in BODIES else cuda_build.PACKAGE_DIR)
    for library, names in LIBRARIES.items():
        use_sources(root, library, [getattr(kernel, n) for n in names])


# check_head_dims_long's masked bf16 case at each of these widths
STREAMING = {768: "k4_k5 (80, 512, 768) masked",
             192: "k4_k5 (4, 4096, 192) masked",
             256: "k4_k5 (4, 4096, 256) masked",
             384: "k4_k5 (4, 4096, 384) masked"}
# time_long_kernels' launches at d = 192 (its seed, its order of draws):
# (name, long_case kind, BH, s)
LAUNCHES = (("k4_k5 (40, 4096, 192) src4096", "text",
             chip_smoke.RING4_BH, chip_smoke.LONG_SEQ),
            ("k4_k5 (40, 1024, 192) ring chunk", "vision",
             chip_smoke.RING4_BH, chip_smoke.RING_CHUNK))

# K3 at the main path's streaming launches past d = 128: (name, long_case
# kind, BH, s, d, heads)
_SRC4, _SRC3 = chip_smoke.SRC4_HEADS, chip_smoke.SRC3_HEADS
_LONG_ROWS = chip_smoke.LONG_BATCH * chip_smoke.LAG
_ROWS = chip_smoke.BATCH * chip_smoke.LAG
_SEQ, _HD_BH = chip_smoke.SEQ, chip_smoke.HD_LONG_BH
K3_CASES = tuple(
    (f"k3 ({_LONG_ROWS * heads}, {chip_smoke.LONG_SEQ}, {d}) src4096"
     + (" masked" if kind == "text_masked" else ""), kind,
     _LONG_ROWS * heads, chip_smoke.LONG_SEQ, d, heads)
    for d, heads in ((192, _SRC4), (256, _SRC3))
    for kind in ("text", "text_masked")) + (
    (f"k3 ({_LONG_ROWS * _SRC4}, {chip_smoke.RING_CHUNK}, 192) ring chunk",
     "vision", _LONG_ROWS * _SRC4, chip_smoke.RING_CHUNK, 192, _SRC4),
    (f"k3 ({_ROWS}, {_SEQ}, 768) masked", "text_masked", _ROWS, _SEQ, 768,
     1),
    (f"k3 ({_HD_BH}, {chip_smoke.LONG_SEQ}, 384) masked", "text_masked",
     _HD_BH, chip_smoke.LONG_SEQ, 384, chip_smoke.HD_HEADS))
# K2 at the resident launches past d = 128: (name, backward_case kind, BH,
# s, d, heads)
K2_CASES = (
    (f"k2 ({_ROWS * _SRC4}, {chip_smoke.SEQ}, 192) masked", "text_masked",
     _ROWS * _SRC4, chip_smoke.SEQ, 192, _SRC4),
    (f"k2 ({_ROWS * _SRC4}, {chip_smoke.N_PATCHES}, 192) pixel", "vision",
     _ROWS * _SRC4, chip_smoke.N_PATCHES, 192, _SRC4),
    (f"k2 ({_LONG_ROWS * _SRC3}, {chip_smoke.N_PATCHES}, 256) pixel",
     "vision", _LONG_ROWS * _SRC3, chip_smoke.N_PATCHES, 256, _SRC3),
    (f"k2 ({_ROWS * _SRC3}, {chip_smoke.SEQ}, 256) masked", "text_masked",
     _ROWS * _SRC3, chip_smoke.SEQ, 256, _SRC3),
    (f"k2 ({_ROWS * 2}, {_SEQ}, 384) masked", "text_masked", _ROWS * 2, _SEQ,
     384, 2),
    (f"k2 ({_ROWS * 2}, {chip_smoke.N_PATCHES}, 384) pixel", "vision",
     _ROWS * 2, chip_smoke.N_PATCHES, 384, 2))
# K1 at the resident launches past d = 128: (name, backward_case kind, BH,
# s, d, heads)
K1_CASES = tuple(
    (f"k1 ({_ROWS * heads}, {s}, {chip_smoke.DIM // heads}) "
     + ("masked" if kind == "text_masked" else "pixel"), kind,
     _ROWS * heads, s, chip_smoke.DIM // heads, heads)
    for kind, s, heads in (("text_masked", _SEQ, _SRC4),
                           ("text_masked", _SEQ, _SRC3),
                           ("text_masked", _SEQ, 2),
                           ("vision", chip_smoke.N_PATCHES, _SRC4),
                           ("vision", chip_smoke.N_PATCHES, 1)))


def cases(words=None):
    """chip_smoke.py's cases, from its seeds and its order of draws (K3's
    and the new K2 cases at its shapes, from seed 19; K1's from seed 23),
    those whose name holds one of `words` (all without)."""
    made = {}
    gen = torch.Generator(device="cuda").manual_seed(18)
    for d, s, bh, heads in chip_smoke.HD_LONG_CASES:
        for kind in ("text", "text_masked"):
            for dtype in (torch.float32, torch.bfloat16):
                c = chip_smoke.backward_case(kind, dtype, gen, s=s, bh=bh,
                                             d=d, heads=heads)
                c["g_lse"] = torch.randn(c["q"].shape[:3], generator=gen,
                                         device="cuda")
                if (kind, dtype) == ("text_masked", torch.bfloat16) and (
                        d in STREAMING):
                    made[STREAMING[d]] = c
    gen = torch.Generator(device="cuda").manual_seed(20)
    for kind, s, heads in (("text", chip_smoke.SEQ, 4),
                           ("vision", chip_smoke.N_PATCHES, 4),
                           ("text", chip_smoke.SEQ, 2),
                           ("vision", chip_smoke.N_PATCHES, 1)):
        d = chip_smoke.DIM // heads
        c = chip_smoke.backward_case(
            kind, torch.bfloat16, gen, s=s,
            bh=chip_smoke.BATCH * chip_smoke.LAG * heads, d=d, heads=heads)
    made["k2 (80, 196, 768) pixel"] = c
    for name, kind, bh, s in LAUNCHES:
        gen = torch.Generator(device="cuda").manual_seed(9)
        c = chip_smoke.backward_case(kind, torch.bfloat16, gen, s=s, bh=bh,
                                     d=192, heads=chip_smoke.SRC4_HEADS)
        c["g_lse"] = torch.randn(c["q"].shape[:3], generator=gen,
                                 device="cuda")
        made[name] = c
    gen = torch.Generator(device="cuda").manual_seed(19)
    for name, kind, bh, s, d, heads in K3_CASES:
        made[name] = chip_smoke.long_case(kind, torch.bfloat16, gen, bh, s=s,
                                          d=d, heads=heads)
    for name, kind, bh, s, d, heads in K2_CASES:
        made[name] = chip_smoke.backward_case(kind, torch.bfloat16, gen, s=s,
                                              bh=bh, d=d, heads=heads)
    gen = torch.Generator(device="cuda").manual_seed(23)
    for name, kind, bh, s, d, heads in K1_CASES:
        made[name] = chip_smoke.attention_case(kind, torch.bfloat16, gen,
                                               s=s, bh=bh, d=d, heads=heads)
    if words:
        made = {n: c for n, c in made.items() if any(w in n for w in words)}
    return made


def errors(a, b) -> dict:
    """rel L2, max abs error and the elements past the gradients' element
    bar."""
    a, b = a.double(), b.double()
    bar = kernel.BWD_BF16_ATOL + chip_smoke.BF16_TOL * b.abs()
    past = (a - b).abs() > bar
    return {"rel_l2": ((a - b).norm() / b.norm()).item(),
            "max_abs": (a - b).abs().max().item(),
            "past_element_bar": int(past.sum())}


def k3_errors(c) -> dict:
    """R1 + K3's out against the plain version (the element bar, and
    whether BF16_REL_L2 holds) and against its tiled order
    (K3_TILED_REL_L2), lse's max abs error (LSE_ATOL), and the body K3
    ran."""
    out, lse = chip_smoke.run_online_kernel(c)
    res = {"out": errors(out, c["out"])}
    res["out"]["within_rel_l2_bar"] = (
        res["out"]["rel_l2"] <= kernel.BF16_REL_L2)
    tiled = chip_smoke.rel_l2(out, chip_smoke.run_online_tiled_plain(c))
    res["out_tiled"] = {"rel_l2": tiled,
                        "within_bar": tiled <= kernel.K3_TILED_REL_L2}
    lse_err = (lse - c["lse"]).abs().max().item()
    res["lse"] = {"max_abs": lse_err, "within_bar": lse_err <=
                  kernel.LSE_ATOL}
    res["body"] = kernel.flash_fwd_online.last_source
    return res


def k1_errors(c) -> dict:
    """R1 + K1's out through flash_mha against the plain version (the
    element bar, and whether K1_BF16_REL_L2 holds), and the body K1
    ran."""
    res = errors(chip_smoke.run_kernel(c), chip_smoke.run_plain(c))
    res["within_rel_l2_bar"] = res["rel_l2"] <= kernel.K1_BF16_REL_L2
    res["body"] = kernel.flash_fwd.last_source
    return res


def kernel_grads(name, c):
    """(dq, dk, dv) through the kernels and the plain versions' (dq, dk,
    dv) on the same inputs (the streaming case's plain backward fed the
    kernels' lse and delta), and the lse and delta used."""
    if name.startswith("k4"):
        out, lse, *got = chip_smoke.run_online_autograd(c)
        delta = (c["do"].float() * out.float()).sum(-1) - c["g_lse"]
        want = kernel.flash_mha_bwd_online_reference(
            c["q"], c["k"], c["v"], c["do"], lse, delta, c["mask"],
            *c["tables"], scale=c["scale"], causal=c["causal"])
        return got, want, (lse, delta)
    got = chip_smoke.run_autograd(c)[1:]
    return got, chip_smoke.run_bwd_plain(c), None


def product(order: str):
    f32, f64 = torch.float32, torch.float64

    def plain(a, b):
        return torch.matmul(a.to(f32), b.to(f32).transpose(-1, -2))

    def fp64(a, b):
        return torch.matmul(a.to(f64), b.to(f64).transpose(-1, -2)).to(f32)

    def k16(a, b):
        acc = None
        for k0 in range(0, a.shape[-1], 16):
            part = fp64(a[..., k0:k0 + 16], b[..., k0:k0 + 16])
            acc = part if acc is None else acc + part
        return acc

    return {"plain": plain, "plain_fp64": fp64, "plain_k16": k16}[order]


def plain_dq(c, order: str, stats) -> torch.Tensor:
    """The plain version's dq, step by step as flash_mha_bwd_reference (K2)
    or flash_mha_bwd_online_dq_reference (K4, `stats` = (lse, delta)),
    with S and dP summed in `order`."""
    f32, dt = torch.float32, c["q"].dtype
    mm = product(order)
    qcos, qsin, kcos, ksin = c["tables"]
    qr = kernel._rotate(c["q"], qcos, qsin)
    kr = kernel._rotate(c["k"], kcos, ksin)
    scores = mm(qr, kr) * c["scale"]
    if c["causal"]:
        n = scores.shape[-1]
        scores = scores.masked_fill(
            torch.ones(n, n, dtype=torch.bool, device="cuda").triu(1),
            float("-inf"))
    if c["mask"] is not None:
        scores = scores + ((1.0 - c["mask"]) * -1e9)[:, None, None, :]
    dp = mm(c["do"], c["v"])
    if stats is None:
        p = torch.softmax(scores, dim=-1)
        delta = torch.sum(p * dp, dim=-1, keepdim=True)
    else:
        p = torch.exp(scores - stats[0][..., None])
        delta = stats[1][..., None]
    ds = (p * (dp - delta) * c["scale"]).to(dt).to(f32)
    return kernel._adjoint(torch.matmul(ds, kr.to(f32)), qcos,
                           qsin).to(dt)


def phase17_case(d: int, kind: str, dtype):
    """check_head_dims' case at head dim d, kind and dtype: its seed and
    its order of draws."""
    gen = torch.Generator(device="cuda").manual_seed(17)
    for dd in chip_smoke.HD_DIMS:
        for kk in ("text_masked", "group"):
            for dt in (torch.float32, torch.bfloat16):
                c = chip_smoke.backward_case(
                    kk, dt, gen, s=chip_smoke.HD_S, bh=chip_smoke.HD_BH,
                    d=dd, heads=chip_smoke.HD_HEADS)
                if (dd, kk, dt) == (d, kind, dtype):
                    return c
    raise ValueError(f"no phase 17 case at d={d}, {kind}")


def k2_alone(c):
    """K2 alone on c's padded, rotated inputs, launched through the
    wrapper's entry point with a statistics buffer of its own (the wrapper
    keeps its own internal): (dq, dk, dv) as (b, h, s, d), the statistics
    planes m, 1/l and delta, and the body it ran."""
    p, fb = c["p"], kernel.flash_bwd
    qr, kr = p["qr"], p["kr"]
    bh, s_q, d = qr.shape
    s_k = kr.shape[1]
    code = kernel._dtype_code(qr)
    stats = torch.empty((3, bh, s_q), dtype=torch.float32, device="cuda")
    grads = (torch.empty_like(qr), torch.empty_like(kr),
             torch.empty_like(kr))
    nbytes = fb.scratch_bytes(code, d, p["d"], bh, s_q, s_k)
    scratch = (torch.empty(nbytes, dtype=torch.uint8, device="cuda")
               if nbytes else None)
    mask = p["mask"]
    fb._launch_flash(
        qr.device, code, qr.data_ptr(), kr.data_ptr(), p["v"].data_ptr(),
        p["do"].data_ptr(), *(g.data_ptr() for g in grads),
        stats.data_ptr(), scratch.data_ptr() if scratch is not None else None,
        *(t.data_ptr() for t in p["tables"]),
        mask.data_ptr() if mask is not None else None,
        mask.shape[0] if mask is not None else 0, bh, s_q, s_k, d, p["d"],
        c["q"].shape[1], float(c["scale"]), int(bool(c["causal"])),
        shape=(s_q, s_k, d, bool(c["causal"])), head_dim=p["d"])
    torch.cuda.synchronize()
    grads = [g[..., :p["d"]].reshape(c[n].shape) for g, n in
             zip(grads, "qkv")]
    return grads, stats, kernel.flash_bwd.last_source


def chain_vs_wide(made) -> None:
    """K2's chain body against the wide body at d = 768 (the module's
    note)."""
    pairs = {"k2 (80, 196, 768) pixel": made.get("k2 (80, 196, 768) pixel"),
             "k2 phase17 (16, 200, 768) masked": phase17_case(
                 768, "text_masked", torch.bfloat16)}
    if pairs["k2 (80, 196, 768) pixel"] is None:
        pairs["k2 (80, 196, 768) pixel"] = cases(["(80, 196, 768)"])[
            "k2 (80, 196, 768) pixel"]
    runs = {}
    wide_root = patched_sources("wide_k2_768", {"wide_k2_768": WIDE_K2_768})
    for body, root in (("chain", cuda_build.PACKAGE_DIR),
                       ("wide", wide_root)):
        use_sources(root, "flash_bwd", [kernel.flash_bwd])
        for name, c in pairs.items():
            chip_smoke.padded(c)
            chip_smoke.rotate_padded(c)
            runs[body, name] = k2_alone(c)
    use_sources(cuda_build.PACKAGE_DIR, "flash_bwd", [kernel.flash_bwd])
    for name, c in pairs.items():
        (cg, cst, csrc), (wg, wst, wsrc) = runs["chain", name], runs[
            "wide", name]
        want = chip_smoke.run_bwd_plain(c)
        res = {"bodies": [csrc, wsrc],
               "stats_equal_bits": {
                   plane: bool(torch.equal(cst[i].view(torch.int32),
                                           wst[i].view(torch.int32)))
                   for i, plane in enumerate(("m", "1/l", "delta"))},
               "stats_max_abs": (cst - wst).abs().max().item()}
        for g, a, b, ref in zip(("dq", "dk", "dv"), cg, wg, want):
            res[g] = {"chain_vs_wide": errors(a, b),
                      "chain_vs_plain": errors(a, ref),
                      "wide_vs_plain": errors(b, ref)}
        print(f"chain_vs_wide {name}: {json.dumps(res)}", flush=True)
    del runs
    torch.cuda.empty_cache()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cases", nargs="+", default=None,
                    help="run the cases whose name holds one of these")
    words = ap.parse_args(argv).cases
    if not torch.cuda.is_available():
        raise SystemExit("wide_sum_order runs on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    made = cases(words)
    if not words or "chain" in words:
        chain_vs_wide(made)
    if not made:
        print(chip_smoke.card_line(), flush=True)
        return
    for order in ("fma_chain", "tensor_cores", "k16_from_zero"):
        use_order(order)
        for name, c in made.items():
            if name.startswith(("k1", "k3")):
                res = (k1_errors if name.startswith("k1") else k3_errors)(c)
                print(f"{order} {name}: {json.dumps(res)}", flush=True)
                torch.cuda.empty_cache()
                continue
            got, want, _ = kernel_grads(name, c)
            res = {g: errors(a, b)
                   for g, a, b in zip(("dq", "dk", "dv"), got, want)}
            res["body"] = [kernel.flash_bwd_dq.last_source,
                           kernel.flash_bwd_dkdv.last_source] if (
                name.startswith("k4")) else kernel.flash_bwd.last_source
            print(f"{order} {name}: {json.dumps(res)}", flush=True)
            del got, want
            torch.cuda.empty_cache()
    use_order("fma_chain")
    for name, c in made.items():
        if name.startswith(("k1", "k3")):
            continue
        _, want, stats = kernel_grads(name, c)
        for order in ("plain_fp64", "plain_k16"):
            res = errors(plain_dq(c, order, stats), want[0])
            print(f"{order} {name} dq: {json.dumps(res)}", flush=True)
            torch.cuda.empty_cache()
    print(chip_smoke.card_line(), flush=True)


if __name__ == "__main__":
    main()
