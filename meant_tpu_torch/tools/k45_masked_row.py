"""K4's and K5's gradients on a fully masked batch row against an fp64
evaluation of the formula, on the card.

    python -m meant_tpu_torch.tools.k45_masked_row     (from the repo root)

The streaming backward takes P = exp(S - lse) (meant_tpu/ops/flash/
kernel.py:456-611, `_bwd_dq_kernel` and `_bwd_dkdv_kernel`): on a batch row
whose keys are all masked every fp32 score and the row's lse round to
-1e9, so P = 1 for every key, and dq, dk and dv sum some s terms that
largely cancel. At such lengths a few bf16 elements of K4's and K5's
gradients and of their plain versions (`flash_mha_bwd_online_reference`,
cuBLAS fp32 sums) land more than the per-element bar apart. This tool
holds each against `grads_fp64`: the same formula with dP, dS and the
three products in fp64, rounded only where the formula rounds, on the
inputs of tests/test_torch_cuda.py's `all_masked_pixel` case (b=3, h=2,
pixel rotary, not causal, batch row 1 fully masked, bf16) at s = 4033,
4095 and 4096, and prints for each gradient: max abs error, relative L2,
and the elements past the per-element bar (2e-2 relative +
BWD_BF16_ATOL), on the masked row and on the others.
"""

from __future__ import annotations

import json

import torch

from meant_tpu_torch.ops.flash.kernel import (BWD_BF16_ATOL, _adjoint,
                                              _rotate, _scores)

LENGTHS = (4033, 4095, 4096)


def grads_fp64(q, k, v, do, lse, delta, kmask, qcos, qsin, kcos, ksin, *,
               scale: float, causal: bool) -> tuple:
    """(dq, dk, dv) of `_bwd_dq_kernel` and `_bwd_dkdv_kernel` in fp64,
    rounded only where the formula rounds: Qr and Kr to the input dtype (as
    R1), the scores in fp32 (the masked row's -1e9), P for dV and dS to the
    input dtype. (b, h, s, d) in, fp64 out."""
    f64, dt = torch.float64, q.dtype
    qr, kr = _rotate(q, qcos, qsin), _rotate(k, kcos, ksin)
    p = torch.exp(_scores(qr, kr, kmask, scale, causal).to(f64)
                  - lse.to(f64)[..., None])
    dof = do.to(f64)
    dv = torch.matmul(p.to(dt).to(f64).transpose(-1, -2), dof)
    dp = torch.matmul(dof, v.to(f64).transpose(-1, -2))
    ds = (p * (dp - delta.to(f64)[..., None]) * scale).to(dt).to(f64)
    del p, dp
    dq = _adjoint(torch.matmul(ds, kr.to(f64)), qcos.to(f64), qsin.to(f64))
    dk = _adjoint(torch.matmul(ds.transpose(-1, -2), qr.to(f64)),
                  kcos.to(f64), ksin.to(f64))
    return dq, dk, dv


def errors(g, g64, row) -> dict:
    """A gradient's error against its fp64 value: max abs, relative L2, and
    the count past the per-element bar, on batch row `row` and
    elsewhere."""
    err = (g.to(torch.float64) - g64).abs()
    past = err > 2e-2 * g64.abs() + BWD_BF16_ATOL
    rest = torch.ones(g.shape[0], dtype=torch.bool, device=g.device)
    rest[row] = False
    return {"max_abs": err.max().item(),
            "rel_l2": (err.norm() / g64.norm()).item(),
            "past_bar_masked_row": int(past[row].sum()),
            "past_bar_other_rows": int(past[rest].sum())}


def case(s: int, seed: int):
    """The all_masked_pixel inputs of tests/test_torch_cuda.py at length s,
    with the plain forward's lse and a delta with a non-zero lse
    cotangent."""
    from meant_tpu_torch.ops import pixel_freqs
    from meant_tpu_torch.ops.flash import flash_mha_online_reference
    from meant_tpu_torch.ops.flash.flash_attention import _tables
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, do = (torch.randn(3, 2, s, 96, generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(4))
    tables = _tables(s, 96, pixel_freqs(48, device="cuda"), False, 512.0)
    mask = (torch.rand(3, s, generator=gen, device="cuda") > 0.3).float()
    mask[:, 0] = 1.0
    mask[1] = 0.0
    g_lse = torch.randn(3, 2, s, generator=gen, device="cuda")
    out, lse = flash_mha_online_reference(q, k, v, mask, *tables, scale=0.1,
                                          causal=False)
    delta = (do.float() * out.float()).sum(-1) - g_lse
    return q, k, v, do, lse, delta, mask, tables


def kernel_grads(q, k, v, do, lse, delta, mask, tables):
    """R1, then K4 and K5 on (b*h, s, d) views; (dq, dk, dv) as
    (b, h, s, d)."""
    from meant_tpu_torch.ops.flash import (flash_bwd_dkdv, flash_bwd_dq,
                                           rotate_qk)
    b, h, s, d = q.shape
    flat = [t.reshape(b * h, s, d).contiguous() for t in (q, k, v, do)]
    args = (*rotate_qk(*flat[:2], *tables), *flat[2:],
            lse.reshape(b * h, s), delta.reshape(b * h, s), mask, *tables)
    kw = dict(scale=0.1, causal=False, num_heads=h)
    (dq,) = flash_bwd_dq(*args, **kw)
    dk, dv = flash_bwd_dkdv(*args, **kw)
    return [g.reshape(b, h, s, d) for g in (dq, dk, dv)]


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("k45_masked_row runs on the card")
    import chip_smoke
    from meant_tpu_torch.ops.flash import flash_mha_bwd_online_reference
    torch.backends.cuda.matmul.allow_tf32 = False
    card = chip_smoke.card_line()
    for s in LENGTHS:
        args = case(s, seed=3000 + s)
        q, k, v, do, lse, delta, mask, tables = args
        want = grads_fp64(q, k, v, do, lse, delta, mask, *tables, scale=0.1,
                          causal=False)
        plain = flash_mha_bwd_online_reference(
            q, k, v, do, lse, delta, mask, *tables, scale=0.1, causal=False)
        got = kernel_grads(*args)
        torch.cuda.synchronize()
        for name, a, b, w in zip(("dq", "dk", "dv"), got, plain, want):
            print(json.dumps({
                "s": s, "grad": name, "kernel": errors(a, w, 1),
                "plain": errors(b, w, 1),
                "kernel_vs_plain_max_abs":
                    (a.float() - b.float()).abs().max().item(),
                "card": card}), flush=True)
        del args, q, k, v, do, want, plain, got
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
