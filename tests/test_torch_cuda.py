"""The CUDA kernels against their plain versions, on the card: the flash
forward (K1), the flash backward (K2), the streaming flash forward (K3), the
rotation pass (R1) in front of K1, K3 and the streaming dQ (K4) and dK/dV
(K5) backward, and the fused AdamW (A1), its bf16-m variant included; at
head dims 64 and 128 and 48 (padded), at odd head dims and past 128 (the
wide bodies, the odd-d wrap of the adjoint), with more keys than queries (the
TimeSformer's groups), and a narrow paper-generation `meant` and
meant_src trainer (accumulation, a bf16 first moment) through them.
These tests need an NVIDIA card and nvcc; elsewhere they skip. On the
card:

    pytest --noconftest -m cuda tests/test_torch_cuda.py

Bars. fp32: rtol 1e-4 / atol 1e-5 (the kernels and the plain versions
differ only in summation order). bf16: 2e-2 per element and the relative L2
bars of ops/flash/kernel.py, set from H100 readings (PERF.md): K1 at
K1_BF16_REL_L2, K3 at BF16_REL_L2; K3's lse within LSE_ATOL absolute. R1: bit for bit `_rotate`. A1: max relative
error 1e-6 (both sides round every operation to fp32 alike).

The host data path: R1 + K1 and R1 + K2 at the bucket lengths s=256 and
384; a background checkpoint save against the next A1 step (the file
holds the state before it, bit for bit); Prefetcher(workers=3) giving
workers=1's batches in order.

The serving and memory levers on a narrow meant_src (dim 192 in 2 heads of
96, 2 + 2 encoders): the int8 product int32-equal to its plain version;
int8 serving within JAX's bars of bf16 (atol 0.05, argmax agreement 0.9)
with the same K1 and R1 launches; the exported program (resident and
streaming) within 1e-5 of the live forward, launching the kernels; a
training step under remat launching R1 + K1 twice and K2 once per
encoder, its gradients those of remat off (1e-3 relative L2 per
parameter where not bit for bit).
"""

import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from meant_tpu_torch.data.datasets import synthetic_tempstock
from meant_tpu_torch.data.loader import ArrayLoader, host_tensor
from meant_tpu_torch.models import EmbeddingConfig, meant
from meant_tpu_torch.ops import lang_freqs, pixel_freqs
from meant_tpu_torch.ops.adamw import adamw_update, fused_adamw
from meant_tpu_torch.ops.flash import (flash_bwd, flash_bwd_dkdv,
                                       flash_bwd_dq, flash_bwd_dq_dkdv,
                                       flash_fwd,
                                       flash_fwd_online, flash_mha,
                                       flash_mha_bwd_online_reference,
                                       flash_mha_bwd_reference,
                                       flash_mha_online_reference,
                                       flash_mha_reference, rotate_qk)
from meant_tpu_torch.ops.flash.flash_attention import _tables
from meant_tpu_torch.ops.flash.kernel import (
    BF16_REL_L2, BWD_BF16_ATOL, BWD_BF16_REL_L2, CHAIN_SOURCE,
    K1_BF16_REL_L2, K3_TILED_REL_L2, LSE_ATOL, WIDE_SOURCE, _flat,
    _kernel_tables, _rotate, flash_mha_online_tiled_reference,
    kernel_head_dim)
from meant_tpu_torch.tools.k45_masked_row import errors as fp64_errors
from meant_tpu_torch.tools.k45_masked_row import grads_fp64
from meant_tpu_torch.train.classify import meant_trainer

import torch_threads

torch_threads.share_cores()

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# 127-129 and 191-193 cut the 64-row tiles at a tile's edge, and the ring
# of stages where it fills and wraps; 196 and 512 are the main path's.
RESIDENT_LENGTHS = [1, 63, 65, 127, 128, 129, 191, 192, 193, 196, 512]


def _k1_case(cuda, dtype, case, s):
    """q, k, v (3, 2, s, 96), the tables (None: flash_mha's identity), the
    mask and causal of one resident forward; `all_masked_row` has every key
    of batch row 1 masked (P uniform over the keys the causal fill
    leaves)."""
    d = 96
    gen = torch.Generator(device=cuda).manual_seed(s)
    q, k, v = (torch.randn(3, 2, s, d, generator=gen, device=cuda)
               .to(dtype) for _ in range(3))
    causal = case in ("xpos_causal", "masked", "broadcast_mask",
                      "all_masked_row")
    tables = (None,) * 4
    if case != "identity":
        freqs = (pixel_freqs(48, device=cuda) if case == "pixel"
                 else lang_freqs(48, device=cuda))
        tables = _tables(s, d, freqs, case != "pixel", 512.0)
    mask = None
    if case in ("masked", "broadcast_mask", "all_masked_row"):
        rows = 1 if case == "broadcast_mask" else 3
        mask = (torch.rand(rows, s, generator=gen, device=cuda) > 0.3).float()
        mask[:, 0] = 1.0
        if case == "all_masked_row":
            mask[1] = 0.0
    return q, k, v, tables, mask, causal


def _resident_fwd(q, k, v, tables, mask, causal):
    """flash_mha's resident forward on the card: R1 then K1."""
    return flash_mha(q, k, v, scale=0.1, causal=causal, attention_mask=mask,
                     qcos=tables[0], qsin=tables[1], kcos=tables[2],
                     ksin=tables[3])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["xpos_causal", "pixel", "masked",
                                  "broadcast_mask", "identity",
                                  "all_masked_row"])
@pytest.mark.parametrize("s", RESIDENT_LENGTHS)
def test_kernel_matches_plain(cuda, dtype, case, s):
    """R1 + K1 against flash_mha_reference: fp32 at rtol 1e-4 / atol 1e-5;
    bf16 at 2e-2 per element and K1_BF16_REL_L2 (K1 rounds P after
    normalising, where the plain version rounds it)."""
    q, k, v, tables, mask, causal = _k1_case(cuda, dtype, case, s)
    before = (rotate_qk.launches, flash_fwd.launches)
    out = _resident_fwd(q, k, v, tables, mask, causal)
    torch.cuda.synchronize()
    assert (rotate_qk.launches, flash_fwd.launches) == (before[0] + 1,
                                                        before[1] + 1)
    if tables[0] is None:
        ones = torch.ones(s, 96, device=cuda)
        tables = (ones, torch.zeros_like(ones)) * 2
    ref = flash_mha_reference(q, k, v, mask, *tables, scale=0.1,
                              causal=causal)
    assert torch.isfinite(out).all()
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-5)
    else:
        torch.testing.assert_close(out.float(), ref.float(), rtol=2e-2,
                                   atol=2e-2)
        rel = (out.float() - ref.float()).norm() / ref.float().norm()
        assert rel <= K1_BF16_REL_L2, f"rel L2 {rel}"


def _bwd_case(cuda, dtype, case, s, gen):
    d = 96
    q, k, v, do = (torch.randn(3, 2, s, d, generator=gen, device=cuda)
                   .to(dtype) for _ in range(4))
    causal = case in ("xpos_causal", "masked", "broadcast_mask")
    pixel = case in ("pixel", "all_masked_pixel")
    if case == "identity":
        ones = torch.ones(s, d, device=cuda)
        tables = (ones, torch.zeros_like(ones)) * 2
    else:
        freqs = (pixel_freqs(48, device=cuda) if pixel
                 else lang_freqs(48, device=cuda))
        tables = _tables(s, d, freqs, not pixel, 512.0)
    mask = None
    if case in ("masked", "broadcast_mask", "all_masked_row",
                "all_masked_pixel"):
        rows = 1 if case == "broadcast_mask" else 3
        mask = (torch.rand(rows, s, generator=gen, device=cuda) > 0.3).float()
        mask[:, 0] = 1.0
        if case.startswith("all_masked"):
            mask[1] = 0.0     # every key of batch row 1 masked
    return q, k, v, do, tables, mask, causal


def _assert_grads_close(got, want, dtype):
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        assert torch.isfinite(a).all(), name
        if dtype == torch.float32:
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5,
                                       msg=lambda m: f"{name}: {m}")
        else:
            torch.testing.assert_close(a.float(), b.float(), rtol=2e-2,
                                       atol=BWD_BF16_ATOL,
                                       msg=lambda m: f"{name}: {m}")
            rel = (a.float() - b.float()).norm() / b.float().norm().clamp_min(
                1e-30)
            assert rel <= BWD_BF16_REL_L2, f"{name}: rel L2 {rel}"


def _resident_bwd(q, k, v, do, tables, mask, causal):
    """R1 then K2, as the resident backward runs them: (dq, dk, dv) as
    (b, h, s, d)."""
    b, h, s, d = q.shape
    flat = [t.reshape(b * h, s, d).contiguous() for t in (q, k, v, do)]
    grads = flash_bwd(*rotate_qk(*flat[:2], *tables), *flat[2:], mask,
                      *tables, scale=0.1, causal=causal, num_heads=h)
    return [g.reshape(b, h, s, d) for g in grads]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["xpos_causal", "pixel", "masked",
                                  "broadcast_mask", "identity",
                                  "all_masked_row"])
@pytest.mark.parametrize("s", RESIDENT_LENGTHS)
def test_backward_kernel_matches_plain(cuda, dtype, case, s):
    """R1 + K2 against flash_mha_bwd_reference; a fully masked batch row
    gets P = 1/s on both sides."""
    gen = torch.Generator(device=cuda).manual_seed(1000 + s)
    q, k, v, do, tables, mask, causal = _bwd_case(cuda, dtype, case, s, gen)
    before = (rotate_qk.launches, flash_bwd.launches)
    got = _resident_bwd(q, k, v, do, tables, mask, causal)
    torch.cuda.synchronize()
    assert (rotate_qk.launches, flash_bwd.launches) == (before[0] + 1,
                                                        before[1] + 1)
    want = flash_mha_bwd_reference(q, k, v, do, mask, *tables, scale=0.1,
                                   causal=causal)
    _assert_grads_close(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_mha_on_cuda_has_grad_fn_and_runs_k2(cuda, dtype):
    """The repair: on CUDA inputs that require grad, flash_mha's output
    carries a grad_fn; its forward is R1 + K1 and its backward K2 alone, on
    the forward's Qr and Kr, with the plain path's gradients."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    q, k, v, do, tables, mask, causal = _bwd_case(cuda, dtype, "masked",
                                                  196, gen)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    fwd0, bwd0, rot0 = (flash_fwd.launches, flash_bwd.launches,
                        rotate_qk.launches)
    out = flash_mha(*leaves, scale=0.1, causal=causal, attention_mask=mask,
                    qcos=tables[0], qsin=tables[1], kcos=tables[2],
                    ksin=tables[3])
    assert out.grad_fn is not None
    assert (flash_fwd.launches, rotate_qk.launches) == (fwd0 + 1, rot0 + 1)
    out.backward(do)
    torch.cuda.synchronize()
    assert (flash_fwd.launches, flash_bwd.launches, rotate_qk.launches) == (
        fwd0 + 1, bwd0 + 1, rot0 + 1)
    want = flash_mha_bwd_reference(q, k, v, do, mask, *tables, scale=0.1,
                                   causal=causal)
    _assert_grads_close([t.grad for t in leaves], want, dtype)
    with torch.no_grad():
        assert flash_mha(*leaves, scale=0.1, causal=causal).grad_fn is None
    assert flash_bwd.launches == bwd0 + 1


# The fully masked row of the streaming kernels takes the pixel rotary:
# xPos without the causal mask (no caller uses it so) grows the scores as
# base^-(j - i)/512 for keys past the query, some 1e4 at s=4096, where one
# fp32 step of lse is 1e-2 and -1e9 + score no longer rounds alike.
ONLINE_CASES = ["xpos_causal", "pixel", "masked", "broadcast_mask",
                "all_masked_pixel"]
# 127, 128, 129 and 191, 192, 193 cut K4's and K5's 64-row tiles at a
# tile's edge, and their ring of three stages where it fills and wraps.
# At 4033 and 4095 a fully masked batch row's bf16 gradients (P = 1 for
# every key: sums of some 4000 terms that largely cancel) land a bf16 step
# from the plain version's at an element or two, past the per-element bar;
# there K4's and K5's gradients and the plain version's are all held to an
# fp64 evaluation of the formula instead, and the kernels may be no further
# from it (tools/k45_masked_row.py; PERF.md).
ONLINE_LENGTHS = [1, 63, 65, 127, 128, 129, 191, 192, 193, 196, 4033, 4095,
                  4096]
FP64_LENGTHS = (4033, 4095)


def _assert_out_close(out, ref, dtype, bar=BF16_REL_L2):
    assert out.shape == ref.shape and out.dtype == ref.dtype
    assert torch.isfinite(out).all()
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-5)
    else:
        torch.testing.assert_close(out.float(), ref.float(), rtol=2e-2,
                                   atol=2e-2)
        rel = (out.float() - ref.float()).norm() / ref.float().norm()
        assert rel <= bar


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ONLINE_CASES)
@pytest.mark.parametrize("s", ONLINE_LENGTHS)
def test_online_forward_kernel_matches_plain(cuda, dtype, case, s):
    """R1 + K3: out as K1's bars, lse within LSE_ATOL (a fully masked batch
    row reads -1e9 on both sides)."""
    gen = torch.Generator(device=cuda).manual_seed(2000 + s)
    q, k, v, _, tables, mask, causal = _bwd_case(cuda, dtype, case, s, gen)
    b, h = q.shape[:2]
    before = (rotate_qk.launches, flash_fwd_online.launches)
    out, lse = _online_fwd(q, k, v, tables, mask, causal)
    torch.cuda.synchronize()
    assert (rotate_qk.launches, flash_fwd_online.launches) == (
        before[0] + 1, before[1] + 1)
    ref, ref_lse = flash_mha_online_reference(q, k, v, mask, *tables,
                                              scale=0.1, causal=causal)
    _assert_out_close(out.reshape(b, h, s, 96), ref, dtype)
    assert lse.dtype == torch.float32
    err = (lse.reshape(b, h, s) - ref_lse).abs().max().item()
    assert err <= LSE_ATOL, f"lse max abs err {err}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ONLINE_CASES)
@pytest.mark.parametrize("s", ONLINE_LENGTHS)
def test_online_backward_kernels_match_plain(cuda, dtype, case, s):
    """K4 and K5 against flash_mha_bwd_online_reference, from the plain
    forward's lse and a delta that carries a non-zero lse cotangent."""
    gen = torch.Generator(device=cuda).manual_seed(3000 + s)
    q, k, v, do, tables, mask, causal = _bwd_case(cuda, dtype, case, s, gen)
    b, h = q.shape[:2]
    args = _online_bwd_args(q, k, v, do, tables, mask, causal, gen)
    before = (flash_bwd_dq.launches, flash_bwd_dkdv.launches)
    (dq,) = flash_bwd_dq(*args, scale=0.1, causal=causal, num_heads=h)
    dk, dv = flash_bwd_dkdv(*args, scale=0.1, causal=causal, num_heads=h)
    torch.cuda.synchronize()
    assert (flash_bwd_dq.launches, flash_bwd_dkdv.launches) == (
        before[0] + 1, before[1] + 1)
    lse, delta = (t.reshape(b, h, s) for t in args[4:6])
    want = flash_mha_bwd_online_reference(q, k, v, do, lse, delta, mask,
                                          *tables, scale=0.1, causal=causal)
    got = [g.reshape(b, h, s, 96) for g in (dq, dk, dv)]
    if (case == "all_masked_pixel" and s in FP64_LENGTHS
            and dtype == torch.bfloat16):
        exact = grads_fp64(q, k, v, do, lse, delta, mask, *tables, scale=0.1,
                           causal=causal)
        for name, a, b_, w in zip(("dq", "dk", "dv"), got, want, exact):
            assert torch.isfinite(a).all(), name
            mine, plain = fp64_errors(a, w, 1), fp64_errors(b_, w, 1)
            assert mine["rel_l2"] <= 1.01 * plain["rel_l2"], (name, mine,
                                                              plain)
            assert mine["max_abs"] <= 1.01 * plain["max_abs"], (name, mine,
                                                                plain)
        return
    _assert_grads_close(got, want, dtype)


def _online_fwd(q, k, v, tables, mask, causal):
    """R1 then K3, as the streaming forward runs them: (out, lse) on
    (b*h, s, d) views."""
    b, h, s, d = q.shape
    flat = [t.reshape(b * h, s, d).contiguous() for t in (q, k, v)]
    return flash_fwd_online(*rotate_qk(*flat[:2], *tables), flat[2], mask,
                            scale=0.1, causal=causal, num_heads=h)


def _online_bwd_args(q, k, v, do, tables, mask, causal, gen):
    """K4's and K5's arguments: q and k rotated by R1, v, dO, the plain
    forward's lse and a delta that carries a non-zero lse cotangent, the
    mask and the tables."""
    b, h, s, d = q.shape
    g_lse = torch.randn(b, h, s, generator=gen, device=q.device)
    out, lse = flash_mha_online_reference(q, k, v, mask, *tables, scale=0.1,
                                          causal=causal)
    delta = (do.float() * out.float()).sum(-1) - g_lse
    flat = [t.reshape(b * h, s, d).contiguous() for t in (q, k, v, do)]
    return [*rotate_qk(*flat[:2], *tables), *flat[2:],
            lse.reshape(b * h, s), delta.reshape(b * h, s), mask, *tables]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [193, 4095])
def test_online_backward_kernels_are_deterministic(cuda, dtype, s):
    """Every element of dq, dk and dv has one writer and no atomics: two
    launches of K4 and K5 on the same inputs agree bit for bit."""
    gen = torch.Generator(device=cuda).manual_seed(4000 + s)
    q, k, v, do, tables, mask, causal = _bwd_case(cuda, dtype, "masked", s,
                                                  gen)
    args = _online_bwd_args(q, k, v, do, tables, mask, causal, gen)
    runs = []
    for _ in range(2):
        (dq,) = flash_bwd_dq(*args, scale=0.1, causal=causal, num_heads=2)
        runs.append((dq, *flash_bwd_dkdv(*args, scale=0.1, causal=causal,
                                         num_heads=2)))
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv"), *runs):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel,s", [("K1", 193), ("K1", 512),
                                      ("K2", 193), ("K2", 512),
                                      ("K3", 4095)])
def test_resident_backward_and_online_forward_are_deterministic(
        cuda, dtype, kernel, s):
    """K1, K2's two kernels and K3 write every element once, no atomics:
    two launches on the same inputs agree bit for bit."""
    gen = torch.Generator(device=cuda).manual_seed(4500 + s)
    q, k, v, do, tables, mask, causal = _bwd_case(cuda, dtype, "masked", s,
                                                  gen)
    if kernel == "K1":
        runs = [[_resident_fwd(q, k, v, tables, mask, causal)]
                for _ in range(2)]
        names = ("out",)
    elif kernel == "K2":
        runs = [_resident_bwd(q, k, v, do, tables, mask, causal)
                for _ in range(2)]
        names = ("dq", "dk", "dv")
    else:
        runs = [_online_fwd(q, k, v, tables, mask, causal) for _ in range(2)]
        names = ("out", "lse")
    torch.cuda.synchronize()
    for name, a, b in zip(names, *runs):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["xpos_causal", "pixel"])
@pytest.mark.parametrize("s", [1, 63, 196, 4096])
def test_rotation_pass_is_rotate(cuda, dtype, case, s):
    """R1 against `_rotate` (the plain versions' rotation): bit for bit."""
    gen = torch.Generator(device=cuda).manual_seed(5000 + s)
    q, k, _, _, tables, _, _ = _bwd_case(cuda, dtype, case, s, gen)
    flat = [t.reshape(6, s, 96).contiguous() for t in (q, k)]
    before = rotate_qk.launches
    qr, kr = rotate_qk(*flat, *tables)
    torch.cuda.synchronize()
    assert rotate_qk.launches == before + 1
    assert qr.dtype == kr.dtype == dtype
    assert torch.equal(qr, _rotate(flat[0], *tables[:2]))
    assert torch.equal(kr, _rotate(flat[1], *tables[2:]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_mha_online_on_cuda_runs_k3_k4_k5(cuda, dtype):
    """force_online on CUDA inputs that require grad: a grad_fn, R1 + K3
    forward and R1 + K4 + K5 backward, none of K1 or K2, and the plain
    path's gradients through both out and lse."""
    gen = torch.Generator(device=cuda).manual_seed(8)
    q, k, v, do, tables, mask, causal = _bwd_case(cuda, dtype, "masked",
                                                  196, gen)
    g_lse = torch.randn(*q.shape[:3], 1, generator=gen, device=cuda)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    counters = (flash_fwd, flash_bwd, flash_fwd_online, rotate_qk,
                flash_bwd_dq, flash_bwd_dkdv)
    before = [c.launches for c in counters]
    out, lse = flash_mha(*leaves, scale=0.1, causal=causal,
                         attention_mask=mask, qcos=tables[0],
                         qsin=tables[1], kcos=tables[2], ksin=tables[3],
                         force_online=True, return_lse=True)
    assert out.grad_fn is not None and lse.shape == (*q.shape[:3], 1)
    torch.autograd.backward((out, lse), (do, g_lse))
    torch.cuda.synchronize()
    assert [c.launches - n for c, n in zip(counters, before)] == [
        0, 0, 1, 2, 1, 1]
    # the plain backward from K3's own out and lse
    delta = (do.float() * out.detach().float()).sum(-1) - g_lse[..., 0]
    want = flash_mha_bwd_online_reference(q, k, v, do, lse.detach()[..., 0],
                                          delta, mask, *tables, scale=0.1,
                                          causal=causal)
    _assert_grads_close([t.grad for t in leaves], want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_narrow_meant_launches_k1_r1_then_k2_and_a1(cuda, dtype):
    """A narrow paper-generation meant (dim 192 in 2 heads of 96, 2 + 2
    encoders, s=48, 4-channel 32x32 charts) with flash on: a forward
    launches 2 x encoders K1 and R1 and matches the plain attention at the
    same weights (fp32 1e-4, bf16 2e-2 on the probabilities); one trainer
    step launches as many K1, R1 and K2, and one A1."""
    enc = 2
    make = lambda flash: meant(
        192, 192, 4, 32, 32, 16, 5, 2, flash=flash, num_heads=2,
        num_encoders=enc, dtype=None if dtype == torch.float32 else dtype,
        embedding=EmbeddingConfig(vocab_size=100, hidden_size=192,
                                  max_position_embeddings=40),
        device=cuda, seed=3)
    model, plain = make(True).eval(), make(False).eval()
    host = synthetic_tempstock(n=4, seq=48, size=32, vocab=100, seed=2)
    batch = {k: host_tensor(v).to(cuda) for k, v in host.items()}
    args = (batch["tweets"], batch["graphs"], batch["attention_masks"])
    counters = (flash_fwd, rotate_qk, flash_bwd, fused_adamw)
    before = [c.launches for c in counters]
    with torch.no_grad():
        out = model(*args)
        want = plain(*args)
    torch.cuda.synchronize()
    assert [c.launches - n for c, n in zip(counters, before)] == [
        2 * enc, 2 * enc, 0, 0]
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out.float(), want.float(), rtol=tol, atol=tol)
    trainer = meant_trainer({"model": model, "model_name": "meant",
                             "train_loader": ArrayLoader(host, 4)})
    trainer._init_state()
    before = [c.launches for c in counters]
    loss, _ = trainer.train_step(batch)
    torch.cuda.synchronize()
    assert [c.launches - n for c, n in zip(counters, before)] == [
        2 * enc, 2 * enc, 2 * enc, 1]
    assert torch.isfinite(loss)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["mlm", "mim"])
def test_narrow_pretrainers_launch_k1_r1_then_k2_and_a1(cuda, kind, dtype):
    """Narrow pretrainers (dim 192 in 2 heads of 96, 2 encoders; the MLM
    at s=48 over a vocabulary of 100, the MIM on 4-channel 64x64 charts)
    with flash on: a forward launches one K1 and one R1 per encoder and
    matches the plain attention at the same weights (fp32 1e-4, bf16 2e-2
    of the largest output); one pretrainer step launches as many K1, R1
    and K2, and one A1."""
    from meant_tpu_torch.data.masking import mask_image, mask_tokens
    from meant_tpu_torch.models import (meant_language_pretrainer,
                                        meant_vision_pretrainer)
    from meant_tpu_torch.train.pretrain import mim_pretrainer, mlm_pretrainer
    enc, gen = 2, torch.Generator().manual_seed(5)
    common = dict(num_encoders=enc, num_heads=2, device=cuda, seed=3,
                  dtype=None if dtype == torch.float32 else dtype)
    if kind == "mlm":
        make = lambda flash: meant_language_pretrainer(
            embedding=EmbeddingConfig(vocab_size=100, hidden_size=192),
            text_dim=192, flash=flash, ff_dropout=0.0, **common)
        ids = torch.randint(3, 99, (4, 48), generator=gen).numpy()
        inputs, labels = mask_tokens(ids, 99, [0, 1, 2], seed=1)
        host = {"input_ids": inputs, "labels": labels,
                "attention_mask": (ids > 0).astype("float32")}
        trainer_cls, args = mlm_pretrainer, ("input_ids", "attention_mask")
    else:
        make = lambda flash: meant_vision_pretrainer(
            patch_res=16, channels=4, height=64, width=64, image_dim=192,
            flash=flash, **common)
        inputs, labels = mask_image(
            torch.rand(4, 4, 64, 64, generator=gen).numpy(), seed=1)
        host = {"input_ids": inputs, "labels": labels}
        trainer_cls, args = mim_pretrainer, ("input_ids",)
    model, plain = make(True).eval(), make(False).eval()
    batch = {k: host_tensor(v).to(cuda) for k, v in host.items()}
    counters = (flash_fwd, rotate_qk, flash_bwd, fused_adamw)
    before = [c.launches for c in counters]
    with torch.no_grad():
        out = model(*(batch[k] for k in args))
        want = plain(*(batch[k] for k in args))
    torch.cuda.synchronize()
    assert [c.launches - n for c, n in zip(counters, before)] == [
        enc, enc, 0, 0]
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out.float(), want.float(), rtol=tol,
                               atol=tol * float(want.abs().max()))
    trainer = trainer_cls({"model": model, "train_data": [host]})
    trainer._init_state()
    before = [c.launches for c in counters]
    loss = trainer.train_step(batch)
    torch.cuda.synchronize()
    assert [c.launches - n for c, n in zip(counters, before)] == [
        enc, enc, enc, 1]
    assert torch.isfinite(loss)


@pytest.mark.parametrize("mode", ["adamw", "adam_coupled", "adamw_wd0",
                                  "no_clip"])
@pytest.mark.parametrize("n", [1, 3, 4, 1027, 1 << 20])
def test_adamw_kernel_matches_plain(cuda, mode, n):
    gen = torch.Generator(device=cuda).manual_seed(n)
    p = torch.randn(n, generator=gen, device=cuda)
    g = torch.randn(n, generator=gen, device=cuda) * 0.5
    m = torch.randn(n, generator=gen, device=cuda) * 0.1
    v = torch.rand(n, generator=gen, device=cuda) * 0.1
    norm = None if mode == "no_clip" else torch.linalg.vector_norm(g)
    kw = dict(lr=1e-3, b1=0.9, b2=0.999, eps=1e-8,
              weight_decay=0.0 if mode == "adamw_wd0" else 0.01, step=3,
              coupled=mode == "adam_coupled", norm=norm, max_norm=1.0)
    ref = [t.cpu() for t in (p, m, v)]
    adamw_update(ref[0], g.cpu(), ref[1], ref[2],
                 **dict(kw, norm=None if norm is None else norm.cpu()))
    before = fused_adamw.launches
    adamw_update(p, g, m, v, **kw)
    torch.cuda.synchronize()
    assert fused_adamw.launches == before + 1
    for got, want in zip((p, m, v), ref):
        err = ((got.cpu() - want).abs() / want.abs().clamp_min(1e-30)).max()
        assert err <= 1e-6, f"max relative error {err}"


def _narrow_src(cuda, seq_len=64, **kw):
    from meant_tpu_torch.models import meant_src
    return meant_src(192, 192, 5, 32, 32, 16, 5, 2, flash=True, num_heads=2,
                     num_encoders=2, seq_len=seq_len, fixed_proj=True,
                     dtype=torch.bfloat16,
                     embedding=EmbeddingConfig(vocab_size=100,
                                               hidden_size=192,
                                               max_position_embeddings=40),
                     device=cuda, seed=3, **kw)


def _src_rows(n, s, seed=0):
    import numpy as np
    rng = np.random.RandomState(seed)
    return {"input_ids": rng.randint(2, 100, (n, 5, s)).astype(np.int32),
            "pixels": rng.randn(n, 5, 3, 32, 32).astype(np.float32),
            "prices": rng.randn(n, 5, 5).astype(np.float32),
            "attention_mask": np.ones((n, 5, s), np.float32)}


@pytest.mark.parametrize("m,k,n", [(1, 8, 8), (16, 1541, 1541),
                                   (80, 1541, 1536), (17, 37, 33),
                                   (300, 768, 768)])
def test_int8_product_is_exact(cuda, m, k, n):
    from meant_tpu_torch.nn.quant import int8_matmul, int8_matmul_reference
    gen = torch.Generator(device=cuda).manual_seed(m + k + n)
    a = torch.randint(-127, 128, (m, k), generator=gen, device=cuda,
                      dtype=torch.int8)
    w = torch.randint(-127, 128, (n, k), generator=gen, device=cuda,
                      dtype=torch.int8)
    got = int8_matmul(a, w)
    assert got.dtype == torch.int32 and got.shape == (m, n)
    assert torch.equal(got, int8_matmul_reference(a, w))


def test_int8_serving_tracks_bf16(cuda):
    import numpy as np
    from meant_tpu_torch.serve import Predictor
    model = _narrow_src(cuda)
    rows = _src_rows(16, 64)
    probs = {}
    for mode in (None, "int8"):
        before = [flash_fwd.launches, rotate_qk.launches]
        probs[mode] = Predictor(model, "meant_src", batch_size=16,
                                quantize=mode)(rows)
        torch.cuda.synchronize()
        assert [flash_fwd.launches - before[0],
                rotate_qk.launches - before[1]] == [4, 4]
    assert np.isfinite(probs["int8"]).all()
    np.testing.assert_allclose(probs["int8"], probs[None], atol=0.05)
    agree = (probs["int8"].argmax(-1) == probs[None].argmax(-1)).mean()
    assert agree >= 0.9


@pytest.mark.parametrize("seq_len,kernel", [(64, "K1"), (4096, "K3")])
def test_exported_forward_launches_the_kernels(cuda, tmp_path, seq_len,
                                               kernel):
    import numpy as np
    from meant_tpu_torch.serve import (Predictor, export_forward,
                                       load_exported)
    model = _narrow_src(cuda, seq_len=seq_len)
    rows = _src_rows(2, seq_len)
    live = Predictor(model, "meant_src", batch_size=2)(rows)
    path = str(tmp_path / "forward.pt2")
    export_forward(model, "meant_src", rows, path)
    fn = load_exported(path)
    counters = (flash_fwd, flash_fwd_online, rotate_qk)
    before = [c.launches for c in counters]
    got = fn(model.state_dict(), rows).float().cpu().numpy()
    torch.cuda.synchronize()
    want = [4, 0, 4] if kernel == "K1" else [2, 2, 4]
    assert [c.launches - n for c, n in zip(counters, before)] == want
    np.testing.assert_allclose(got, live, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("lever", [dict(remat="full"), dict(remat="dots"),
                                   dict(scan_layers=True)],
                         ids=["full", "dots", "scan_layers"])
def test_remat_step_reruns_r1_k1_and_keeps_gradients(cuda, lever):
    from meant_tpu_torch.train.classify import seed_dropout
    rows = {k: host_tensor(v).to(cuda) for k, v in _src_rows(4, 64).items()}
    grads, counts = [], []
    for kw in ({}, lever):
        model = _narrow_src(cuda, **kw).train()
        counters = (flash_fwd, rotate_qk, flash_bwd)
        before = [c.launches for c in counters]
        seed_dropout(cuda, 5)
        model(**rows).float().square().sum().backward()
        torch.cuda.synchronize()
        counts.append([c.launches - n for c, n in zip(counters, before)])
        grads.append({n: p.grad.float() for n, p in model.named_parameters()})
    assert counts == [[4, 4, 4], [8, 8, 4]]
    for name, g in grads[0].items():
        other = grads[1][name]
        if not torch.equal(other, g):
            rel = ((other - g).norm() / g.norm().clamp_min(1e-30)).item()
            assert rel <= 1e-3, (name, rel)


# ---- meant_mosi's text tower: s=50 (one partial 64-row tile), xPos on 30
# features (15 rotated pairs, an identity tail of 66), a padded key mask --

def _rot30_case(cuda, dtype, masked, gen, s=50):
    q, k, v, do = (torch.randn(4, 2, s, 96, generator=gen, device=cuda)
                   .to(dtype) for _ in range(4))
    tables = _tables(s, 96, lang_freqs(30, device=cuda), True, 512.0)
    mask = None
    if masked:
        lengths = torch.tensor([50, 17, 1, 33], device=cuda)
        mask = (torch.arange(s, device=cuda)[None, :]
                < lengths[:, None]).float()
    return q, k, v, do, tables, mask


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("masked", [False, True], ids=["full", "padded"])
def test_rot30_s50_kernels_match_plain(cuda, dtype, masked):
    """R1 + K1 and R1 + K2 at s=50 with rot_dim 30 against their plain
    versions at the bars above; the tables' tail is the identity."""
    gen = torch.Generator(device=cuda).manual_seed(50)
    q, k, v, do, tables, mask = _rot30_case(cuda, dtype, masked, gen)
    assert torch.equal(tables[0][:, 30:], torch.ones_like(tables[0][:, 30:]))
    out = _resident_fwd(q, k, v, tables, mask, True)
    ref = flash_mha_reference(q, k, v, mask, *tables, scale=0.1, causal=True)
    torch.cuda.synchronize()
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-5)
    else:
        torch.testing.assert_close(out.float(), ref.float(), rtol=2e-2,
                                   atol=2e-2)
        rel = (out.float() - ref.float()).norm() / ref.float().norm()
        assert rel <= K1_BF16_REL_L2, f"rel L2 {rel}"
    got = _resident_bwd(q, k, v, do, tables, mask, True)
    want = flash_mha_bwd_reference(q, k, v, do, mask, *tables, scale=0.1,
                                   causal=True)
    _assert_grads_close(got, want, dtype)


@pytest.mark.parametrize("keys", [256, 257, 400])
def test_timesformer_flash_group_runs_on_the_card(cuda, keys):
    """A TimeSformer group of 256 keys or more with flash=True runs R1 + K1
    forward and K2 backward (keys - 1 queries, keys keys at head dim 64),
    with the output and the gradients of x and of every parameter of the
    same weights at flash=False (fp32: rtol 1e-4 / atol 1e-5 on the
    output, 1e-4 relative L2 per gradient); 255 keys run the plain
    attention, as in JAX."""
    from meant_tpu_torch.nn.timesformer import TSAttention
    gen = torch.Generator(device=cuda).manual_seed(keys)
    attn = TSAttention(64, dim_head=64, heads=2, flash=True, device=cuda)
    plain = TSAttention(64, dim_head=64, heads=2, flash=False, device=cuda)
    plain.load_state_dict(attn.state_dict())
    x = torch.randn((1, keys, 64), generator=gen, device=cuda)
    dout = torch.randn((1, keys, 64), generator=gen, device=cuda)
    call = dict(group_size=keys - 1, num_groups=1, group_axis_first=True)
    results = []
    for module in (attn, plain):
        xx = x.clone().requires_grad_(True)
        before = (rotate_qk.launches, flash_fwd.launches, flash_bwd.launches)
        out = module(xx, **call)
        out.backward(dout)
        torch.cuda.synchronize()
        after = (rotate_qk.launches, flash_fwd.launches, flash_bwd.launches)
        want = (1, 1, 1) if module is attn else (0, 0, 0)
        assert tuple(a - b for a, b in zip(after, before)) == want
        results.append([out.detach(), xx.grad] + [
            p.grad for p in module.parameters()])
    torch.testing.assert_close(results[0][0], results[1][0], rtol=1e-4,
                               atol=1e-5)
    for a, b in zip(results[0][1:], results[1][1:]):
        assert (a - b).norm() <= 1e-4 * b.norm()
    short = torch.randn((1, 255, 64), device=cuda)
    before = flash_fwd.launches
    assert torch.isfinite(attn(short, group_size=254, num_groups=1,
                               group_axis_first=True)).all()
    assert flash_fwd.launches == before


# ---- head dims other than 96, and more keys than queries -------------------

def _shape_case(cuda, dtype, d, s_q, s_k, case, gen):
    """q (3, 2, s_q, d), k, v (3, 2, s_k, d), dO, the tables of each length
    (identity for "plain"), the (3, s_k) mask of "masked" or None, causal."""
    q, do = (torch.randn(3, 2, s_q, d, generator=gen, device=cuda).to(dtype)
             for _ in range(2))
    k, v = (torch.randn(3, 2, s_k, d, generator=gen, device=cuda).to(dtype)
            for _ in range(2))
    causal = case in ("xpos_causal", "masked")
    if case == "plain":
        qt = (torch.ones(s_q, d, device=cuda), torch.zeros(s_q, d,
                                                           device=cuda))
        kt = (torch.ones(s_k, d, device=cuda), torch.zeros(s_k, d,
                                                           device=cuda))
        tables = (*qt, *kt)
    else:
        freqs = (pixel_freqs(d // 2, device=cuda) if case == "pixel"
                 else lang_freqs(d // 2, device=cuda))
        xpos = case != "pixel"
        tables = (*_tables(s_q, d, freqs, xpos, 512.0)[:2],
                  *_tables(s_k, d, freqs, xpos, 512.0)[2:])
    mask = None
    if case == "masked":
        mask = (torch.rand(3, s_k, generator=gen, device=cuda) > 0.3).float()
        mask[:, 0] = 1.0
    return q, k, v, do, tables, mask, causal


def _autograd_path(q, k, v, do, tables, mask, causal, **kw):
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = flash_mha(*leaves, scale=0.1, causal=causal, attention_mask=mask,
                    qcos=tables[0], qsin=tables[1], kcos=tables[2],
                    ksin=tables[3], **kw)
    out = out[0] if isinstance(out, tuple) else out
    out.backward(do)
    return out.detach(), [t.grad for t in leaves]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["xpos_causal", "pixel", "masked"])
@pytest.mark.parametrize("s", [65, 196])
@pytest.mark.parametrize("d", [48, 64, 128])
def test_head_dims_match_plain(cuda, dtype, case, s, d):
    """flash_mha at head dims 64 and 128 (the kernels' own) and 48 (padded
    to 64 by the wrapper): R1 + K1 forward and K2 backward, once each,
    against flash_mha_reference and flash_mha_bwd_reference at the bars
    above."""
    gen = torch.Generator(device=cuda).manual_seed(d * 1000 + s)
    q, k, v, do, tables, mask, causal = _shape_case(cuda, dtype, d, s, s,
                                                    case, gen)
    before = (rotate_qk.launches, flash_fwd.launches, flash_bwd.launches)
    out, grads = _autograd_path(q, k, v, do, tables, mask, causal)
    torch.cuda.synchronize()
    assert (rotate_qk.launches, flash_fwd.launches, flash_bwd.launches) == \
        tuple(b + 1 for b in before)
    ref = flash_mha_reference(q, k, v, mask, *tables, scale=0.1,
                              causal=causal)
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-5)
    else:
        torch.testing.assert_close(out.float(), ref.float(), rtol=2e-2,
                                   atol=2e-2)
        rel = (out.float() - ref.float()).norm() / ref.float().norm()
        assert rel <= K1_BF16_REL_L2, f"rel L2 {rel}"
    want = flash_mha_bwd_reference(q, k, v, do, mask, *tables, scale=0.1,
                                   causal=causal)
    _assert_grads_close(grads, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["plain", "xpos_causal", "masked"])
@pytest.mark.parametrize("lengths", [(256, 257), (399, 400), (130, 70),
                                     (70, 200), (1, 65)])
def test_separate_lengths_match_plain(cuda, dtype, case, lengths):
    """s_q queries against s_k keys at d = 64 (causal keeps col <= row,
    both from 0): R1 + K1 and K2 against the plain versions."""
    s_q, s_k = lengths
    gen = torch.Generator(device=cuda).manual_seed(s_q * 1000 + s_k)
    q, k, v, do, tables, mask, causal = _shape_case(cuda, dtype, 64, s_q,
                                                    s_k, case, gen)
    before = flash_bwd.launches
    out, grads = _autograd_path(q, k, v, do, tables, mask, causal)
    torch.cuda.synchronize()
    assert flash_bwd.launches == before + 1
    ref = flash_mha_reference(q, k, v, mask, *tables, scale=0.1,
                              causal=causal)
    _assert_out_close(out, ref, dtype, K1_BF16_REL_L2)
    want = flash_mha_bwd_reference(q, k, v, do, mask, *tables, scale=0.1,
                                   causal=causal)
    _assert_grads_close(grads, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lengths", [(65, 65), (196, 196), (4096, 4096),
                                     (256, 257)])
@pytest.mark.parametrize("d", [64, 128])
def test_online_kernels_at_head_dims_and_lengths(cuda, dtype, lengths, d):
    """R1 + K3, K4 and K5 at head dims 64 and 128 and with s_q != s_k:
    out and lse at K3's bars; the gradients, from the plain forward's lse
    and a delta with a non-zero lse cotangent, at K2's."""
    s_q, s_k = lengths
    gen = torch.Generator(device=cuda).manual_seed(d + s_q + s_k)
    q, k, v, do, tables, mask, causal = _shape_case(
        cuda, dtype, d, s_q, s_k, "xpos_causal" if s_q == s_k else "plain",
        gen)
    b, h = q.shape[:2]
    flat = [t.reshape(b * h, *t.shape[2:]).contiguous()
            for t in (q, k, v, do)]
    qr, kr = rotate_qk(flat[0], flat[1], *tables)
    before = (flash_fwd_online.launches, flash_bwd_dq.launches,
              flash_bwd_dkdv.launches)
    out, lse = flash_fwd_online(qr, kr, flat[2], mask, scale=0.1,
                                causal=causal, num_heads=h)
    ref, ref_lse = flash_mha_online_reference(q, k, v, mask, *tables,
                                              scale=0.1, causal=causal)
    _assert_out_close(out.reshape(q.shape), ref, dtype)
    assert (lse.reshape(b, h, s_q) - ref_lse).abs().max() <= LSE_ATOL
    g_lse = torch.randn(b, h, s_q, generator=gen, device=cuda)
    delta = (do.float() * ref.float()).sum(-1) - g_lse
    args = (qr, kr, flat[2], flat[3], ref_lse.reshape(b * h, s_q),
            delta.reshape(b * h, s_q), mask, *tables)
    (dq,) = flash_bwd_dq(*args, scale=0.1, causal=causal, num_heads=h)
    dk, dv = flash_bwd_dkdv(*args, scale=0.1, causal=causal, num_heads=h)
    torch.cuda.synchronize()
    assert (flash_fwd_online.launches, flash_bwd_dq.launches,
            flash_bwd_dkdv.launches) == tuple(n + 1 for n in before)
    want = flash_mha_bwd_online_reference(q, k, v, do, ref_lse, delta, mask,
                                          *tables, scale=0.1, causal=causal)
    _assert_grads_close([dq.reshape(q.shape), dk.reshape(k.shape),
                         dv.reshape(v.shape)], want, dtype)


def test_flash_mha_refuses_a_head_dim_below_one_on_the_card(cuda):
    q = torch.zeros(1, 1, 8, 0, device=cuda)
    with pytest.raises(ValueError, match="positive"):
        flash_mha(q, q, q, scale=1.0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["masked", "plain"])
@pytest.mark.parametrize("s_q,s_k", [(65, 65), (130, 70), (70, 200)])
@pytest.mark.parametrize("d", [1, 7, 63, 95, 127, 129, 130, 191, 192, 255,
                               257])
def test_odd_and_wide_head_dims_match_plain(cuda, dtype, case, s_q, s_k, d):
    """flash_mha at an odd head dim (the lanes' wrap in R1 and in the
    backwards' adjoint: in bf16 up to 256 and fp32 up to 128 in the
    epilogues of K2's own bodies, one or two consumer warpgroups) and past
    128: R1 + K1 and K2, one launch each, against the plain versions;
    causal with a key mask, and plain."""
    gen = torch.Generator(device=cuda).manual_seed(d * 1000 + s_q + s_k)
    q, k, v, do, tables, mask, causal = _shape_case(cuda, dtype, d, s_q,
                                                    s_k, case, gen)
    before = (rotate_qk.launches, flash_fwd.launches, flash_bwd.launches)
    out, grads = _autograd_path(q, k, v, do, tables, mask, causal)
    torch.cuda.synchronize()
    assert (rotate_qk.launches, flash_fwd.launches, flash_bwd.launches) == \
        tuple(b + 1 for b in before)
    ref = flash_mha_reference(q, k, v, mask, *tables, scale=0.1,
                              causal=causal)
    _assert_out_close(out, ref, dtype, K1_BF16_REL_L2)
    want = flash_mha_bwd_reference(q, k, v, do, mask, *tables, scale=0.1,
                                   causal=causal)
    _assert_grads_close(grads, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lengths", [(65, 65), (4096, 4096), (256, 257)])
@pytest.mark.parametrize("d", [7, 95, 127, 129, 160, 191, 192, 255, 256,
                               384, 768])
def test_online_kernels_at_odd_and_wide_head_dims(cuda, dtype, lengths, d):
    """R1 + K3 and R1 + K4 + K5 through flash_mha(return_lse=True) at odd
    head dims and past 128 (K4 and K5 in bf16 at d = 129-256 on their
    wgmma bodies, an odd d wrapping in their epilogues, at 384 on the
    sliced kernels, at 768 on the chain body in one call): out and lse at
    K3's bars, the gradients (an lse cotangent included) at K2's against
    the plain backward fed the kernels' lse and delta."""
    s_q, s_k = lengths
    gen = torch.Generator(device=cuda).manual_seed(d + s_q + s_k)
    q, k, v, do, tables, mask, causal = _shape_case(
        cuda, dtype, d, s_q, s_k, "xpos_causal" if s_q == s_k else "plain",
        gen)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before = (rotate_qk.launches, flash_fwd_online.launches,
              flash_bwd_dq.launches, flash_bwd_dkdv.launches)
    out, lse = flash_mha(*leaves, scale=0.1, causal=causal,
                         attention_mask=mask, qcos=tables[0], qsin=tables[1],
                         kcos=tables[2], ksin=tables[3], return_lse=True)
    g_lse = torch.randn(lse.shape, generator=gen, device=cuda)
    grads = torch.autograd.grad((out, lse), leaves, (do, g_lse))
    torch.cuda.synchronize()
    assert (rotate_qk.launches, flash_fwd_online.launches,
            flash_bwd_dq.launches, flash_bwd_dkdv.launches) == (
        before[0] + 2, *(n + 1 for n in before[1:]))
    ref, ref_lse = flash_mha_online_reference(q, k, v, mask, *tables,
                                              scale=0.1, causal=causal)
    _assert_out_close(out.detach(), ref, dtype)
    assert (lse[..., 0] - ref_lse).abs().max() <= LSE_ATOL
    delta = (do.float() * out.detach().float()).sum(-1) - g_lse[..., 0]
    want = flash_mha_bwd_online_reference(q, k, v, do, lse.detach()[..., 0],
                                          delta, mask, *tables, scale=0.1,
                                          causal=causal)
    _assert_grads_close(grads, want, dtype)


# The padded widths past 128 at which K1 and K3 run the forwards' wgmma
# body in bf16 (csrc/flash_fwd.cu; the wide body at the others and in fp32).
FWD_WGMMA_WIDTHS = (192, 256, 384, 768)


def _fwd_wgmma(d, dtype) -> bool:
    """Whether K1 and K3 run their own body (csrc/flash_fwd.cu) at d: up
    to a padded width of 128 in both dtypes, past it in bf16 at
    FWD_WGMMA_WIDTHS."""
    width = kernel_head_dim(d)
    return width <= 128 or (dtype == torch.bfloat16
                            and width in FWD_WGMMA_WIDTHS)


@pytest.mark.parametrize("d,dtype,body", [
    (192, torch.bfloat16, "wgmma"), (256, torch.bfloat16, "wgmma"),
    (191, torch.bfloat16, "wgmma"), (384, torch.bfloat16, "wgmma"),
    (95, torch.bfloat16, "wgmma"), (95, torch.float32, "wgmma"),
    (127, torch.bfloat16, "wgmma"), (129, torch.bfloat16, "wgmma"),
    (255, torch.bfloat16, "wgmma"), (129, torch.float32, "wide"),
    (330, torch.bfloat16, "wgmma"), (383, torch.bfloat16, "wide"),
    (320, torch.bfloat16, "wide"), (704, torch.bfloat16, "wide"),
    (768, torch.bfloat16, "chain"), (760, torch.bfloat16, "chain"),
    (767, torch.bfloat16, "wide"),
    (192, torch.float32, "wide"), (256, torch.float32, "wide"),
    (384, torch.float32, "wide"), (768, torch.float32, "wide")])
def test_streaming_backward_names_the_body_it_ran(cuda, d, dtype, body):
    """K4's and K5's last_source: their own bodies (the library's source:
    wgmma in bf16, FMA in fp32) at any d padded to 64-128, and in bf16 at
    any d padded to 192 or 256 (an odd d wrapping in their epilogues) and
    an even d padded to 384 (the sliced kernels), the chain body
    (csrc/flash_bwd_chain.cuh, K4 + K5 in one call) at an even d padded to
    768; the wide body at an odd d padded to 384 or 768, at the other
    widths past 256 and in fp32 past 128. K3 runs its
    wgmma body in bf16 at a padded width of 192, 256, 384 or 768, an odd d
    included (a forward has no adjoint), and the wide body in fp32 and at
    the other widths past 256 (320, 704)."""
    gen = torch.Generator(device=cuda).manual_seed(d)
    q, k, v, do, tables, mask, causal = _shape_case(
        cuda, dtype, d, 130, 130, "xpos_causal", gen)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = flash_mha(*leaves, scale=0.1, causal=causal, attention_mask=mask,
                    qcos=tables[0], qsin=tables[1], kcos=tables[2],
                    ksin=tables[3], force_online=True)
    before = (flash_bwd_dq.launches, flash_bwd_dkdv.launches,
              flash_bwd_dq_dkdv.launches)
    torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    for launcher in (flash_bwd_dq, flash_bwd_dkdv):
        want = {"wgmma": launcher.source, "wide": WIDE_SOURCE,
                "chain": CHAIN_SOURCE}[body]
        assert launcher.last_source == want, launcher.symbol
    # one launch of K4 and one of K5, both in one call
    assert (flash_bwd_dq.launches, flash_bwd_dkdv.launches,
            flash_bwd_dq_dkdv.launches) == (
        before[0] + 1, before[1] + 1, before[2] + 1)
    assert flash_fwd_online.last_source == (
        flash_fwd_online.source if _fwd_wgmma(d, dtype) else WIDE_SOURCE)


@pytest.mark.parametrize("d,dtype,body", [
    (160, torch.bfloat16, "wgmma"), (192, torch.bfloat16, "wgmma"),
    (200, torch.bfloat16, "wgmma"), (256, torch.bfloat16, "wgmma"),
    (191, torch.bfloat16, "wgmma"), (384, torch.bfloat16, "wgmma"),
    (95, torch.bfloat16, "wgmma"), (95, torch.float32, "wgmma"),
    (127, torch.bfloat16, "wgmma"), (129, torch.bfloat16, "wgmma"),
    (255, torch.bfloat16, "wgmma"), (129, torch.float32, "wide"),
    (320, torch.bfloat16, "wide"),
    (192, torch.float32, "wide"), (256, torch.float32, "wide"),
    (330, torch.bfloat16, "wgmma"), (383, torch.bfloat16, "wide"),
    (384, torch.float32, "wide"), (704, torch.bfloat16, "wide"),
    (768, torch.bfloat16, "chain"), (760, torch.bfloat16, "chain"),
    (767, torch.bfloat16, "wide"), (768, torch.float32, "wide")])
def test_resident_backward_names_the_body_it_ran(cuda, d, dtype, body):
    """K2's last_source: its own bodies (csrc/flash_bwd.cu: wgmma in bf16,
    FMA in fp32) at any d padded to 64-128, and in bf16 at any d padded to
    192 or 256 (an odd d wrapping in their epilogues) and an even d padded
    to 384 (the sliced kernels), its chain body (csrc/flash_bwd_chain.cuh)
    in bf16 at an even d padded to 768; the wide body at an odd d padded to
    384 or 768, at the other widths past 256 and in fp32 past 128. K1
    runs its own body (csrc/flash_fwd.cu) up to 128 and in bf16 at a
    padded width of 192, 256, 384 or 768 (an odd d included), and the wide
    body in fp32 past 128 and at 320 and 704."""
    gen = torch.Generator(device=cuda).manual_seed(d + 1)
    q, k, v, do, tables, mask, causal = _shape_case(
        cuda, dtype, d, 130, 130, "masked", gen)
    _autograd_path(q, k, v, do, tables, mask, causal)
    torch.cuda.synchronize()
    assert flash_bwd.last_source == {"wgmma": flash_bwd.source,
                                     "wide": WIDE_SOURCE,
                                     "chain": CHAIN_SOURCE}[body]
    assert flash_fwd.last_source == (
        flash_fwd.source if _fwd_wgmma(d, dtype) else WIDE_SOURCE)


def _nowrap_bwd(q, k, v, do, mask, tables, causal, lse=None, delta=None):
    """The plain backward without the lanes' wrap at an odd d: every input
    padded by one zero column (the tables by the identity), so that column
    d-1 pairs with that column and not with column 0; sliced back. The
    streaming form when lse and delta are given."""
    d = q.shape[-1]
    padded = _flat(d + 1, q, k, v, do)
    q1, k1, v1, do1 = (t.reshape(*q.shape[:2], t.shape[1], d + 1)
                       for t in padded)
    _, *tables1 = _kernel_tables(d + 1, None, *tables)
    if lse is None:
        grads = flash_mha_bwd_reference(q1, k1, v1, do1, mask, *tables1,
                                        scale=0.1, causal=causal)
    else:
        grads = flash_mha_bwd_online_reference(
            q1, k1, v1, do1, lse, delta, mask, *tables1, scale=0.1,
            causal=causal)
    return [g[..., :d] for g in grads]


@pytest.mark.parametrize("path", ["resident", "streaming"])
@pytest.mark.parametrize("s", [130, 200])
@pytest.mark.parametrize("d", [95, 191, 255])
def test_odd_head_dim_wrap_term_in_the_wgmma_epilogues(cuda, path, s, d):
    """Column d-1 of dq and dk carries the wrap term sin[0] g[0] at an odd
    d in bf16 on the backwards' own bodies (K2, or K4 + K5), a ragged last
    tile (s = 130 or 200) included: one consumer warpgroup at d = 95 (a
    shuffle within the quad), at 191 the dq kernel one and the dk/dv
    kernel two, at 255 both two (column 0 through shared memory). The
    gradients match the plain backward at K2's bars; column d-1 of dq and
    dk differs from the plain backward without the wrap by more than the
    element bar, and by more than ten times its own error."""
    gen = torch.Generator(device=cuda).manual_seed(d * 7 + s)
    q, k, v, do, tables, mask, causal = _shape_case(
        cuda, torch.bfloat16, d, s, s, "xpos_causal", gen)
    if path == "resident":
        out, grads = _autograd_path(q, k, v, do, tables, mask, causal)
        assert flash_bwd.last_source == flash_bwd.source
        want = flash_mha_bwd_reference(q, k, v, do, mask, *tables, scale=0.1,
                                       causal=causal)
        nowrap = _nowrap_bwd(q, k, v, do, mask, tables, causal)
    else:
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out, lse = flash_mha(*leaves, scale=0.1, causal=causal,
                             qcos=tables[0], qsin=tables[1], kcos=tables[2],
                             ksin=tables[3], return_lse=True)
        grads = torch.autograd.grad(out, leaves, do)
        for launcher in (flash_bwd_dq, flash_bwd_dkdv):
            assert launcher.last_source == launcher.source
        lse = lse.detach()[..., 0]
        delta = (do.float() * out.detach().float()).sum(-1)
        want = flash_mha_bwd_online_reference(q, k, v, do, lse, delta, mask,
                                              *tables, scale=0.1,
                                              causal=causal)
        nowrap = _nowrap_bwd(q, k, v, do, mask, tables, causal, lse, delta)
    torch.cuda.synchronize()
    _assert_grads_close(grads, want, torch.bfloat16)
    for name, got, a, b in zip(("dq", "dk"), grads, want, nowrap):
        col = got[..., d - 1].float()
        err = (col - a[..., d - 1].float()).abs().max()
        off = (col - b[..., d - 1].float()).abs()
        bar = BWD_BF16_ATOL + 2e-2 * b[..., d - 1].float().abs()
        assert (off > bar).any(), f"{name}: column d-1 has no wrap term"
        assert off.max() > 10 * err, f"{name}: {off.max()} vs {err}"


@pytest.mark.parametrize("case", ["masked", "pixel"])
@pytest.mark.parametrize("lengths", [(65, 65), (196, 196), (512, 512),
                                     (130, 70), (70, 200)])
@pytest.mark.parametrize("d", [160, 192, 200, 256, 384, 768])
def test_k1_wgmma_body_past_128_matches_plain(cuda, case, lengths, d):
    """R1 + K1 in bf16 at even head dims padded to 192, 256, 384 and 768
    (the forwards' wgmma body; on its sliced ring past 256), one launch of
    each a call on the inputs padded as flash_mha pads them (at d = 768
    and 512 keys flash_mha itself streams, as JAX routes it): out against
    flash_mha_reference at K1's bars."""
    s_q, s_k = lengths
    gen = torch.Generator(device=cuda).manual_seed(d * 11 + s_q + s_k)
    q, k, v, _, tables, mask, causal = _shape_case(
        cuda, torch.bfloat16, d, s_q, s_k, case, gen)
    width = kernel_head_dim(d)
    qp, kp, vp = _flat(width, q, k, v)
    kmask, *ptables = _kernel_tables(width, mask, *tables)
    before = (rotate_qk.launches, flash_fwd.launches)
    qr, kr = rotate_qk(qp, kp, *ptables, head_dim=d)
    out = flash_fwd(qr, kr, vp, kmask, scale=0.1, causal=causal,
                    num_heads=q.shape[1])
    torch.cuda.synchronize()
    assert (rotate_qk.launches, flash_fwd.launches) == (before[0] + 1,
                                                        before[1] + 1)
    assert flash_fwd.last_source == flash_fwd.source
    out = out[..., :d].reshape(q.shape)
    ref = flash_mha_reference(q, k, v, mask, *tables, scale=0.1,
                              causal=causal)
    _assert_out_close(out, ref, torch.bfloat16, K1_BF16_REL_L2)


_K2_LENGTHS = ((65, 65), (196, 196), (512, 512), (130, 70), (70, 200))


@pytest.mark.parametrize("case", ["masked", "pixel"])
@pytest.mark.parametrize("d,lengths", [
    (d, lengths) for d in (160, 192, 200, 256, 330, 384, 760, 768)
    for lengths in _K2_LENGTHS
    # flash_mha streams 512 keys at d past 704, as JAX routes it
    if d <= 704 or lengths != (512, 512)])
def test_k2_wgmma_bodies_past_128_match_plain(cuda, case, d, lengths):
    """K2 in bf16 at even head dims padded to 192 and 256 (its wgmma
    bodies: the dq kernel's statistics pass on one or two consumer
    warpgroups), 384 (the sliced kernels: Kr and V, or Qr and dO, in
    192-column slices) and 768 (the chain body: S and dP on FMA chains,
    the products on wgmma) through flash_mha and autograd, one launch of
    R1, K1 and K2 a call: the gradients against flash_mha_bwd_reference at
    K2's bars, out against flash_mha_reference at K1's."""
    s_q, s_k = lengths
    gen = torch.Generator(device=cuda).manual_seed(d * 1000 + s_q + s_k)
    q, k, v, do, tables, mask, causal = _shape_case(
        cuda, torch.bfloat16, d, s_q, s_k, case, gen)
    before = (rotate_qk.launches, flash_fwd.launches, flash_bwd.launches)
    out, grads = _autograd_path(q, k, v, do, tables, mask, causal)
    torch.cuda.synchronize()
    assert (rotate_qk.launches, flash_fwd.launches, flash_bwd.launches) == \
        tuple(b + 1 for b in before)
    assert flash_bwd.last_source == (
        CHAIN_SOURCE if kernel_head_dim(d) == 768 else flash_bwd.source)
    ref = flash_mha_reference(q, k, v, mask, *tables, scale=0.1,
                              causal=causal)
    _assert_out_close(out, ref, torch.bfloat16, K1_BF16_REL_L2)
    want = flash_mha_bwd_reference(q, k, v, do, mask, *tables, scale=0.1,
                                   causal=causal)
    _assert_grads_close(grads, want, torch.bfloat16)


@pytest.mark.parametrize("case", ["xpos_causal", "masked", "pixel"])
@pytest.mark.parametrize("lengths", [(65, 65), (1024, 1024), (4096, 4096),
                                     (256, 257)])
@pytest.mark.parametrize("d", [160, 192, 200, 256, 384, 768])
def test_k3_wgmma_body_past_128_matches_plain(cuda, case, lengths, d):
    """R1 + K3 in bf16 at even head dims padded to 192, 256, 384 and 768
    (the forwards' wgmma body at those widths, on its sliced ring past
    256) through flash_mha(return_lse=True), one launch each: out at K3's
    bars against
    flash_mha_online_reference and at K3_TILED_REL_L2 against its tiled
    order, lse within LSE_ATOL."""
    s_q, s_k = lengths
    gen = torch.Generator(device=cuda).manual_seed(d * 7 + s_q + s_k)
    q, k, v, _, tables, mask, causal = _shape_case(
        cuda, torch.bfloat16, d, s_q, s_k, case, gen)
    before = (rotate_qk.launches, flash_fwd_online.launches)
    with torch.no_grad():
        out, lse = flash_mha(q, k, v, scale=0.1, causal=causal,
                             attention_mask=mask, qcos=tables[0],
                             qsin=tables[1], kcos=tables[2], ksin=tables[3],
                             return_lse=True)
    torch.cuda.synchronize()
    assert (rotate_qk.launches, flash_fwd_online.launches) == (
        before[0] + 1, before[1] + 1)
    assert flash_fwd_online.last_source == flash_fwd_online.source
    ref, ref_lse = flash_mha_online_reference(q, k, v, mask, *tables,
                                              scale=0.1, causal=causal)
    _assert_out_close(out, ref, torch.bfloat16)
    assert (lse[..., 0] - ref_lse).abs().max() <= LSE_ATOL
    tiled = flash_mha_online_tiled_reference(q, k, v, mask, *tables,
                                             scale=0.1, causal=causal)[0]
    rel = (out.float() - tiled.float()).norm() / tiled.float().norm()
    assert rel <= K3_TILED_REL_L2, f"rel L2 {rel} against the tiled order"


@pytest.mark.parametrize("online", [False, True])
@pytest.mark.parametrize("d", [96, 384, 768])
def test_first_backward_launch_from_the_autograd_thread(cuda, d, online):
    """A fresh process whose first K2 launch (or, streaming, first K4 + K5
    launch) comes from the autograd engine's worker thread, where no
    context is current until a launcher makes the tensors' one current (the
    tensor maps' encoder needs it; the sliced kernels at 384 raised there
    before): finite gradients, one launch of each backward kernel."""
    code = textwrap.dedent(f"""
        import torch
        from meant_tpu_torch.ops.flash import (flash_bwd, flash_bwd_dkdv,
                                               flash_bwd_dq, flash_mha)
        q, k, v = (torch.randn(2, 2, 130, {d}, device="cuda",
                               dtype=torch.bfloat16, requires_grad=True)
                   for _ in range(3))
        out = flash_mha(q, k, v, scale=0.1, causal=True,
                        force_online={online})
        out.float().sum().backward()
        torch.cuda.synchronize()
        launches = (flash_bwd.launches, flash_bwd_dq.launches,
                    flash_bwd_dkdv.launches)
        assert launches == ((0, 1, 1) if {online} else (1, 0, 0)), launches
        assert all(bool(torch.isfinite(t.grad).all()) for t in (q, k, v))
        print("ok")
    """)
    res = subprocess.run([sys.executable, "-c", code],
                         cwd=Path(__file__).resolve().parents[1],
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0 and "ok" in res.stdout, res.stderr[-2000:]


# The streaming backward's launches past d = 256 on the main path: --num_heads
# 1's text tower (BH, s, d, heads) = (80, 512, 768), the chain body, and
# src4096 --num_heads 2's (20, 4096, 384), the sliced kernels.
PAST_256_LAUNCHES = ((768, 80, 1, 512), (384, 20, 2, 4096))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("d,bh,heads,s", PAST_256_LAUNCHES)
def test_streaming_backward_past_256_matches_plain_at_the_model_shapes(
        cuda, d, bh, heads, s, masked):
    """K4 and K5 in bf16 at the main path's launches past d = 256, causal
    xPos with and without a key mask, on R1's Qr and Kr, the plain
    forward's lse and a delta that carries an lse cotangent: each against
    its plain version at K2's bars, naming its body (the chain body at 768,
    the sliced kernels' library at 384); at 768 K4 + K5 in one call (as
    the main path launches them: one launch of each counted) bit for bit
    K4 and K5 apart."""
    gen = torch.Generator(device=cuda).manual_seed(d + s + masked)
    b = bh // heads
    q, k, v, do = (torch.randn(b, heads, s, d, generator=gen, device=cuda)
                   .to(torch.bfloat16) for _ in range(4))
    tables = _tables(s, d, lang_freqs(d // 2, device=cuda), True, 512.0)
    mask = None
    if masked:
        mask = (torch.rand(b, s, generator=gen, device=cuda) > 0.3).float()
        mask[:, 0] = 1.0
    out, lse = flash_mha_online_reference(q, k, v, mask, *tables, scale=0.1,
                                          causal=True)
    g_lse = torch.randn(lse.shape, generator=gen, device=cuda)
    delta = (do.float() * out.float()).sum(-1) - g_lse
    del out
    qf, kf, vf, dof = (t.reshape(bh, s, d).contiguous()
                       for t in (q, k, v, do))
    qr, kr = rotate_qk(qf, kf, *tables)
    args = (qr, kr, vf, dof, lse.reshape(bh, s).contiguous(),
            delta.reshape(bh, s).contiguous(), mask, *tables)
    kw = dict(scale=0.1, causal=True, num_heads=heads)
    (dq,) = flash_bwd_dq(*args, **kw)
    dk, dv = flash_bwd_dkdv(*args, **kw)
    torch.cuda.synchronize()
    body = CHAIN_SOURCE if d == 768 else flash_bwd_dq.source
    assert flash_bwd_dq.last_source == flash_bwd_dkdv.last_source == body
    want = flash_mha_bwd_online_reference(q, k, v, do, lse, delta, mask,
                                          *tables, scale=0.1, causal=True)
    _assert_grads_close([t.reshape(q.shape) for t in (dq, dk, dv)], want,
                        torch.bfloat16)
    if d == 768:
        before = (flash_bwd_dq.launches, flash_bwd_dkdv.launches)
        joint = flash_bwd_dq_dkdv(*args, **kw)
        torch.cuda.synchronize()
        assert (flash_bwd_dq.launches, flash_bwd_dkdv.launches) == (
            before[0] + 1, before[1] + 1)
        for a, b_ in zip(joint, (dq, dk, dv)):
            assert torch.equal(a, b_)


@pytest.mark.parametrize("n", [1, 3, 4, 1027, 1 << 20])
def test_adamw_kernel_with_a_bf16_first_moment_matches_plain(cuda, n):
    """A1's bf16-m variant against its plain version on the CPU: p and v
    within 1e-6 relative, m bit for bit (both round the same fp32 m' to
    nearest even)."""
    gen = torch.Generator(device=cuda).manual_seed(n + 7)
    p = torch.randn(n, generator=gen, device=cuda)
    g = torch.randn(n, generator=gen, device=cuda) * 0.5
    m = (torch.randn(n, generator=gen, device=cuda) * 0.1).to(torch.bfloat16)
    v = torch.rand(n, generator=gen, device=cuda) * 0.1
    norm = torch.linalg.vector_norm(g)
    kw = dict(lr=1e-3, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01,
              step=3, max_norm=1.0)
    ref = [t.cpu() for t in (p, m, v)]
    adamw_update(ref[0], g.cpu(), ref[1], ref[2], norm=norm.cpu(), **kw)
    before = fused_adamw.launches
    adamw_update(p, g, m, v, norm=norm, **kw)
    torch.cuda.synchronize()
    assert fused_adamw.launches == before + 1 and m.dtype == torch.bfloat16
    torch.testing.assert_close(m.cpu(), ref[1], rtol=0, atol=0)
    for got, want in ((p, ref[0]), (v, ref[2])):
        err = ((got.cpu() - want).abs() / want.abs().clamp_min(1e-30)).max()
        assert err <= 1e-6, f"max relative error {err}"


@pytest.mark.parametrize("extra", [dict(accumulation_steps=2),
                                   dict(mu_dtype=torch.bfloat16)],
                         ids=["accumulation", "mu_bf16"])
def test_narrow_src_trainer_extras_launch_a1_as_optax(cuda, extra):
    """A narrow meant_src trainer on the card with accumulation_steps=2
    (A1 on every second micro-step, the parameters held in between) or a
    bf16 first moment (A1 every step): 4 steps with their launch counts."""
    import numpy as np
    model = _narrow_src(cuda)
    rows = dict(_src_rows(8, 64, seed=5),
                y=np.array([0, 1] * 4, np.int32))
    trainer = meant_trainer({"model": model, "model_name": "meant_src",
                             "train_loader": ArrayLoader(rows, 4),
                             "lr": 1e-3, "lrst": "constant", **extra})
    batch = {k: host_tensor(v[:4]).to(cuda) for k, v in rows.items()}
    trainer._init_state()
    a1 = fused_adamw.launches
    for i in range(4):
        before = trainer.optimizer.flat_p.clone()
        trainer.train_step(batch)
        torch.cuda.synchronize()
        moved = not torch.equal(trainer.optimizer.flat_p, before)
        assert moved == ("accumulation_steps" not in extra or i % 2 == 1)
    k = extra.get("accumulation_steps", 1)
    assert fused_adamw.launches == a1 + 4 // k
    assert trainer.optimizer.m.dtype == extra.get("mu_dtype", torch.float32)


# ---- length-bucketed training and the host data path --------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["xpos_causal", "masked"])
@pytest.mark.parametrize("s", [256, 384])
def test_bucket_lengths_match_plain(cuda, dtype, case, s):
    """R1 + K1 and R1 + K2 at the middle bucket lengths of --buckets
    128,256,384,512 (causal xPos, as the text tower runs them), against
    the plain versions at the bars above."""
    q, k, v, tables, mask, causal = _k1_case(cuda, dtype, case, s)
    out = _resident_fwd(q, k, v, tables, mask, causal)
    ref = flash_mha_reference(q, k, v, mask, *tables, scale=0.1,
                              causal=causal)
    assert torch.isfinite(out).all()
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-5)
    else:
        torch.testing.assert_close(out.float(), ref.float(), rtol=2e-2,
                                   atol=2e-2)
        rel = (out.float() - ref.float()).norm() / ref.float().norm()
        assert rel <= K1_BF16_REL_L2, f"rel L2 {rel}"
    gen = torch.Generator(device=cuda).manual_seed(2000 + s)
    q, k, v, do, tables, mask, causal = _bwd_case(cuda, dtype, case, s, gen)
    got = _resident_bwd(q, k, v, do, tables, mask, causal)
    want = flash_mha_bwd_reference(q, k, v, do, mask, *tables, scale=0.1,
                                   causal=causal)
    _assert_grads_close(got, want, dtype)


def test_background_save_holds_the_state_before_the_next_a1_step(
        cuda, tmp_path):
    """checkpoint.save(block=False) of a narrow meant_src trainer's params
    and moments, then an A1 step at once: after wait_for_saves the file
    holds the state of before the step, bit for bit."""
    import numpy as np
    from meant_tpu_torch.train import checkpoint as ckpt
    model = _narrow_src(cuda)
    rows = dict(_src_rows(4, 64, seed=7), y=np.array([0, 1] * 2, np.int32))
    trainer = meant_trainer({"model": model, "model_name": "meant_src",
                             "train_loader": ArrayLoader(rows, 4),
                             "lr": 1e-3, "lrst": "constant"})
    batch = {k: host_tensor(v).to(cuda) for k, v in rows.items()}
    trainer.train_step(batch)
    opt = trainer.optimizer
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    m, v = opt.m.clone(), opt.v.clone()
    path = str(tmp_path / "ckpt")
    a1 = fused_adamw.launches
    ckpt.save(path, {"params": model.state_dict(),
                     "opt_state": opt.state_dict()}, block=False)
    trainer.train_step(batch)
    ckpt.wait_for_saves()
    assert fused_adamw.launches == a1 + 1
    assert not torch.equal(opt.m, m)
    saved = ckpt.restore(path)
    for key, value in before.items():
        assert torch.equal(saved["params"][key], value.cpu()), key
    assert torch.equal(saved["opt_state"]["m"], m.cpu())
    assert torch.equal(saved["opt_state"]["v"], v.cpu())


def test_prefetcher_workers_deliver_in_order_on_the_card(cuda):
    """Prefetcher(workers=3) on the card gives workers=1's batches, in
    order and bit for bit."""
    from meant_tpu_torch.data.loader import Prefetcher
    rows = dict(_src_rows(40, 64, seed=9))

    def epoch(workers):
        return [{k: t.cpu() for k, t in b.items()} for b in Prefetcher(
            ArrayLoader(rows, 4, shuffle=True, seed=2), cuda,
            workers=workers)]

    one, three = epoch(1), epoch(3)
    assert len(one) == len(three) == 10
    for a, b in zip(one, three):
        assert all(torch.equal(a[k], b[k]) for k in a)
