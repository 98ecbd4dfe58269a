"""Rotary-fused flash attention, forward and backward (counterpart of
meant_tpu/ops/flash/kernel.py: the resident forward `_fwd_kernel`, K1, and
the resident backward `_bwd_kernel`, K2, behind `flash_mha`'s custom VJP).

On CUDA tensors `flash_mha` launches the hand-written kernels in
`csrc/flash_fwd.cu` (forward) and `csrc/flash_bwd.cu` (backward, through a
`torch.autograd.Function` when gradients are needed) or raises; on CPU
tensors it runs their plain versions `flash_mha_reference` (the same math
as the JAX package's `_xla_reference`) and `flash_mha_bwd_reference`.
There is no fallback from a kernel to its plain version.

Left out on purpose (TPU-only in the JAX package): SPMD partitioning,
interpret mode, the VMEM sizing models and the outside padding to block
multiples -- the CUDA kernel masks its own ragged edge.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from meant_tpu_torch.cuda_build import KernelLauncher
from meant_tpu_torch.ops.attention import attend
from meant_tpu_torch.ops.rotary import rotate_half

HEAD_DIM = 96                  # the one head dim csrc/flash_*.cu build
# Relative L2 error the bf16 kernel is held to against flash_mha_reference
# on the card (chip_smoke.py, tests/test_torch_cuda.py). It reads 2.7e-3 to
# 3.1e-3 at the main path's shapes and the card tests' shapes; a pair of
# rotated features that shares one table entry under xPos reads 6.7e-3
# (PERF.md).
BF16_REL_L2 = 5e-3
# Bars of the bf16 backward (K2) against flash_mha_bwd_reference on the card,
# per gradient: 2e-2 relative plus BWD_BF16_ATOL per element, and relative
# L2. K2 rounds P and dS where the plain version does, and reads 6.1e-5 to
# 9.9e-5 relative L2 (one bf16 step per element at most) at the main path's
# shapes; dS rounded toward zero reads 4.7e-3 and a sign slip in the
# rotation's adjoint 0.49 (PERF.md, tools/k2_faults.py).
BWD_BF16_ATOL = 2e-2
BWD_BF16_REL_L2 = 5e-4
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _dtype_code(q) -> int:
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"flash kernel takes fp32 or bf16, got {q.dtype}")
    return _DTYPE_CODES[q.dtype]


def _check_launch_inputs(q, others, tables, kmask, num_heads):
    """What both kernels refuse: q (BH, s, 96) fp32/bf16; every tensor in
    `others` of q's shape and dtype; tables (s, 96) fp32; kmask (b | 1, s)
    fp32 or None; all contiguous on q's device. Returns the mask's row
    count (0 without a mask)."""
    bh, s, d = q.shape
    _dtype_code(q)
    if d != HEAD_DIM:
        raise ValueError(f"flash kernel is built for head dim {HEAD_DIM}, "
                         f"got {d}")
    for name, t in others.items():
        if t.shape != q.shape or t.dtype != q.dtype:
            raise ValueError(f"{name} {tuple(t.shape)} {t.dtype} must "
                             f"match q {tuple(q.shape)} {q.dtype}")
    for t in tables:
        if t.shape != (s, d) or t.dtype != torch.float32:
            raise ValueError(f"rotation tables must be ({s}, {d}) fp32, "
                             f"got {tuple(t.shape)} {t.dtype}")
    tensors = [q, *others.values(), *tables]
    mask_rows = 0
    if kmask is not None:
        mask_rows = kmask.shape[0]
        if (kmask.dim() != 2 or kmask.shape[1] != s
                or kmask.dtype != torch.float32
                or mask_rows not in (1, bh // num_heads)):
            raise ValueError(f"kmask must be (b | 1, {s}) fp32, got "
                             f"{tuple(kmask.shape)} {kmask.dtype}")
        tensors.append(kmask)
    for t in tensors:
        if t.device != q.device or not t.is_contiguous():
            raise ValueError("flash kernel inputs must be contiguous "
                             f"tensors on {q.device}")
    if bh % num_heads:
        raise ValueError(f"BH={bh} is not a multiple of {num_heads} heads")
    return mask_rows


class FlashForward(KernelLauncher):
    """K1: ctypes wrapper of `meant_flash_fwd` (csrc/flash_fwd.cu)."""

    symbol, library = "meant_flash_fwd", "flash_fwd"
    argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
                + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])

    def __call__(self, q, k, v, kmask, qcos, qsin, kcos, ksin, *,
                 scale: float, causal: bool, num_heads: int) -> torch.Tensor:
        """q/k/v: (BH, s, d) CUDA, contiguous, fp32 or bf16; tables (s, d)
        fp32; kmask (b | 1, s) fp32 or None. Returns (BH, s, d)."""
        bh, s, d = q.shape
        mask_rows = _check_launch_inputs(q, {"k": k, "v": v},
                                         (qcos, qsin, kcos, ksin), kmask,
                                         num_heads)
        out = torch.empty_like(q)
        self._launch(
            q.device, _dtype_code(q), q.data_ptr(), k.data_ptr(),
            v.data_ptr(), out.data_ptr(), qcos.data_ptr(), qsin.data_ptr(),
            kcos.data_ptr(), ksin.data_ptr(),
            kmask.data_ptr() if kmask is not None else None, mask_rows, bh,
            s, d, num_heads, float(scale), int(bool(causal)),
            shape=(s, bool(causal)))
        return out


class FlashBackward(KernelLauncher):
    """K2: ctypes wrapper of `meant_flash_bwd` (csrc/flash_bwd.cu), one
    call = its dq kernel then its dk/dv kernel on the current stream."""

    symbol, library = "meant_flash_bwd", "flash_bwd"
    argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 13 + [ctypes.c_int] * 5
                + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])

    def __call__(self, q, k, v, do, kmask, qcos, qsin, kcos, ksin, *,
                 scale: float, causal: bool, num_heads: int) -> tuple:
        """q/k/v/do: (BH, s, d) CUDA, contiguous, fp32 or bf16; tables and
        kmask as for the forward. Returns (dq, dk, dv), each (BH, s, d)."""
        bh, s, d = q.shape
        mask_rows = _check_launch_inputs(q, {"k": k, "v": v, "do": do},
                                         (qcos, qsin, kcos, ksin), kmask,
                                         num_heads)
        dq, dk, dv = (torch.empty_like(q) for _ in range(3))
        # per row: max, 1/denominator, delta (written by the dq kernel,
        # read by the dk/dv kernel)
        stats = torch.empty((3, bh, s), dtype=torch.float32, device=q.device)
        self._launch(
            q.device, _dtype_code(q), q.data_ptr(), k.data_ptr(),
            v.data_ptr(), do.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), stats.data_ptr(), qcos.data_ptr(),
            qsin.data_ptr(), kcos.data_ptr(), ksin.data_ptr(),
            kmask.data_ptr() if kmask is not None else None, mask_rows, bh,
            s, d, num_heads, float(scale), int(bool(causal)),
            shape=(s, bool(causal)))
        return dq, dk, dv


flash_fwd = FlashForward()
flash_bwd = FlashBackward()


def identity_tables(s: int, d: int, device) -> tuple:
    """(cos, sin) = (1, 0) tables: no rotation."""
    return (torch.ones((s, d), dtype=torch.float32, device=device),
            torch.zeros((s, d), dtype=torch.float32, device=device))


def _rotate(t, cos, sin):
    """x*cos + rotate_half(x)*sin in fp32, rounded to t's dtype."""
    tf = t.to(torch.float32)
    return (tf * cos + rotate_half(tf) * sin).to(t.dtype)


def flash_mha_reference(q, k, v, kmask, qcos, qsin, kcos, ksin, *,
                        scale: float, causal: bool) -> torch.Tensor:
    """Plain PyTorch version of K1: rotate in fp32 with the tables, round to
    the input dtype, then `attend`. q/k/v: (b, h, s, d); kmask (b | 1, s_k)
    float or None."""
    return attend(_rotate(q, qcos, qsin), _rotate(k, kcos, ksin), v,
                  scale=scale, causal=causal, attention_mask=kmask)


def flash_mha_bwd_reference(q, k, v, do, kmask, qcos, qsin, kcos, ksin, *,
                            scale: float, causal: bool) -> tuple:
    """Plain PyTorch version of K2, step by step as the JAX package's
    `_bwd_kernel` (meant_tpu/ops/flash/kernel.py:321-390): P recomputed in
    fp32; dV from P rounded to the input dtype; delta = rowsum(P * dP); dS
    rounded to the input dtype before the dQ/dK products; the rotation's
    adjoint cos*g - rotate_half(sin*g) applied after them. q/k/v/do:
    (b, h, s, d); kmask (b | 1, s) or None. Returns (dq, dk, dv) in q's
    dtype."""
    f32 = torch.float32
    dt = q.dtype
    qr, kr = _rotate(q, qcos, qsin), _rotate(k, kcos, ksin)
    scores = torch.matmul(qr.to(f32), kr.to(f32).transpose(-1, -2)) * scale
    if causal:
        s_q, s_k = scores.shape[-2], scores.shape[-1]
        row = torch.arange(s_q, device=q.device)[:, None]
        col = torch.arange(s_k, device=q.device)[None, :]
        scores = scores.masked_fill(col > row, float("-inf"))
    if kmask is not None:
        scores = scores + ((1.0 - kmask.to(f32)) * -1e9)[:, None, None, :]
    p = torch.softmax(scores, dim=-1)
    dof = do.to(f32)
    dv = torch.matmul(p.to(dt).to(f32).transpose(-1, -2), dof)
    dp = torch.matmul(dof, v.to(f32).transpose(-1, -2))
    delta = torch.sum(p * dp, dim=-1, keepdim=True)
    ds = (p * (dp - delta) * scale).to(dt).to(f32)
    dqr = torch.matmul(ds, kr.to(f32))
    dkr = torch.matmul(ds.transpose(-1, -2), qr.to(f32))
    dq = qcos * dqr - rotate_half(qsin * dqr)
    dk = kcos * dkr - rotate_half(ksin * dkr)
    return dq.to(dt), dk.to(dt), dv.to(dt)


def _forward(q, k, v, kmask, qcos, qsin, kcos, ksin, scale, causal):
    """K1 on the card, its plain version on the CPU. (b, h, s, d) in and
    out."""
    if q.device.type == "cpu":
        return flash_mha_reference(q, k, v, kmask, qcos, qsin, kcos, ksin,
                                   scale=scale, causal=causal)
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_mha runs on CUDA or CPU, not {q.device}")
    b, h, s, d = q.shape
    out = flash_fwd(
        q.reshape(b * h, s, d).contiguous(),
        k.reshape(b * h, s, d).contiguous(),
        v.reshape(b * h, s, d).contiguous(),
        None if kmask is None else kmask.contiguous(),
        qcos.contiguous(), qsin.contiguous(), kcos.contiguous(),
        ksin.contiguous(), scale=scale, causal=causal, num_heads=h)
    return out.reshape(b, h, s, d)


def _backward(q, k, v, do, kmask, qcos, qsin, kcos, ksin, scale, causal):
    """K2 on the card, its plain version on the CPU. (b, h, s, d) in and
    out."""
    if q.device.type == "cpu":
        return flash_mha_bwd_reference(q, k, v, do, kmask, qcos, qsin, kcos,
                                       ksin, scale=scale, causal=causal)
    b, h, s, d = q.shape
    flat = (t.reshape(b * h, s, d).contiguous() for t in (q, k, v, do))
    grads = flash_bwd(
        *flat, None if kmask is None else kmask.contiguous(),
        qcos.contiguous(), qsin.contiguous(), kcos.contiguous(),
        ksin.contiguous(), scale=scale, causal=causal, num_heads=h)
    return tuple(g.reshape(b, h, s, d) for g in grads)


class _FlashAttention(torch.autograd.Function):
    """K1 forward, K2 backward (the JAX package's custom VJP, `_make_flash`
    kernel.py:851-862, 916-934). Saves what JAX saves: q, k, v, the mask
    and the tables; the tables and the mask get no gradient (JAX returns
    zeros for them)."""

    @staticmethod
    def forward(ctx, q, k, v, kmask, qcos, qsin, kcos, ksin, scale, causal):
        ctx.save_for_backward(q, k, v, kmask, qcos, qsin, kcos, ksin)
        ctx.scale, ctx.causal = scale, causal
        return _forward(q, k, v, kmask, qcos, qsin, kcos, ksin, scale, causal)

    @staticmethod
    def backward(ctx, do):
        q, k, v, kmask, qcos, qsin, kcos, ksin = ctx.saved_tensors
        dq, dk, dv = _backward(q, k, v, do, kmask, qcos, qsin, kcos, ksin,
                               ctx.scale, ctx.causal)
        return dq, dk, dv, None, None, None, None, None, None, None


def flash_mha(q, k, v, *, scale: float, causal: bool = False,
              attention_mask: Optional[torch.Tensor] = None,
              qcos=None, qsin=None, kcos=None, ksin=None) -> torch.Tensor:
    """Fused rotary + attention. q/k/v: (b, h, s, d) with one length s; the
    four tables are (s, d) fp32 (identity rotation when None);
    attention_mask: (b | 1, s) of {0, 1}. When autograd needs gradients of
    q, k or v the call goes through K1 forward / K2 backward; otherwise
    (inference) it is the bare forward."""
    b, h, s, d = q.shape
    if k.shape[2] != s or v.shape[2] != s:
        raise ValueError("flash_mha takes one sequence length for q, k, v")
    if q.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"flash_mha runs on CUDA or CPU, not {q.device}")
    if qcos is None:
        qcos, qsin = identity_tables(s, d, q.device)
    if kcos is None:
        kcos, ksin = identity_tables(s, d, q.device)
    kmask = None
    if attention_mask is not None:
        kmask = attention_mask.to(torch.float32)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, kmask, qcos, qsin, kcos, ksin,
                                     scale, causal)
    return _forward(q, k, v, kmask, qcos, qsin, kcos, ksin, scale, causal)
