"""Rotary-fused flash-attention forward (counterpart of
meant_tpu/ops/flash/kernel.py, resident forward `_fwd_kernel` via
`flash_mha`).

On a CUDA tensor `flash_mha` launches the hand-written kernel in
`csrc/flash_fwd.cu` or raises; on a CPU tensor it runs the plain version
`flash_mha_reference` (the same math as the JAX package's `_xla_reference`).
There is no fallback from the kernel to the plain version.

Left out on purpose (TPU-only in the JAX package): SPMD partitioning,
interpret mode, the VMEM sizing models and the outside padding to block
multiples -- the CUDA kernel masks its own ragged edge.
"""

from __future__ import annotations

import ctypes
from collections import Counter
from typing import Optional

import torch

from meant_tpu_torch.ops.attention import attend
from meant_tpu_torch.ops.rotary import rotate_half

HEAD_DIM = 96                  # the one head dim csrc/flash_fwd.cu builds
# Relative L2 error the bf16 kernel is held to against flash_mha_reference
# on the card (chip_smoke.py, tests/test_torch_cuda.py). It reads 2.7e-3 to
# 3.1e-3 at the main path's shapes and the card tests' shapes; a pair of
# rotated features that shares one table entry under xPos reads 6.7e-3
# (PERF.md).
BF16_REL_L2 = 5e-3
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


class FlashForward:
    """ctypes wrapper of `meant_flash_fwd`. `launches` counts kernel
    launches (one per call that reaches the card); `launches_by_shape`
    splits the same count by (seq, causal)."""

    def __init__(self):
        self.launches = 0
        self.launches_by_shape: Counter = Counter()
        self._fn = None

    def _function(self):
        if self._fn is None:
            from meant_tpu_torch.cuda_build import load_library
            fn = load_library("flash_fwd").meant_flash_fwd
            fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 9
                           + [ctypes.c_int] * 5 + [ctypes.c_float,
                                                   ctypes.c_int,
                                                   ctypes.c_void_p])
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def __call__(self, q, k, v, kmask, qcos, qsin, kcos, ksin, *,
                 scale: float, causal: bool, num_heads: int) -> torch.Tensor:
        """q/k/v: (BH, s, d) CUDA, contiguous, fp32 or bf16; tables (s, d)
        fp32; kmask (b | 1, s) fp32 or None. Returns (BH, s, d)."""
        bh, s, d = q.shape
        if q.dtype not in _DTYPE_CODES:
            raise TypeError(f"flash kernel takes fp32 or bf16, got {q.dtype}")
        if d != HEAD_DIM:
            raise ValueError(f"flash kernel is built for head dim {HEAD_DIM}, "
                             f"got {d}")
        for name, t in (("k", k), ("v", v)):
            if t.shape != q.shape or t.dtype != q.dtype:
                raise ValueError(f"{name} {tuple(t.shape)} {t.dtype} must "
                                 f"match q {tuple(q.shape)} {q.dtype}")
        tensors = [q, k, v, qcos, qsin, kcos, ksin]
        for t in (qcos, qsin, kcos, ksin):
            if t.shape != (s, d) or t.dtype != torch.float32:
                raise ValueError(f"rotation tables must be ({s}, {d}) fp32, "
                                 f"got {tuple(t.shape)} {t.dtype}")
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
        out = torch.empty_like(q)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        with torch.cuda.device(q.device):
            err = self._function()(
                _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(),
                v.data_ptr(), out.data_ptr(), qcos.data_ptr(),
                qsin.data_ptr(), kcos.data_ptr(), ksin.data_ptr(),
                kmask.data_ptr() if kmask is not None else None, mask_rows,
                bh, s, d, num_heads, float(scale), int(bool(causal)), stream)
        if err != 0:
            raise RuntimeError(f"flash_fwd launch failed: cudaError {err}")
        self.launches += 1
        self.launches_by_shape[(s, bool(causal))] += 1
        return out


flash_fwd = FlashForward()


def identity_tables(s: int, d: int, device) -> tuple:
    """(cos, sin) = (1, 0) tables: no rotation."""
    return (torch.ones((s, d), dtype=torch.float32, device=device),
            torch.zeros((s, d), dtype=torch.float32, device=device))


def flash_mha_reference(q, k, v, kmask, qcos, qsin, kcos, ksin, *,
                        scale: float, causal: bool) -> torch.Tensor:
    """Plain PyTorch version of the kernel: rotate in fp32 with the tables,
    round to the input dtype, then `attend`. q/k/v: (b, h, s, d); kmask
    (b | 1, s_k) float or None."""

    def rot(t, cos, sin):
        tf = t.to(torch.float32)
        return (tf * cos + rotate_half(tf) * sin).to(t.dtype)

    return attend(rot(q, qcos, qsin), rot(k, kcos, ksin), v, scale=scale,
                  causal=causal, attention_mask=kmask)


def flash_mha(q, k, v, *, scale: float, causal: bool = False,
              attention_mask: Optional[torch.Tensor] = None,
              qcos=None, qsin=None, kcos=None, ksin=None) -> torch.Tensor:
    """Fused rotary + attention. q/k/v: (b, h, s, d) with one length s; the
    four tables are (s, d) fp32 (identity rotation when None);
    attention_mask: (b | 1, s) of {0, 1}."""
    b, h, s, d = q.shape
    if k.shape[2] != s or v.shape[2] != s:
        raise ValueError("flash_mha takes one sequence length for q, k, v")
    if qcos is None:
        qcos, qsin = identity_tables(s, d, q.device)
    if kcos is None:
        kcos, ksin = identity_tables(s, d, q.device)
    kmask = None
    if attention_mask is not None:
        kmask = attention_mask.to(torch.float32)
    if q.device.type == "cpu":
        return flash_mha_reference(q, k, v, kmask, qcos, qsin, kcos, ksin,
                                   scale=scale, causal=causal)
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_mha runs on CUDA or CPU, not {q.device}")
    out = flash_fwd(
        q.reshape(b * h, s, d).contiguous(),
        k.reshape(b * h, s, d).contiguous(),
        v.reshape(b * h, s, d).contiguous(),
        None if kmask is None else kmask.contiguous(),
        qcos.contiguous(), qsin.contiguous(), kcos.contiguous(),
        ksin.contiguous(), scale=scale, causal=causal, num_heads=h)
    return out.reshape(b, h, s, d)
