"""Fused AdamW / Adam update (counterpart of the Pallas kernel A1,
scripts/probe_fused_adamw.py `_kernel` / `pallas_adamw`, extended to the
whole update of the trainer's optax chain, meant_tpu/train/optim.py).

`adamw_update` updates flat fp32 buffers p, m, v in place from the gradient
buffer g; m may be bf16 instead (optax's `mu_dtype=bfloat16`, the trainer's
--mu_bf16): read and widened to fp32, updated in fp32, the update taken
from that fp32 value, stored rounded to nearest even. On CUDA tensors it
launches the hand-written kernel in `csrc/adamw.cu` (one launch over every
trainable parameter) or raises; on CPU tensors it runs the plain version
`adamw_reference`, which repeats the kernel operation for operation.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from meant_tpu_torch.cuda_build import KernelLauncher


class AdamWKernel(KernelLauncher):
    """A1: ctypes wrapper of `meant_adamw` (csrc/adamw.cu); its launches
    are keyed by parameter count."""

    symbol, library = "meant_adamw", "adamw"
    argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong]
                + [ctypes.c_float] * 9
                + [ctypes.c_void_p, ctypes.c_float, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p])

    def __call__(self, p, g, m, v, h: dict, norm: Optional[torch.Tensor],
                 max_norm: float) -> None:
        """p, g, v: 1-D contiguous fp32 CUDA tensors of one length, m
        the same in fp32 or bf16; h: the scalars of `update_scalars`
        (`mu_bf16` as m's dtype says); norm: the fp32 device scalar |g| or
        None (no clipping)."""
        for name, t in (("g", g), ("m", m), ("v", v)):
            if t.shape != p.shape or t.device != p.device:
                raise ValueError(f"{name} {tuple(t.shape)} on {t.device} "
                                 f"must match p")
        for t in (p, g, m, v):
            if (t.dtype != (MU_DTYPE if t is m and h["mu_bf16"]
                            else torch.float32)
                    or t.dim() != 1 or not t.is_contiguous()):
                raise ValueError("adamw kernel takes 1-D contiguous fp32 "
                                 "buffers (m in bf16 with mu_bf16)")
        if norm is not None and (norm.numel() != 1 or norm.device != p.device
                                 or norm.dtype != torch.float32):
            raise ValueError("norm must be one fp32 value on p's device")
        num_sms = torch.cuda.get_device_properties(
            p.device).multi_processor_count
        self._launch(
            p.device, p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(),
            p.numel(), h["lr"], h["b1"], h["one_minus_b1"], h["b2"],
            h["one_minus_b2"], h["eps"], h["wd"], h["c1"], h["c2"],
            None if norm is None else norm.data_ptr(), float(max_norm),
            int(h["coupled"]), int(h["mu_bf16"]), num_sms, shape=p.numel())


fused_adamw = AdamWKernel()
MU_DTYPE = torch.bfloat16      # the one first-moment type besides fp32


def update_scalars(*, lr, b1, b2, eps, weight_decay, step, coupled,
                   mu_bf16: bool = False) -> dict:
    """Every scalar of one update as a Python float, computed in float64
    as the plain version's Python arithmetic computes it (1 - b1 included)
    and rounded to fp32 once, when passed on. step counts from 1. With a
    bf16 first moment the b1 that multiplies it is b1 rounded to bf16, as
    JAX promotes the weakly typed 0.9 of optax's moment update to the
    moment's type (0.8984375); 1 - b1 and the bias correction keep b1."""
    b1_m = (float(torch.tensor(b1, dtype=MU_DTYPE)) if mu_bf16
            else float(b1))
    return dict(lr=float(lr), b1=b1_m, one_minus_b1=1.0 - b1,
                b2=float(b2), one_minus_b2=1.0 - b2, eps=float(eps),
                wd=float(weight_decay), c1=1.0 / (1.0 - b1 ** step),
                c2=1.0 / (1.0 - b2 ** step), coupled=bool(coupled),
                mu_bf16=bool(mu_bf16))


def adamw_reference(p, g, m, v, h: dict, norm: Optional[torch.Tensor],
                    max_norm: float) -> None:
    """Plain PyTorch version of the kernel, in place on p, m, v: the same
    operations in the same order, each rounded to fp32; a bf16 m is
    widened first and the fp32 m' both updates p and, rounded to nearest
    even, is stored."""
    if norm is not None:
        g = torch.where(norm < max_norm, g, g / norm * max_norm)
    if h["coupled"]:
        g = g + h["wd"] * p
    m_new = h["b1"] * m.to(torch.float32) + h["one_minus_b1"] * g
    m.copy_(m_new)
    v.copy_(h["b2"] * v + h["one_minus_b2"] * g * g)
    u = (m_new * h["c1"]) / (torch.sqrt(v * h["c2"]) + h["eps"])
    if not h["coupled"]:
        u = u + h["wd"] * p
    p.sub_(h["lr"] * u)


def adamw_update(p, g, m, v, *, lr: float, b1: float, b2: float, eps: float,
                 weight_decay: float, step: int, coupled: bool = False,
                 norm: Optional[torch.Tensor] = None,
                 max_norm: float = 1.0) -> None:
    """One AdamW (coupled=False: decoupled decay) or Adam (coupled=True:
    decay added to the gradient) step on flat fp32 buffers (m fp32 or
    bf16), in place. `step` is this update's 1-based count (bias
    corrections 1/(1-b^step)). With `norm` (the global gradient norm, a
    device scalar) the gradient is clipped as optax's clip_by_global_norm
    clips it."""
    h = update_scalars(lr=lr, b1=b1, b2=b2, eps=eps,
                       weight_decay=weight_decay, step=step, coupled=coupled,
                       mu_bf16=m.dtype == MU_DTYPE)
    if p.device.type == "cpu":
        adamw_reference(p, g, m, v, h, norm, max_norm)
    elif p.device.type == "cuda":
        fused_adamw(p, g, m, v, h, norm, max_norm)
    else:
        raise RuntimeError(f"adamw_update runs on CUDA or CPU, not "
                           f"{p.device}")
