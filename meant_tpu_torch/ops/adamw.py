"""Fused AdamW / Adam update (counterpart of the Pallas kernel A1,
scripts/probe_fused_adamw.py `_kernel` / `pallas_adamw`, extended to the
whole update of the trainer's optax chain, meant_tpu/train/optim.py).

`adamw_update` updates flat fp32 buffers p, m, v in place from the gradient
buffer g. On CUDA tensors it launches the hand-written kernel in
`csrc/adamw.cu` (one launch over every trainable parameter) or raises; on
CPU tensors it runs the plain version `adamw_reference`, which repeats the
kernel operation for operation.
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
                   ctypes.c_int, ctypes.c_void_p])

    def __call__(self, p, g, m, v, h: dict, norm: Optional[torch.Tensor],
                 max_norm: float) -> None:
        """p, g, m, v: 1-D contiguous fp32 CUDA tensors of one length; h:
        the scalars of `update_scalars`; norm: the fp32 device scalar |g|
        or None (no clipping)."""
        for name, t in (("g", g), ("m", m), ("v", v)):
            if t.shape != p.shape or t.device != p.device:
                raise ValueError(f"{name} {tuple(t.shape)} on {t.device} "
                                 f"must match p")
        for t in (p, g, m, v):
            if (t.dtype != torch.float32 or t.dim() != 1
                    or not t.is_contiguous()):
                raise ValueError("adamw kernel takes 1-D contiguous fp32 "
                                 "buffers")
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
            int(h["coupled"]), num_sms, shape=p.numel())


fused_adamw = AdamWKernel()


def update_scalars(*, lr, b1, b2, eps, weight_decay, step, coupled) -> dict:
    """Every scalar of one update as a Python float, computed in float64
    as the plain version's Python arithmetic computes it (1 - b1 included)
    and rounded to fp32 once, when passed on. step counts from 1."""
    return dict(lr=float(lr), b1=float(b1), one_minus_b1=1.0 - b1,
                b2=float(b2), one_minus_b2=1.0 - b2, eps=float(eps),
                wd=float(weight_decay), c1=1.0 / (1.0 - b1 ** step),
                c2=1.0 / (1.0 - b2 ** step), coupled=bool(coupled))


def adamw_reference(p, g, m, v, h: dict, norm: Optional[torch.Tensor],
                    max_norm: float) -> None:
    """Plain PyTorch version of the kernel, in place on p, m, v: the same
    operations in the same order, each rounded to fp32."""
    if norm is not None:
        g = torch.where(norm < max_norm, g, g / norm * max_norm)
    if h["coupled"]:
        g = g + h["wd"] * p
    m.copy_(h["b1"] * m + h["one_minus_b1"] * g)
    v.copy_(h["b2"] * v + h["one_minus_b2"] * g * g)
    u = (m * h["c1"]) / (torch.sqrt(v * h["c2"]) + h["eps"])
    if not h["coupled"]:
        u = u + h["wd"] * p
    p.sub_(h["lr"] * u)


def adamw_update(p, g, m, v, *, lr: float, b1: float, b2: float, eps: float,
                 weight_decay: float, step: int, coupled: bool = False,
                 norm: Optional[torch.Tensor] = None,
                 max_norm: float = 1.0) -> None:
    """One AdamW (coupled=False: decoupled decay) or Adam (coupled=True:
    decay added to the gradient) step on flat fp32 buffers, in place.
    `step` is this update's 1-based count (bias corrections 1/(1-b^step)).
    With `norm` (the global gradient norm, a device scalar) the gradient is
    clipped as optax's clip_by_global_norm clips it."""
    h = update_scalars(lr=lr, b1=b1, b2=b2, eps=eps,
                       weight_decay=weight_decay, step=step, coupled=coupled)
    if p.device.type == "cpu":
        adamw_reference(p, g, m, v, h, norm, max_norm)
    elif p.device.type == "cuda":
        fused_adamw(p, g, m, v, h, norm, max_norm)
    else:
        raise RuntimeError(f"adamw_update runs on CUDA or CPU, not "
                           f"{p.device}")
