"""Basic layers (counterpart of meant_tpu/nn/layers.py).

Parameters stay fp32. A layer given `dtype` computes in it: like Flax
`Dense(dtype=bf16)`, `Linear` casts its input, weight and bias to `dtype`
for the product. Init styles: 'torch' (kaiming-uniform weight and bias,
U(+-1/sqrt(fan_in))) and 'xavier' (xavier-uniform weight, zero bias).
Every layer draws its init from an explicit `torch.Generator`.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from meant_tpu_torch.nn.quant import MIN_FEATURES, int8_active, int8_dense
from meant_tpu_torch.ops.norms import layer_norm, rms_norm


class SeededInit:
    """Mixin of the port's modules that initialise their own parameters
    with `reset_parameters(generator)`; see `init_weights`."""

    def reset_parameters(self, generator: torch.Generator) -> None:
        raise NotImplementedError


def init_weights(root: nn.Module, generator: torch.Generator) -> None:
    """Initialise every SeededInit module under `root` from `generator`,
    in module order, so one seed gives one set of weights."""
    with torch.no_grad():
        for m in root.modules():
            if isinstance(m, SeededInit):
                m.reset_parameters(generator)


class Linear(SeededInit, nn.Module):
    """Dense layer y = x W^T + b; weight (features, in_features). Inside
    `nn.quant.int8_inference()` a layer of MIN_FEATURES or more features
    computes through `int8_dense`."""

    def __init__(self, features: int, in_features: int,
                 init_style: str = "torch",
                 dtype: Optional[torch.dtype] = None, device=None):
        super().__init__()
        if init_style not in ("torch", "xavier"):
            raise ValueError(f"unknown init_style {init_style!r}")
        self.init_style = init_style
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(
            (features, in_features), dtype=torch.float32, device=device))
        self.bias = nn.Parameter(torch.empty(
            (features,), dtype=torch.float32, device=device))

    def reset_parameters(self, generator):
        out_f, in_f = self.weight.shape
        if self.init_style == "xavier":
            bound = math.sqrt(6.0 / (in_f + out_f))
            self.weight.uniform_(-bound, bound, generator=generator)
            self.bias.zero_()
        else:
            bound = 1.0 / math.sqrt(in_f)
            self.weight.uniform_(-bound, bound, generator=generator)
            self.bias.uniform_(-bound, bound, generator=generator)

    def forward(self, x):
        dt = self.dtype or torch.promote_types(x.dtype, self.weight.dtype)
        if int8_active() and self.weight.shape[0] >= MIN_FEATURES:
            return int8_dense(x, self.weight, self.bias, out_dtype=dt)
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class RMSNorm(SeededInit, nn.Module):
    """Zhang & Sennrich RMSNorm, eps added to the RMS (default 1e-8)."""

    def __init__(self, d: int, eps: float = 1e-8, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(d, device=device))

    def reset_parameters(self, generator):
        self.weight.fill_(1.0)

    def forward(self, x):
        return rms_norm(x, self.weight, eps=self.eps)


class LayerNorm(SeededInit, nn.Module):
    """torch.nn.LayerNorm semantics, computed in fp32 (eps 1e-5)."""

    def __init__(self, d: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(d, device=device))
        self.bias = nn.Parameter(torch.empty(d, device=device))

    def reset_parameters(self, generator):
        self.weight.fill_(1.0)
        self.bias.zero_()

    def forward(self, x):
        return layer_norm(x, self.weight, self.bias, eps=self.eps)


def make_norm(kind: str, d: int, device=None) -> nn.Module:
    if kind == "rms":
        return RMSNorm(d, device=device)
    if kind == "layer":
        return LayerNorm(d, device=device)
    raise ValueError(f"unknown norm kind {kind}")


def gelu(x):
    """Exact-erf GELU (not the tanh approximation)."""
    return F.gelu(x, approximate="none")
