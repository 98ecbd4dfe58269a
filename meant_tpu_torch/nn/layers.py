"""Basic layers (counterpart of meant_tpu/nn/layers.py).

Parameters stay fp32. A layer given `dtype` computes in it: like Flax
`Dense(dtype=bf16)`, `Linear` casts its input, weight and bias to `dtype`
for the product. Init styles: 'torch' (kaiming-uniform weight and bias,
U(+-1/sqrt(fan_in))), 'xavier' (xavier-uniform weight, zero bias) and
'lecun' (Flax's default: truncated-normal weight, zero bias). Every layer
draws its init from an explicit `torch.Generator`.

`Dense`, `FlaxLayerNorm` and `Embed` are the counterparts of Flax's own
`nn.Dense`, `nn.LayerNorm` and `nn.Embed`, which the TimeSformer family,
teanet and the LSTM baseline use directly, at Flax's defaults.
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
    """Dense layer y = x W^T (+ b); weight (features, in_features). Inside
    `nn.quant.int8_inference()` a layer of MIN_FEATURES or more features
    computes through `int8_dense`, as JAX's interceptor catches every Flax
    `nn.Dense`; `quantize=False` is for the projections JAX builds from
    other modules (the attention's `DenseGeneral`, the LSTM cell's gates),
    which it leaves in floating point. A layer cut by
    `parallel.sharding_rules.parallelize_model` holds its slice and its
    collectives in `parallel` (a `LinearParallel`); a row-parallel one adds
    its bias after the sum over the model axis."""

    def __init__(self, features: int, in_features: int,
                 init_style: str = "torch",
                 dtype: Optional[torch.dtype] = None, device=None,
                 use_bias: bool = True, quantize: bool = True):
        super().__init__()
        if init_style not in ("torch", "xavier", "lecun"):
            raise ValueError(f"unknown init_style {init_style!r}")
        self.init_style = init_style
        self.dtype, self.quantize = dtype, quantize
        # the whole layer's width, which the int8 rule reads (a
        # column-parallel slice holds features / tp rows)
        self.features = features
        self.parallel = None
        self.weight = nn.Parameter(torch.empty(
            (features, in_features), dtype=torch.float32, device=device))
        self.bias = (nn.Parameter(torch.empty(
            (features,), dtype=torch.float32, device=device))
            if use_bias else None)

    def reset_parameters(self, generator):
        out_f, in_f = self.weight.shape
        if self.init_style == "lecun":
            std = 1.0 / math.sqrt(in_f) / .87962566103423978
            nn.init.trunc_normal_(self.weight, std=std, a=-2 * std,
                                  b=2 * std, generator=generator)
        elif self.init_style == "xavier":
            bound = math.sqrt(6.0 / (in_f + out_f))
            self.weight.uniform_(-bound, bound, generator=generator)
        else:
            bound = 1.0 / math.sqrt(in_f)
            self.weight.uniform_(-bound, bound, generator=generator)
        if self.bias is None:
            return
        if self.init_style == "torch":
            self.bias.uniform_(-bound, bound, generator=generator)
        else:
            self.bias.zero_()

    def forward(self, x):
        dt = self.dtype or torch.promote_types(x.dtype, self.weight.dtype)
        tp = self.parallel
        row = tp is not None and tp.row
        if tp is not None:
            x = tp.enter(x)
        if (self.quantize and int8_active()
                and self.features >= MIN_FEATURES):
            if row:     # int8_dense sums over the group, then the bias
                return int8_dense(x, self.weight, self.bias, out_dtype=dt,
                                  group=tp.group)
            y = int8_dense(x, self.weight, self.bias, out_dtype=dt)
            return y if tp is None else tp.leave(y)
        bias = None if self.bias is None else self.bias.to(dt)
        y = F.linear(x.to(dt), self.weight.to(dt), None if row else bias)
        if tp is None:
            return y
        y = tp.leave(y)
        return y + bias if row and bias is not None else y


def Dense(features: int, in_features: int, **kw) -> Linear:
    """Flax `nn.Dense`: lecun-normal weight, zero bias."""
    return Linear(features, in_features, init_style="lecun", **kw)


class FlaxLayerNorm(SeededInit, nn.Module):
    """Flax `nn.LayerNorm`: eps 1e-6, the variance as E[x^2] - E[x]^2
    (clipped at 0), computed in fp32; the result is fp32 (the promotion of
    x with the fp32 scale and bias), whatever x's dtype."""

    def __init__(self, d: int, eps: float = 1e-6, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(d, device=device))
        self.bias = nn.Parameter(torch.empty(d, device=device))

    def reset_parameters(self, generator):
        self.weight.fill_(1.0)
        self.bias.zero_()

    def forward(self, x):
        xf = x.to(torch.float32)
        mean = xf.mean(dim=-1, keepdim=True)
        var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True) - mean * mean,
                          min=0.0)
        return (xf - mean) * (torch.rsqrt(var + self.eps) * self.weight) \
            + self.bias


class Embed(SeededInit, nn.Module):
    """Flax `nn.Embed`: a (num_embeddings, features) table, rows drawn
    N(0, std^2) (Flax's default std is 1)."""

    def __init__(self, num_embeddings: int, features: int,
                 std: float = 1.0, device=None):
        super().__init__()
        self.std = std
        self.weight = nn.Parameter(torch.empty((num_embeddings, features),
                                               device=device))

    def reset_parameters(self, generator):
        self.weight.normal_(0.0, self.std, generator=generator)

    def forward(self, ids):
        return F.embedding(ids.to(torch.int64), self.weight)


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
