"""int8 inference: dynamic per-tensor activation scale, per-output-channel
weight scale (counterpart of meant_tpu/nn/quant.py).

Inside `int8_inference()` every `nn.layers.Linear` of `MIN_FEATURES` or
more output features computes

    y = (q_int8(x) @ q_int8(W)^T) * (s_x * s_W) + b

with symmetric 127-level scales: s_x = amax(|x|) / 127 + 1e-12 over the
whole tensor (padded batch rows included, and the rows of the other ranks
where a Predictor splits the batch over a mesh; the feature slices of the
other ranks in a row-parallel layer), s_W the same per output channel
(the amax over dim 1 of the (out, in) weight), q(t) = clip(round(t / s),
-127, 127) with round half to even, all in fp32, the result cast to the
layer's compute dtype. The JAX package intercepts exactly the Flax `Dense`
modules, and each of its `Linear`s wraps one; the port's `Linear` reads the
switch this context sets, so the same layers quantize and no module is
rewritten. Narrow heads (2 features), the sequence projections (1), the
embeddings and the tied MLM decoder's contraction with the word table stay
exact. The parameters stay fp32: each call quantizes the weight again, as
the JAX forward does.

The int8 x int8 -> int32 product is `int8_matmul`: on CUDA tensors
cuBLASLt's int8 GEMM (`torch._int_mm`, as JAX leaves its `dot_general` to
XLA outside any Pallas kernel), zero-padded to the shapes it takes (more
than 16 rows, inner and outer sizes multiples of 8; zeros add nothing to
an int32 sum) and sliced back; on CPU tensors the plain int32 product,
exact like JAX's int32 accumulator. The quantize passes are plain PyTorch,
as JAX leaves them to XLA. `products` counts the int8 products.
"""

from __future__ import annotations

import contextlib

import torch
import torch.distributed
import torch.nn.functional as F

# Dense layers narrower than this stay in floating point: the classifier
# heads (2 features) gain nothing and their logits set the output numerics.
MIN_FEATURES = 32
# torch._int_mm on CUDA: more than 16 rows, both sizes multiples of 8.
_MIN_ROWS, _MULTIPLE = 17, 8

_active = False
# the process group a served batch's rows are split over, or None
_batch_group = None
# int8 products launched (`int8_matmul`), by (rows, k, n) before padding
products: dict = {}


def int8_active() -> bool:
    """Whether `int8_inference()` is on (read by `Linear.forward`)."""
    return _active


@contextlib.contextmanager
def int8_inference(batch_group=None):
    """Context: every Linear of MIN_FEATURES or more features runs int8.
    `batch_group`: the ranks the batch's rows are split over (the
    Predictor's data axis), over which the per-tensor activation amax is
    taken, so that each rank quantizes with the whole batch's scale as
    JAX's amax over a sharded batch does."""
    global _active, _batch_group
    before = _active, _batch_group
    _active, _batch_group = True, batch_group
    try:
        yield
    finally:
        _active, _batch_group = before


def quantized_apply(model, *args, **kwargs):
    """model(*args, **kwargs) with every wide Linear in int8."""
    with int8_inference():
        return model(*args, **kwargs)


def _amax_scale(x: torch.Tensor, dim=None, groups=()) -> torch.Tensor:
    a = x.to(torch.float32).abs()
    s = a.amax() if dim is None else a.amax(dim=dim, keepdim=True)
    for group in groups:        # the whole tensor's amax: the ranks' max
        if group is not None:
            torch.distributed.all_reduce(
                s, op=torch.distributed.ReduceOp.MAX, group=group)
    return s / 127.0 + 1e-12


def _to_int8(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x.to(torch.float32) / scale), -127,
                       127).to(torch.int8)


def _round_up(n: int, multiple: int) -> int:
    return -(-n // multiple) * multiple


def int8_matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a (m, k) int8 times w (n, k) int8 transposed -> (m, n) int32."""
    m, k = a.shape
    n = w.shape[0]
    key = (m, k, n)
    products[key] = products.get(key, 0) + 1
    if a.device.type == "cpu":
        return torch.matmul(a.to(torch.int32), w.to(torch.int32).t())
    if a.device.type != "cuda":
        raise RuntimeError(f"int8_matmul runs on CUDA or CPU, not "
                           f"{a.device}")
    mp = max(m, _MIN_ROWS)
    kp, np_ = _round_up(k, _MULTIPLE), _round_up(n, _MULTIPLE)
    if (mp, kp) != (m, k):
        a = F.pad(a, (0, kp - k, 0, mp - m))
    if (np_, kp) != (n, k):
        w = F.pad(w, (0, kp - k, 0, np_ - n))
    # (n, k) row-major read as (k, n) column-major: cuBLASLt's int8 layout
    out = torch._int_mm(a.contiguous(), w.contiguous().t())
    return out[:m, :n] if (mp, np_) != (m, n) else out


def int8_matmul_reference(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version of `int8_matmul` on any device: the product in fp64,
    exact for int8 operands while k * 127^2 < 2^53."""
    return torch.matmul(a.to(torch.float64),
                        w.to(torch.float64).t()).to(torch.int32)


def int8_dense(x: torch.Tensor, weight: torch.Tensor, bias=None,
               out_dtype=None, group=None) -> torch.Tensor:
    """x (..., k), weight (n, k) as the port's Linear holds it -> (..., n)
    through the int8 product, the scales and bias applied in fp32. With
    `group` the layer is row-parallel over it: x and the weight hold this
    rank's slice of the k features, so the activation amax and the
    per-channel weight amax are maxima over the group before quantizing,
    and the dequantized partial products are summed over it (reduce_out)
    before the bias. The activation amax is also the maximum over the
    context's batch group (`int8_inference`)."""
    sx = _amax_scale(x, groups=(_batch_group, group))  # per tensor
    sw = _amax_scale(weight, dim=1, groups=(group,))   # per channel (n, 1)
    lead = x.shape[:-1]
    acc = int8_matmul(_to_int8(x, sx).reshape(-1, x.shape[-1]),
                      _to_int8(weight, sw))
    y = acc.to(torch.float32) * (sx * sw.reshape(1, -1))
    if group is not None:
        from meant_tpu_torch.parallel.sharding_rules import reduce_out
        y = reduce_out(y, group)
    if bias is not None:
        y = y + bias.to(torch.float32)
    return y.reshape(*lead, weight.shape[0]).to(out_dtype or x.dtype)
