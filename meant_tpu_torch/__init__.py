"""PyTorch / CUDA port of meant_tpu for NVIDIA Hopper (H100).

The JAX package `meant_tpu` is the reference; this package mirrors its
layout (`ops/`, `ops/flash/`, `nn/`, `models/`, `serve.py`, `cli/`) so each
module has an obvious counterpart, and imports nothing from it. Plain tensor
code is PyTorch; every Pallas kernel on a ported path is a hand-written
CUDA kernel under `csrc/`, built with nvcc at first use.

Entry points (`serve.Predictor`, `cli.serve`, `cli.common.build_model`, the
model constructors) run on the card by default and raise when there is none,
unless the caller asks for `device="cpu"` (the CPU tests do).
"""

from meant_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
