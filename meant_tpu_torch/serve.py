"""Batch inference and the exported forward (counterpart of
meant_tpu/serve.py).

`Predictor` runs the model at a fixed batch size: a partial last batch is
padded by repeating its first row and the padded rows are dropped from the
result. `checkpoint_path` restores the params of a checkpoint the port's
trainer wrote (`train/checkpoint.py`). `quantize="int8"` runs every wide
Linear through the int8 product (`nn/quant.py`).

With a `mesh` (parallel/mesh.py) the params are rank 0's on every rank
(broadcast once), or with `tensor_parallel=True` cut by the megatron rules
over the mesh's 'model' axis (parallel/sharding_rules.py: the attention
runs on each rank's heads, the flash kernels on plain local tensors). A
request's rows split over the mesh's leading axis where the batch size
divides by it, and are otherwise computed whole on every rank (JAX's
rule); the probabilities come back whole on every rank.

`export_forward` writes the fixed-shape forward, fp32/bf16 or int8, as a
`torch.export` program whose inputs are the params (a state_dict of the
port) and the batch; the flash forwards stay in it as the custom ops
`meant_tpu_torch::flash_fwd` / `flash_fwd_lse`, so the served program
launches the hand-written kernels. `load_exported(path)` returns
`fn(params, batch) -> probs` and needs none of the model code: it imports
`meant_tpu_torch.ops.flash`, which registers the ops, and nothing of
`meant_tpu_torch.models`. A program exported on the card serves on the
card, as the JAX artifact records its lowering platform.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed
from torch import nn
from torch.distributed.device_mesh import DeviceMesh

from meant_tpu_torch.data.loader import host_tensor
from meant_tpu_torch.device import resolve_device
from meant_tpu_torch.nn.quant import int8_inference
from meant_tpu_torch.parallel.mesh import (axis_size, make_mesh,
                                           replicate_tree, shard_batch)
from meant_tpu_torch.parallel.sharding_rules import parallelize_model
from meant_tpu_torch.train import checkpoint as ckpt
from meant_tpu_torch.train.classify import model_inputs

def _check_quantize(quantize: Optional[str]) -> None:
    if quantize not in (None, "int8"):
        raise ValueError(f"unsupported quantize mode {quantize!r}")


def _quant_context(quantize: Optional[str], batch_group=None):
    return (int8_inference(batch_group) if quantize == "int8"
            else contextlib.nullcontext())


class Predictor:
    """predictor = Predictor(model, model_name, batch_size=32)
    probs = predictor(batch_dict)  # numpy arrays with leading dim N

    The model serves the weights it holds (JAX weights can be loaded into
    it with `weights.load_jax_params`), or those of `checkpoint_path`, a
    checkpoint of the port's trainer for the same architecture. It is moved
    to `device` (the card unless named) and put in eval mode. `mesh` and
    `tensor_parallel` as the module's notes say (a world-sized data mesh
    is made for tensor_parallel=True without one, as JAX defaults to
    `make_mesh()`); tensor-parallel serving cuts the model's parameters in
    place, and composes with int8 (a row-parallel layer's amaxes are
    maxima over the model axis, nn/quant.py)."""

    def __init__(self, model: nn.Module, model_name: str,
                 checkpoint_path: Optional[str] = None, batch_size: int = 32,
                 device=None, mesh=None, tensor_parallel: bool = False,
                 quantize: Optional[str] = None):
        _check_quantize(quantize)
        if mesh is not None and not isinstance(mesh, DeviceMesh):
            raise TypeError(f"mesh must be a DeviceMesh "
                            f"(parallel.make_mesh), got {type(mesh)}")
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        if checkpoint_path is not None:
            self.model.load_state_dict(
                ckpt.restore(checkpoint_path, self.device)["params"])
        if tensor_parallel and mesh is None:
            mesh = make_mesh(device=self.device)
        self.mesh = mesh
        if mesh is not None:
            replicate_tree(self.model.state_dict(), mesh)
            if tensor_parallel:
                parallelize_model(self.model, mesh)
        self.model_name = model_name
        self.batch_size = batch_size
        self.quantize = quantize
        # rows split over the leading axis where the batch divides
        self.data = mesh.mesh_dim_names[0] if mesh is not None else None
        self.split = (mesh is not None
                      and batch_size % axis_size(mesh, self.data) == 0)

    def _device_batch(self, batch: Dict[str, np.ndarray]):
        return {k: host_tensor(v).to(self.device, non_blocking=True)
                for k, v in batch.items()}

    @torch.inference_mode()
    def forward(self, batch: Dict[str, np.ndarray]) -> torch.Tensor:
        """One fixed-size batch through the model; returns the device
        tensor of probabilities (whole on every rank under a mesh)."""
        if self.split:
            batch = shard_batch(batch, self.mesh)
        args, kwargs = model_inputs(self.model_name,
                                    self._device_batch(batch))
        with _quant_context(self.quantize, self.mesh.get_group(self.data)
                            if self.split else None):
            out = self.model(*args, **kwargs)
        if not self.split:
            return out
        whole = out.new_empty((axis_size(self.mesh, self.data)
                               * out.shape[0], *out.shape[1:]))
        torch.distributed.all_gather_into_tensor(
            whole, out.contiguous(), group=self.mesh.get_group(self.data))
        return whole

    def __call__(self, batch: Dict[str, np.ndarray]) -> np.ndarray:
        n = len(next(iter(batch.values())))
        bs = self.batch_size
        outs = []
        for start in range(0, n, bs):
            chunk = pad_chunk({k: v[start:start + bs]
                               for k, v in batch.items()}, bs)
            out = self.forward(chunk).float().cpu().numpy()
            rows = min(bs, n - start)
            outs.append(out[:rows])
        return np.concatenate(outs, axis=0)


def pad_chunk(chunk: Dict[str, np.ndarray], size: int) -> dict:
    """`chunk` padded to `size` rows by repeating its first row."""
    pad = size - len(next(iter(chunk.values())))
    if pad <= 0:
        return chunk
    return {k: np.concatenate([v, np.repeat(v[:1], pad, axis=0)], axis=0)
            for k, v in chunk.items()}


class _Forward(nn.Module):
    """forward(params, batch) = the model's forward with `params` in place
    of its own: the module holds the model outside its registry, so the
    exported program takes the params as inputs and stores none."""

    def __init__(self, model: nn.Module, model_name: str,
                 quantize: Optional[str]):
        super().__init__()
        self.__dict__["model"] = model
        self.model_name, self.quantize = model_name, quantize

    def forward(self, params, batch):
        args, kwargs = model_inputs(self.model_name, batch)
        with _quant_context(self.quantize):
            return torch.func.functional_call(self.model, params, args,
                                              kwargs)


def _batch_tensors(batch, device) -> dict:
    return {k: (v if isinstance(v, torch.Tensor) else host_tensor(v)).to(
        device) for k, v in sorted(batch.items())}


def export_forward(model: nn.Module, model_name: str, sample_batch,
                   path: Optional[str] = None,
                   quantize: Optional[str] = None):
    """Export the model's eval forward (int8 with quantize="int8") at the
    shapes of `sample_batch` with `torch.export`, gradients off; the params
    (the model's state_dict) and the batch are the program's inputs.
    Returns the ExportedProgram and writes it to `path` if given; serve it
    as `load_exported(path)(params, batch)`."""
    _check_quantize(quantize)
    model.eval()
    device = next(model.parameters()).device
    params = dict(sorted(model.state_dict().items()))
    batch = _batch_tensors(sample_batch, device)
    fwd = _Forward(model, model_name, quantize)
    with torch.no_grad():
        fwd(params, batch)      # fills the modules' rotation-table caches
        program = torch.export.export(fwd, (params, batch))
    program.example_inputs = None   # the params are the caller's to give
    if path:
        torch.export.save(program, path)
    return program


def load_exported(path: str):
    """Load a program written by `export_forward`; returns fn(params,
    batch) -> probs (a tensor on the params' device). `params` is a
    state_dict of the port's model, `batch` numpy arrays or tensors at the
    exported shapes. No model code is imported."""
    import meant_tpu_torch.ops.flash  # noqa: F401  (registers the ops)

    module = torch.export.load(path).module()

    def fn(params, batch):
        params = dict(sorted(params.items()))
        device = next(iter(params.values())).device
        with torch.no_grad():
            return module(params, _batch_tensors(batch, device))
    return fn
