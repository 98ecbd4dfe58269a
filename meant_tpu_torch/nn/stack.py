"""Rematerialised encoder blocks and the scanned parameter layout
(counterpart of meant_tpu/nn/stack.py).

Remat spec, the models' `remat` field:

  False / None    save everything (fastest; most memory)
  True / "full"   save nothing of the block; the backward re-runs its whole
                  forward (`torch.utils.checkpoint`, non-reentrant)
  "dots"          selective checkpointing: the outputs of the matrix
                  products (`aten.mm`, `addmm`, `bmm`) are saved and the
                  rest (norms, GELU, dropout, casts, residual adds) is
                  recomputed, as `jax.checkpoint_policies.dots_saveable`

Under either policy the flash forward (the `meant_tpu_torch::flash_fwd` /
`flash_fwd_lse` ops, R1 + K1 or R1 + K3) re-runs in the backward, as the
Pallas kernel's custom VJP re-runs under JAX's remat: the policy saves no
output of a flash op, and the rotated Qr/Kr that K2 takes come from the
re-run. Dropout draws the same mask again (`preserve_rng_state`). A block
rematerialises only in training mode with gradients on; evaluation and
serving run it plainly.

`scan_layers=True` in JAX rolls a tower into one `lax.scan` over
layer-stacked parameters, which bounds the size of the compiled program.
Eager PyTorch has no program to bound: the port keeps one module per block
and loops over them, which is what the scan computes. It takes JAX's
semantics where they change numbers or memory: a scanned tower
rematerialises with "dots" when the model's `remat` is falsy
(`tower_remat`), and `weights.state_dict_from_jax` reads the JAX
`<tower>_scan/enc/...` layout (`unstack_encoder_params`) into the port's
one layout, `languageEncoders.{i}` / `visionEncoders.{i}`.
"""

from __future__ import annotations

import functools
from typing import Any, Mapping, Optional

import numpy as np
import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

# the matrix products whose outputs "dots" saves
DOT_OPS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
           torch.ops.aten.bmm.default)


def remat_spec(spec: Any) -> Optional[str]:
    """None (no remat), "full" or "dots" for a model's `remat` field."""
    if spec is False or spec is None:
        return None
    if spec is True or spec == "full":
        return "full"
    if spec == "dots":
        return "dots"
    raise ValueError(
        f"unknown remat spec {spec!r}: expected False, True/'full' or 'dots'")


def tower_remat(remat: Any, scan_layers: bool) -> Optional[str]:
    """A tower's policy: `remat`, or "dots" for a scanned tower whose model
    has remat off (meant_tpu/models/meant.py `_lang_tower`)."""
    return remat_spec(remat if remat or not scan_layers else "dots")


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in DOT_OPS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def run_block(block: torch.nn.Module, spec: Optional[str], *args):
    """block(*args), rematerialised per `spec` when the block trains with
    gradients on."""
    if spec is None or not (block.training and torch.is_grad_enabled()):
        return block(*args)
    kw = {}
    if spec == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _dots_policy)
    return checkpoint(block, *args, use_reentrant=False,
                      preserve_rng_state=True, **kw)


def _tree_map(fn, *trees):
    first = trees[0]
    if isinstance(first, Mapping):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in first}
    return fn(*trees)


def stack_encoder_params(params: Mapping, prefix: str, num_layers: int,
                         scan_name: Optional[str] = None) -> dict:
    """Unrolled `{prefix}_{i}` subtrees of a nested dict of numpy arrays
    (JAX's layout) -> the scanned `{scan_name}/enc` layout, every leaf with
    a leading layer axis. The input is not changed."""
    scan_name = scan_name or prefix + "_scan"
    out = dict(params)
    trees = [out.pop(f"{prefix}_{i}") for i in range(num_layers)]
    out[scan_name] = {"enc": _tree_map(lambda *xs: np.stack(xs), *trees)}
    return out


def unstack_encoder_params(params: Mapping, prefix: str,
                           num_layers: Optional[int] = None,
                           scan_name: Optional[str] = None) -> dict:
    """Inverse of `stack_encoder_params`; `num_layers` defaults to the
    leading axis of the stacked leaves."""
    scan_name = scan_name or prefix + "_scan"
    out = dict(params)
    stacked = out.pop(scan_name)["enc"]
    if num_layers is None:
        leaf = stacked
        while isinstance(leaf, Mapping):
            leaf = next(iter(leaf.values()))
        num_layers = np.shape(leaf)[0]
    for i in range(num_layers):
        name = f"{prefix}_{i}"
        if name in out:
            raise KeyError(f"{name} is in both the unrolled and the scanned "
                           f"layout")
        out[name] = _tree_map(lambda x, i=i: np.asarray(x)[i], stacked)
    return out
