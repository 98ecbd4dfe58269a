"""FSDP / ZeRO-3-style sharding of any tree of tensors over a mesh axis
(counterpart of meant_tpu/parallel/fsdp.py).

JAX places every leaf with one dimension sharded over the `data` axis and
lets XLA all-gather at use and reduce-scatter gradients. The port's
trainers do not shard per leaf: FlatAdam keeps parameters, gradients and
moments in flat buffers (one A1 launch a step), so `fsdp=True` shards
those buffers (ZeRO over the flat buffers, train/optim.py), which is
the same memory account: (P + 2P)/n at rest plus the transient gather.
These functions keep JAX's per-leaf semantics for any tree of tensors:
the largest evenly divisible dim, `min_size`, and a tensor-parallel
placement left as it is; `fsdp_shard` returns DTensors whose local parts
are this rank's slices.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard, \
    distribute_tensor

from meant_tpu_torch.parallel.mesh import _map, axis_size

# Leaves smaller than this stay replicated: sharding a 768-float bias saves
# ~3 KB but costs a gather; the win is the big 2-D weights.
DEFAULT_MIN_SIZE = 2 ** 15


def fsdp_spec(shape, axis_size: int, min_size: int = DEFAULT_MIN_SIZE):
    """The placement on the FSDP axis: Shard of the LARGEST evenly
    divisible dim, or Replicate() for a leaf with none, one too small to
    matter, or an axis of one rank."""
    if axis_size <= 1 or not shape:
        return Replicate()
    size = 1
    for s in shape:
        size *= s
    if size < min_size:
        return Replicate()
    for d in sorted(range(len(shape)), key=lambda d: shape[d], reverse=True):
        if shape[d] % axis_size == 0:
            return Shard(d)
    return Replicate()


def fsdp_shardings(tree, mesh, axis: Optional[str] = None,
                   min_size: int = DEFAULT_MIN_SIZE):
    """Per-leaf placements (one per mesh axis) for a tree of tensors (dicts,
    lists, tuples): `fsdp_spec` on `axis` (default the mesh's leading one).
    A DTensor leaf that already carries a non-replicated placement (a
    tensor-parallel weight) keeps it."""
    axis = axis or mesh.mesh_dim_names[0]
    n = axis_size(mesh, axis)

    def spec_for(leaf):
        if isinstance(leaf, DTensor) and any(
                not isinstance(p, Replicate) for p in leaf.placements):
            return tuple(leaf.placements)
        shape = tuple(getattr(leaf, "shape", ()))
        return tuple(fsdp_spec(shape, n, min_size) if a == axis
                     else Replicate() for a in mesh.mesh_dim_names)
    return _map(spec_for, tree)


def fsdp_shard(tree, mesh, axis: Optional[str] = None,
               min_size: int = DEFAULT_MIN_SIZE):
    """Place `tree` with FSDP shardings: (tree of DTensors, shardings).
    Every rank passes the same tree (rank 0's values are kept)."""
    shardings = fsdp_shardings(tree, mesh, axis, min_size)

    def place(leaf, placements):
        if isinstance(leaf, DTensor):
            return leaf
        return distribute_tensor(leaf, mesh, placements)

    def walk(t, s):
        if isinstance(t, dict):
            return {k: walk(v, s[k]) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v, p) for v, p in zip(t, s))
        return place(t, s) if isinstance(t, torch.Tensor) else t
    return walk(tree, shardings), shardings
