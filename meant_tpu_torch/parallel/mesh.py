"""Process group, device mesh and batch placement (counterpart of
meant_tpu/parallel/mesh.py).

JAX lays a mesh over the devices of one process and annotates global
arrays; XLA inserts the collectives. Here there is one process per card,
each rank holds local tensors and every collective is written out. What
JAX's annotations mean on a rank:

    batch_sharding (P("data"))  this rank's rows of the global batch
    replicated (P())            the same tensor on every rank, broadcast
                                from rank 0 once (`replicate_tree`)
    a sharded leaf              this rank's slice (parallel/fsdp.py,
                                parallel/sharding_rules.py)

The sharding functions return DTensor placements (`Shard(d)` /
`Replicate()`, one per mesh axis) where JAX returns NamedShardings.

The process group comes from torchrun's environment (RANK, WORLD_SIZE,
LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR, MASTER_PORT); without it the
world is this one process, as JAX's `make_mesh` over one device. NCCL
serves the card and gloo the CPU, which a caller names with
`device="cpu"` (the CPU tests do). If a card is present and NCCL fails to
start, the call raises: nothing carries on over gloo.
"""

from __future__ import annotations

import math
import os
import socket
from datetime import timedelta
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import Replicate, Shard

from meant_tpu_torch.device import resolve_device

DEFAULT_TIMEOUT = timedelta(seconds=600)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def init_distributed(device=None,
                     timeout: timedelta = DEFAULT_TIMEOUT) -> torch.device:
    """Start the default process group once, from torchrun's environment
    (a world of one process on a free localhost port without it): NCCL
    for the card, gloo for `device="cpu"`. Returns this rank's device
    (cuda:LOCAL_RANK on the card). A group already started must be of
    the device's backend."""
    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise RuntimeError(
                f"the process group runs {dist.get_backend()}, but "
                f"{dev.type} tensors take {backend}")
        return dev
    if "WORLD_SIZE" in os.environ:
        init, rank = "env://", int(os.environ["RANK"])
        world = int(os.environ["WORLD_SIZE"])
    else:
        init, rank, world = f"tcp://localhost:{_free_port()}", 0, 1
    kw = dict(device_id=dev) if dev.type == "cuda" else {}
    dist.init_process_group(backend, init_method=init, rank=rank,
                            world_size=world, timeout=timeout, **kw)
    return dev


def make_mesh(axes: Sequence[str] = ("data",),
              shape: Optional[Sequence[int]] = None, device=None,
              timeout: timedelta = DEFAULT_TIMEOUT) -> DeviceMesh:
    """Mesh over every rank of the process group (started here if need
    be). Default: 1-D data-parallel mesh of the world's size."""
    dev = init_distributed(device, timeout)
    world = dist.get_world_size()
    if shape is None:
        shape = [world] + [1] * (len(axes) - 1)
    if math.prod(shape) != world or len(shape) != len(axes):
        raise ValueError(f"mesh {tuple(axes)} of shape {tuple(shape)} does "
                         f"not lay out {world} ranks")
    return init_device_mesh(dev.type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_hybrid_mesh(ici_axes: Sequence[str] = ("model",),
                     ici_shape: Optional[Sequence[int]] = None,
                     dcn_axis: str = "dcn",
                     num_slices: Optional[int] = None, device=None,
                     timeout: timedelta = DEFAULT_TIMEOUT) -> DeviceMesh:
    """Multi-node mesh: the leading `dcn_axis` spans the nodes (traffic
    between hosts) and the trailing `ici_axes` stay inside a node (NVLink),
    as JAX's spans slices and keeps its ici axes on the torus. torchrun
    numbers ranks node by node, LOCAL_WORLD_SIZE to a node, so each row of
    the mesh is one node, as `mesh_utils.create_hybrid_device_mesh`
    groups slices. Put the per-step gradient reduce on `dcn_axis` and the
    per-layer collectives on the ici axes."""
    dev = init_distributed(device, timeout)
    world = dist.get_world_size()
    if num_slices is None:
        per_node = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        num_slices = max(world // per_node, 1)
    per_slice = world // num_slices
    shape = [num_slices] + list(ici_shape or
                                [per_slice] + [1] * (len(ici_axes) - 1))
    if math.prod(shape) != world:
        raise ValueError(f"hybrid mesh {shape} does not lay out {world} "
                         f"ranks")
    return init_device_mesh(dev.type, tuple(shape),
                            mesh_dim_names=(dcn_axis, *ici_axes))


def axis_size(mesh: Optional[DeviceMesh], axis: str) -> int:
    """Ranks along `axis` (1 without a mesh or without that axis)."""
    if mesh is None or axis not in (mesh.mesh_dim_names or ()):
        return 1
    return mesh[axis].size()


def axis_rank(mesh: Optional[DeviceMesh], axis: str) -> int:
    """This rank's index along `axis` (0 without a mesh or that axis)."""
    if mesh is None or axis not in (mesh.mesh_dim_names or ()):
        return 0
    return mesh.get_local_rank(axis)


def _placements(mesh: DeviceMesh, axis: Optional[str], placement) -> tuple:
    return tuple(placement if name == axis else Replicate()
                 for name in mesh.mesh_dim_names)


def batch_sharding(mesh: DeviceMesh, batch_axis: Optional[str] = None
                   ) -> tuple:
    """Placements sharding the leading (batch) dim over `batch_axis`,
    default the mesh's LEADING axis ('data' on the standard mesh, 'dcn' on
    a hybrid one)."""
    return _placements(mesh, batch_axis or mesh.mesh_dim_names[0], Shard(0))


def replicated(mesh: DeviceMesh) -> tuple:
    return _placements(mesh, None, None)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def shard_batch(batch, mesh: DeviceMesh, batch_axis: Optional[str] = None):
    """This rank's rows of every array (numpy or tensor) in the (nested)
    batch: JAX's single-process semantics, in which every rank's loader
    yields the same global batch from the same seed. A leading dim that
    does not divide by the axis raises, as JAX's device_put does."""
    axis = batch_axis or mesh.mesh_dim_names[0]
    n, r = axis_size(mesh, axis), axis_rank(mesh, axis)

    def rows(x):
        if not isinstance(x, (np.ndarray, torch.Tensor)) or x.ndim == 0:
            return x
        if x.shape[0] % n:
            raise ValueError(f"a batch of {x.shape[0]} rows does not divide "
                             f"over {n} ranks of mesh axis {axis!r}")
        k = x.shape[0] // n
        return x[r * k:(r + 1) * k]
    return _map(rows, batch)


def replicate_tree(tree, mesh: DeviceMesh):
    """Every tensor of the (nested) tree made rank 0's, in place, over
    the mesh's ranks (every mesh spans the world, so the source is global
    rank 0); returns the tree."""

    def bcast(x):
        if isinstance(x, torch.Tensor):
            with torch.no_grad():
                dist.broadcast(x, src=0)
        return x
    return _map(bcast, tree)


def rank_zero() -> bool:
    """Whether this process prints and saves: rank 0, or no process
    group."""
    return not dist.is_initialized() or dist.get_rank() == 0
