"""A trainer's view of a mesh (counterpart of what the JAX trainers do with
their `mesh` and `fsdp` keys: meant_tpu/train/classify.py:135-180,
:223-243, and the same keys in the other trainers).

JAX shards the global batch over the mesh's leading axis, replicates the
train state (or FSDP-shards it) and lets XLA reduce. Here each rank takes
its rows of every global batch (`rows`), the optimizer averages the flat
gradient over the data axis (FlatAdam's `group`, and `shard` for FSDP),
and what a step reports (losses, confusion matrices, eval outputs) is
reduced to the global batch's values. Without a mesh (and without fsdp)
every method is the identity and no process group is needed.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from meant_tpu_torch.parallel.mesh import axis_size, make_mesh, shard_batch


class _Rows:
    """The loader, each global batch cut to this rank's rows on the host."""

    def __init__(self, loader, mesh):
        self.loader, self.mesh = loader, mesh

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        for batch in self.loader:
            yield shard_batch(batch, self.mesh)


class DataLayout:
    """mesh: a DeviceMesh whose LEADING axis is the data axis, or None;
    fsdp=True shards the optimizer state and the parameters at rest over
    that axis (a world-sized mesh is made when none is given, as JAX's
    trainer defaults to `make_mesh()`)."""

    def __init__(self, mesh, fsdp: bool, device):
        if fsdp and mesh is None:
            mesh = make_mesh(device=device)
        self.mesh, self.fsdp = mesh, bool(fsdp)
        axis = mesh.mesh_dim_names[0] if mesh is not None else None
        self.group = mesh.get_group(axis) if mesh is not None else None
        self.size = axis_size(mesh, axis)

    def optimizer_kwargs(self) -> dict:
        return dict(group=self.group, shard=self.fsdp)

    def rows(self, loader):
        """The loader yielding this rank's rows of each global batch."""
        return loader if self.mesh is None else _Rows(loader, self.mesh)

    def mean(self, t: torch.Tensor) -> torch.Tensor:
        """The mean of `t` over the data axis (of equal-sized shards'
        means: the global batch's)."""
        if self.group is None:
            return t
        t = t.clone()
        dist.all_reduce(t, group=self.group)
        return t / self.size

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        if self.group is None:
            return t
        t = t.clone()
        dist.all_reduce(t, group=self.group)
        return t

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """The rows of every rank of the data axis, rank by rank."""
        if self.group is None:
            return t
        out = t.new_empty((self.size * t.shape[0], *t.shape[1:]))
        dist.all_gather_into_tensor(out, t.contiguous(), group=self.group)
        return out


def global_ratio(num: torch.Tensor, den: torch.Tensor,
                 layout: Optional[DataLayout]) -> torch.Tensor:
    """This rank's share of num / max(den, 1) over the global batch:
    num * n / max(sum of den over the data axis, 1), whose mean over the
    axis (`DataLayout.mean`, and the optimizer's average of gradients) is
    the global ratio and its gradient. Without a data axis, num / max(den,
    1)."""
    if layout is None or layout.group is None:
        return num / torch.clamp(den, min=1)
    return num * layout.size / torch.clamp(layout.sum(den.detach()), min=1)


def weighted_mean(values: torch.Tensor, weight: torch.Tensor,
                  layout: Optional[DataLayout]) -> torch.Tensor:
    """sum(values * weight) / max(sum(weight), 1) over the global batch."""
    total = torch.stack([(values * weight).sum(), weight.sum()])
    if layout is not None:
        total = layout.sum(total)
    return total[0] / torch.clamp(total[1], min=1.0)
