"""Optimizers and learning-rate schedules (counterpart of
meant_tpu/train/optim.py), on the fused update kernel A1
(`ops/adamw.py`).

Reference wiring kept from the JAX package:
  * AdamW(lr, weight_decay, betas): decoupled decay;
  * Adam(lr, weight_decay, betas): decay coupled into the gradient before
    the moment updates (torch semantics);
  * schedules step once per EPOCH (cosine_warm, cosine, linear, constant)
    or per step (linear_warmup), as `epoch_schedule` there;
  * gradient clipping to global norm 1.0 every step, as optax's
    clip_by_global_norm: g * max_norm / |g| when |g| >= max_norm. (Not
    torch.nn.utils.clip_grad_norm_, which adds 1e-6 to the norm.)

The JAX package stores the rotary `freqs` tables as params and masks them
out of the update; in the port they are buffers, not parameters, so the
optimizer never sees them and the mask is implicit.

Across ranks (`group`, the data axis of a mesh, parallel/mesh.py), the
flat buffers set the layouts:
  * data parallel: the flat gradient is summed over the group with one
    all_reduce and divided by its size before the clip and A1 (JAX's psum
    over `data`), so the clip sees the global norm;
  * `shard=True` (FSDP, ZeRO over the flat buffers): each rank keeps its
    1/n slice of the parameters and of both moments (padded to a multiple
    of n). `gather()` all-gathers the parameters into the flat buffer
    before a forward; `step` reduce-scatters the flat gradient, forms the
    global norm from an all_reduce of the slices' squared norms, runs A1
    on the local slice and frees the gathered parameter and gradient
    buffers (their storage, which the parameters' views keep pointing
    at). State at rest is (P + 2P)/n, plus the transient gather, as JAX
    accounts it (parallel/fsdp.py there). `state_dict` gathers the moments
    whole, so a checkpoint does not depend on the layout;
  * tensor parallel (parameters `parallelize_model` cut, which carry the
    model axis' group as `MODEL_GROUP`): each rank's flat buffers hold
    its slices of the sharded parameters and whole copies of the
    replicated ones, and A1 updates them as they are. The clip's norm^2
    is the sum over the model axis of the sharded entries' squares plus
    the replicated entries' squares once: the axis' rank 0 counts every
    entry it holds, the others only their sharded ones (a mask, sliced
    with the buffers under `shard`), and the squared norms are summed
    over the data group (under `shard`) and the model group. At a model
    axis of one rank every entry counts and the norm is |g| bit for bit.

Two options of the JAX trainer ride on `FlatAdam`:
  * `mu_dtype=torch.bfloat16` (--mu_bf16, optax's `mu_dtype`): the first
    moment is stored in bf16; A1's bf16-m variant reads and widens it,
    updates in fp32 and stores it rounded to nearest even (ops/adamw.py);
  * `accumulation_steps=k` (the trainer's `optax.MultiSteps(tx, k)`): each
    micro-step folds its gradient into the running mean acc + (g - acc) /
    (n + 1) (optax's use_grad_mean); on the k-th, clip and A1 run once on
    that mean and the mean goes back to zero. The parameters hold in
    between and A1 does not launch. The schedule reads the count of
    applied updates. The mean is one more fp32 flat buffer (0.71 GB at the
    flagship's 177.6M parameters), updated in plain PyTorch as JAX updates
    it in XLA.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, Optional

import torch
import torch.distributed as dist
from torch import nn

from meant_tpu_torch.ops.adamw import MU_DTYPE, adamw_update


def epoch_schedule(kind: str, base_lr: float, t0: int = 7, tmax: int = 10,
                   steps_per_epoch: int = 1, warmup_steps: int = 0,
                   total_steps: int = 0) -> Callable[[int], float]:
    """lr as a function of the 0-based step count, reproducing torch's
    per-epoch schedules (the factor changes only at epoch boundaries);
    `linear_warmup` is per step (HF get_linear_schedule_with_warmup)."""

    def factor(step: int) -> float:
        epoch = step // steps_per_epoch
        if kind == "cosine_warm":
            return (1 + math.cos(math.pi * (epoch % t0) / t0)) / 2
        if kind == "cosine":
            return (1 + math.cos(math.pi * epoch / tmax)) / 2
        if kind == "linear":
            # torch LinearLR defaults: start_factor=1/3, total_iters=5
            return 1.0 / 3 + (2.0 / 3) * (min(epoch, 5) / 5)
        if kind == "linear_warmup":
            if step < warmup_steps:
                return step / max(warmup_steps, 1)
            denom = max(total_steps - warmup_steps, 1)
            return max(0.0, (total_steps - step) / denom)
        if kind == "constant":
            return 1.0
        raise ValueError(f"unsupported scheduler {kind}")

    factor(0)  # an unknown kind fails here, not at the first step
    return lambda step: base_lr * factor(step)


class FlatAdam:
    """AdamW / Adam over every parameter of `params` that requires grad,
    with one launch of the update kernel per step.

    The parameters must be fp32 and on one device. Their values, their
    gradients and the two moments live in four flat buffers (fp32, the
    first moment in `mu_dtype`); each parameter's `.data` and `.grad`
    become views into the first two, so autograd accumulates straight into
    the flat gradient (`zero_grad` zeroes it in place and keeps the views;
    do not set the gradients to None). The global norm is a device scalar,
    so a step has no host sync. With `accumulation_steps` k > 1, `step`
    applies an update on every k-th call only (see the module's notes).
    With `group` the gradient is averaged over its ranks; with `shard`
    the state is split over them too (the module's notes): then call
    `gather()` before any forward that reads the parameters. Parameters
    cut by tensor parallelism are found by their mark, and the norm is
    the global one (the module's notes).
    """

    def __init__(self, params: Iterable[nn.Parameter],
                 schedule: Callable[[int], float], *, coupled: bool,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0,
                 clip_norm: Optional[float] = 1.0,
                 mu_dtype: Optional[torch.dtype] = None,
                 accumulation_steps: int = 1, group=None,
                 shard: bool = False):
        self.params = [p for p in params if p.requires_grad]
        if not self.params:
            raise ValueError("no trainable parameters")
        device = self.params[0].device
        for p in self.params:
            if p.dtype != torch.float32 or p.device != device:
                raise ValueError(f"FlatAdam takes fp32 parameters on one "
                                 f"device, got {p.dtype} on {p.device}")
        if mu_dtype not in (None, torch.float32, MU_DTYPE):
            raise ValueError(f"mu_dtype must be None, fp32 or {MU_DTYPE}, "
                             f"got {mu_dtype}")
        if accumulation_steps < 1:
            raise ValueError(f"accumulation_steps must be >= 1, got "
                             f"{accumulation_steps}")
        self.schedule, self.coupled = schedule, coupled
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay, self.clip_norm = weight_decay, clip_norm
        self.accumulation_steps = accumulation_steps
        if shard and group is None:
            raise ValueError("shard=True needs the group to shard over")
        self.group, self.shard = group, shard
        self.world = 1 if group is None else dist.get_world_size(group)
        self.n = n = sum(p.numel() for p in self.params)
        # the slice each rank keeps under shard (the last one padded)
        self.chunk = -(-n // self.world) if shard else n
        total = self.chunk * self.world if shard else n
        self.flat_p = torch.zeros(total, dtype=torch.float32, device=device)
        self.flat_g = torch.zeros_like(self.flat_p)
        local = dict(dtype=torch.float32, device=device)
        self.m = torch.zeros(self.chunk, **dict(local, dtype=mu_dtype
                                                or torch.float32))
        self.v = torch.zeros(self.chunk, **local)
        self.step_count = 0     # applied updates
        self.last_norm = None   # the clip's global norm at the last update
        # the running mean of the micro-steps' gradients and their count
        self.acc = (torch.zeros(self.chunk, **local)
                    if accumulation_steps > 1 else None)
        self.mini_step = 0
        offset = 0
        with torch.no_grad():
            for p in self.params:
                k = p.numel()
                self.flat_p[offset:offset + k].copy_(p.reshape(-1))
                p.data = self.flat_p[offset:offset + k].view_as(p)
                p.grad = self.flat_g[offset:offset + k].view_as(p)
                offset += k
            if group is not None:       # replicated: rank 0's values
                dist.broadcast(self.flat_p, dist.get_global_rank(group, 0),
                               group=group)
        self.model_group, self.norm_mask = self._norm_split(total)
        if shard:
            start = dist.get_rank(group) * self.chunk
            self.p_local = self.flat_p[start:start + self.chunk].clone()
            self.g_local = torch.zeros_like(self.p_local)
            if self.norm_mask is not None:
                self.norm_mask = self.norm_mask[start:start
                                                + self.chunk].clone()
            self.release()

    def _norm_split(self, total: int):
        """The model axis' group of the tensor-parallel parameters (None
        without any) and, on its ranks other than 0, the mask of the flat
        entries the clip's norm counts there: the sharded ones."""
        from meant_tpu_torch.parallel.sharding_rules import MODEL_GROUP
        groups = {id(g): g for g in (getattr(p, MODEL_GROUP, None)
                                     for p in self.params) if g is not None}
        if not groups:
            return None, None
        if len(groups) > 1:
            raise ValueError("tensor-parallel parameters of more than one "
                             "model axis")
        model_group = next(iter(groups.values()))
        if dist.get_rank(model_group) == 0:
            return model_group, None
        mask = torch.zeros(total, dtype=torch.bool,
                           device=self.flat_p.device)
        offset = 0
        for p in self.params:
            if getattr(p, MODEL_GROUP, None) is not None:
                mask[offset:offset + p.numel()] = True
            offset += p.numel()
        return model_group, mask

    def gather(self) -> None:
        """Under shard, all-gather the parameters into the flat buffer the
        parameters view (a no-op while it is gathered, or without
        shard)."""
        storage = self.flat_p.untyped_storage()
        if not self.shard or storage.size():
            return
        storage.resize_(self.flat_p.numel() * self.flat_p.element_size())
        dist.all_gather_into_tensor(self.flat_p, self.p_local,
                                    group=self.group)

    def take_params(self) -> None:
        """Under shard, keep this rank's slice of parameters loaded into
        the gathered buffer (a no-op without shard, where the parameters
        are the buffer)."""
        if self.shard:
            start = dist.get_rank(self.group) * self.chunk
            self.p_local.copy_(self.flat_p[start:start + self.chunk])

    def release(self) -> None:
        """Under shard, free the gathered parameters and the flat gradient
        (the views into them stay, pointing at no memory until `gather`
        and `zero_grad`)."""
        for t in (self.flat_p, self.flat_g):
            t.untyped_storage().resize_(0)

    def zero_grad(self) -> None:
        storage = self.flat_g.untyped_storage()
        if not storage.size():
            storage.resize_(self.flat_g.numel() * self.flat_g.element_size())
        self.flat_g.zero_()

    def _reduce_gradient(self) -> torch.Tensor:
        """This rank's gradient to update from: the flat gradient averaged
        over the group (its slice of it under shard)."""
        if self.group is None:
            return self.flat_g
        if self.shard:
            g = self.g_local
            dist.reduce_scatter_tensor(g, self.flat_g, group=self.group)
        else:
            g = self.flat_g
            dist.all_reduce(g, group=self.group)
        return g.div_(self.world)

    def step(self) -> bool:
        """One micro-step; returns whether it applied an update (always,
        without accumulation)."""
        g = self._reduce_gradient()
        if self.shard:
            self.release()
        if self.acc is not None:
            self.acc.add_((g - self.acc) / (self.mini_step + 1))
            self.mini_step += 1
            if self.mini_step < self.accumulation_steps:
                return False
            self.mini_step = 0
            g = self.acc
        norm = None
        if self.clip_norm is not None:
            norm = torch.linalg.vector_norm(
                g if self.norm_mask is None else torch.where(self.norm_mask,
                                                             g, 0.0))
            if self.shard or self.model_group is not None:
                # sqrt(fl(x * x)) == x: exact at world 1
                norm = norm.square()
                if self.shard:
                    dist.all_reduce(norm, group=self.group)
                if self.model_group is not None:
                    dist.all_reduce(norm, group=self.model_group)
                norm = norm.sqrt()
        self.last_norm = norm
        self.step_count += 1
        adamw_update(self.p_local if self.shard else self.flat_p, g, self.m,
                     self.v,
                     lr=self.schedule(self.step_count - 1), b1=self.b1,
                     b2=self.b2, eps=self.eps,
                     weight_decay=self.weight_decay, step=self.step_count,
                     coupled=self.coupled, norm=norm,
                     max_norm=self.clip_norm or 0.0)
        if self.acc is not None:
            self.acc.zero_()
        return True

    def _whole(self, t: torch.Tensor) -> torch.Tensor:
        """A state slice gathered whole (all ranks call it under shard)."""
        if not self.shard:
            return t
        out = t.new_empty(self.chunk * self.world)
        dist.all_gather_into_tensor(out, t, group=self.group)
        return out[:self.n]

    def _mine(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's slice of a whole state tensor."""
        if not self.shard:
            return t
        start = dist.get_rank(self.group) * self.chunk
        return torch.nn.functional.pad(t, (0, self.chunk * self.world
                                           - self.n))[start:start
                                                      + self.chunk]

    def state_dict(self) -> dict:
        state = {"m": self._whole(self.m), "v": self._whole(self.v),
                 "step": self.step_count}
        if self.acc is not None:
            state.update(acc=self._whole(self.acc), mini_step=self.mini_step)
        return state

    def load_state_dict(self, state: dict) -> None:
        self.m.copy_(self._mine(state["m"]))
        self.v.copy_(self._mine(state["v"]))
        self.step_count = int(state["step"])
        if self.acc is not None:
            if "acc" in state:
                self.acc.copy_(self._mine(state["acc"]))
                self.mini_step = int(state["mini_step"])
            else:
                self.acc.zero_()
                self.mini_step = 0


def build_optimizer(params: Iterable[nn.Parameter], optimizer: str = "AdamW",
                    learning_rate: float = 5e-5, decay: float = 0.0,
                    beta_1: float = 0.9, beta_2: float = 0.999,
                    lr_scheduler: str = "cosine_warm", t0: int = 7,
                    tmax: int = 10, steps_per_epoch: int = 1,
                    warmup_steps: int = 0, total_steps: int = 0,
                    clip_norm: Optional[float] = 1.0,
                    mu_dtype: Optional[torch.dtype] = None,
                    accumulation_steps: int = 1, group=None,
                    shard: bool = False) -> FlatAdam:
    """The trainer's optimizer, as the JAX package's build_optimizer builds
    it (clip, then AdamW or Adam, on an epoch schedule), with the first
    moment stored in `mu_dtype` (None or fp32, or torch.bfloat16 for
    optax's mu_dtype=jnp.bfloat16) and, for accumulation_steps > 1, the
    trainer's optax.MultiSteps wrapper; `group` and `shard` as FlatAdam
    takes them."""
    if optimizer not in ("AdamW", "Adam"):
        raise ValueError("This type of optimizer is not supported.")
    sched = epoch_schedule(lr_scheduler, learning_rate, t0, tmax,
                           steps_per_epoch, warmup_steps, total_steps)
    return FlatAdam(params, sched, coupled=optimizer == "Adam", b1=beta_1,
                    b2=beta_2, weight_decay=decay, clip_norm=clip_norm,
                    mu_dtype=mu_dtype, accumulation_steps=accumulation_steps,
                    group=group, shard=shard)
