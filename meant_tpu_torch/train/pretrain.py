"""MLM and MIM pretrainers (counterpart of meant_tpu/train/pretrain.py).

Semantics kept from the JAX package (and its reference):
  * MLM: CE over the vocabulary with -100 ignored, on the masked positions
    gathered before the head (`gather_masked`, exact: the unmasked ones
    carry no loss); a row with more masked tokens than the capacity turns
    the loss into NaN on the device, with no host sync, rather than drop
    positions;
  * MIM: plain L1 on the first 3 channels, the -100 markers of the unmasked
    pixels INCLUDED as targets (DEFECTS #30); `masked_only=True` repairs;
  * clip to global norm 1.0, then AdamW/Adam (`train/optim.py`, one launch
    of the fused update kernel per step), schedules stepped per epoch;
  * per epoch: the mean train loss (one host fetch), the summed val loss,
    early exit once the val loss has not improved for more than `patience`
    epochs;
  * the final checkpoint: the model's state_dict under
    `{file_path}/models/{model_name}/{name}` and the optimizer state under
    `{file_path}/optimizers/{model_name}/{name}`, as `train/classify.py`
    saves them.

Dropout draws from the default generator of the model's device, seeded
from `seed` when the trainer builds its optimizer, as `meant_trainer` does.
`mesh` and `fsdp` train data parallel and sharded as `meant_trainer` does
(train/layout.py); a loss over a count of positions (MLM, MIM
masked_only) divides by the global batch's count.
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, Optional

import torch

from meant_tpu_torch.data.loader import Prefetcher
from meant_tpu_torch.data.masking import IGNORE_INDEX
from meant_tpu_torch.parallel.mesh import rank_zero
from meant_tpu_torch.train import checkpoint as ckpt
from meant_tpu_torch.train.classify import seed_dropout
from meant_tpu_torch.train.layout import DataLayout, global_ratio
from meant_tpu_torch.train.optim import build_optimizer


def mlm_loss(logits: torch.Tensor, labels: torch.Tensor,
             layout: Optional[DataLayout] = None) -> torch.Tensor:
    """CE over the vocabulary, ignore_index=-100: the mean over the
    non-ignored positions (torch CrossEntropyLoss), in fp32; under a
    `layout`, this rank's share of the global batch's mean
    (`global_ratio`)."""
    vocab = logits.shape[-1]
    logits = logits.reshape(-1, vocab).to(torch.float32)
    labels = labels.reshape(-1)
    valid = labels != IGNORE_INDEX
    safe = torch.where(valid, labels, 0).to(torch.int64)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, safe[:, None]).squeeze(-1)
    return global_ratio((nll * valid).sum(), valid.sum(), layout)


def default_gather_capacity(seq_len: int) -> int:
    """Masked positions gathered per row: 37.5% of the sequence rounded up
    to a multiple of 8 (48 at s=128, about 7 sigma above Bernoulli(0.15)'s
    mean of 19.2)."""
    return min(seq_len, max(8, ((int(seq_len * 3 // 8) + 7) // 8) * 8))


def masked_positions(labels: torch.Tensor, capacity: int):
    """(b, s) MLM labels -> ((b, k) positions of the masked tokens, in
    order, padded with unmasked ones; (b, k) their labels, -100 on the
    padding; a bool device scalar, True when a row holds more than k)."""
    valid = labels != IGNORE_INDEX
    # a stable sort of the invalidity puts the masked positions first
    order = torch.argsort((~valid).to(torch.uint8), dim=-1, stable=True)
    pos = order[:, :capacity]
    return pos, labels.gather(-1, pos), (valid.sum(-1) > capacity).any()


def mim_l1_loss(pred: torch.Tensor, labels: torch.Tensor,
                masked_only: bool = False,
                layout: Optional[DataLayout] = None) -> torch.Tensor:
    """The reference's `nn.L1Loss()(out, labels[:, 0:3])`: the labels hold
    -100 at the unmasked pixels and L1Loss has no ignore_index, so most of
    the objective pulls the reconstruction toward -100 (DEFECTS #30).
    `masked_only=True` takes the L1 over the masked pixels only (under a
    `layout`, this rank's share of the global batch's, `global_ratio`)."""
    target = labels[:, 0:3].to(torch.float32)
    pred = pred.to(torch.float32)
    if not masked_only:
        return (pred - target).abs().mean()
    valid = target != IGNORE_INDEX
    diff = (pred - torch.where(valid, target, pred)).abs()
    return global_ratio(diff.sum(), valid.sum(), layout)


class _BasePretrainer:
    """params: dict with the JAX trainer's keys: model (built on its
    device), model_name, dataset, train_data, val_data, epochs, patience,
    file_path, run_id, num_encoders, seed, optimizer / lr / decay / beta_1
    / beta_2 / lrst / t0 / tmax / warmup_steps / total_steps / clip_norm,
    init_params (a partial state_dict that overrides the fresh init), mesh,
    fsdp."""

    kind = "mlm"

    def __init__(self, p: Dict[str, Any]):
        self.model = p["model"]
        self.model_name = p.get("model_name", self.kind)
        self.dataset = p.get("dataset", "pretrain")
        self.train_data = p["train_data"]
        self.val_data = p.get("val_data")
        self.num_epochs = p.get("epochs", 1)
        self.patience = p.get("patience", 3)
        self.file_path = p.get("file_path", ".")
        self.run_id = str(p.get("run_id", "0"))
        self.num_encoders = p.get("num_encoders", 1)
        self.seed = p.get("seed", 0)
        self.init_params = p.get("init_params")
        self.device = next(self.model.parameters()).device
        self.layout = DataLayout(p.get("mesh"), p.get("fsdp", False),
                                 self.device)
        self._opt_kwargs = dict(
            optimizer=p.get("optimizer", "AdamW"),
            learning_rate=p.get("lr", 5e-5), decay=p.get("decay", 0.0),
            beta_1=p.get("beta_1", 0.9), beta_2=p.get("beta_2", 0.999),
            lr_scheduler=p.get("lrst", "cosine_warm"),
            t0=p.get("t0", 7), tmax=p.get("tmax", 10),
            steps_per_epoch=max(len(self.train_data), 1),
            warmup_steps=p.get("warmup_steps", 0),
            total_steps=p.get("total_steps", 0),
            clip_norm=p.get("clip_norm", 1.0),
            **self.layout.optimizer_kwargs())
        self.optimizer = None
        self.checkpoint: Optional[str] = None
        self.history = []

    # ---- subclass hooks --------------------------------------------------
    def _apply(self, batch):
        raise NotImplementedError

    def _loss(self, out, batch):
        raise NotImplementedError

    # ---- setup and steps -------------------------------------------------
    def _init_state(self) -> None:
        """Load `init_params` over the fresh init, seed dropout, build the
        optimizer (which flattens the parameters into its buffers)."""
        if self.init_params:
            unknown = set(self.init_params) - set(self.model.state_dict())
            if unknown:
                raise KeyError(f"init_params keys the model lacks: "
                               f"{sorted(unknown)}")
            self.model.load_state_dict(self.init_params, strict=False)
            self.init_params = None
        seed_dropout(self.device, self.seed)
        self.optimizer = build_optimizer(self.model.parameters(),
                                         **self._opt_kwargs)

    def loss(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The objective of one device batch in the model's current mode
        (under a mesh: this rank's share of the global batch's)."""
        return self._loss(self._apply(batch), batch)

    def train_step(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """One optimizer step on a device batch (this rank's rows under a
        mesh); returns the global batch's loss as a device tensor (no host
        sync)."""
        if self.optimizer is None:
            self._init_state()
        self.model.train()
        self.optimizer.gather()
        self.optimizer.zero_grad()
        loss = self.loss(batch)
        loss.backward()
        self.optimizer.step()
        return self.layout.mean(loss.detach())

    @torch.no_grad()
    def eval_step(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        if self.optimizer is not None:
            self.optimizer.gather()
        self.model.eval()
        return self.layout.mean(self.loss(batch))

    # ---- loop ------------------------------------------------------------
    def train(self) -> list:
        if self.optimizer is None:
            self._init_state()
        prev_val_loss = float("inf")
        lost_patience = 0
        final_epoch = 0
        for ep in range(self.num_epochs):
            final_epoch = ep
            t0 = time.time()
            losses = [self.train_step(batch) for batch in Prefetcher(
                self.layout.rows(self.train_data), self.device)]
            train_loss = float(torch.stack(losses).mean())   # one fetch
            print("epoch length:", str(time.time() - t0))
            rec = {"epoch": ep, "train_loss": train_loss}
            self.history.append(rec)
            if self.val_data is None:
                continue
            vals = [self.eval_step(batch) for batch in Prefetcher(
                self.layout.rows(self.val_data), self.device)]
            val_loss = float(torch.stack(vals).sum()) if vals else 0.0
            rec["val_loss"] = val_loss
            if val_loss >= prev_val_loss:
                lost_patience += 1
                if lost_patience > self.patience:
                    print("Model is not improving. Exiting pretraining loop.")
                    break
            else:
                prev_val_loss = val_loss
        self.checkpoint = self.save(final_epoch + 1)
        return self.history

    def save(self, epoch: int) -> Optional[str]:
        """Params under models/, optimizer state under optimizers/; returns
        the params path, or None when the write failed (the reference
        tolerates a failed save)."""
        name = ckpt.checkpoint_name(self.model_name, self.num_encoders,
                                    self.dataset, self.run_id, epoch)
        path = os.path.join(self.file_path, "models", self.model_name, name)
        opt_path = os.path.join(self.file_path, "optimizers",
                                self.model_name, name)
        step = self.optimizer.step_count
        self.optimizer.gather()
        opt_state = self.optimizer.state_dict()   # every rank gathers
        if not rank_zero():
            return path
        try:
            ckpt.save(path, {"params": self.model.state_dict(), "step": step})
            ckpt.save(opt_path, {"opt_state": opt_state, "step": step})
        except OSError as e:
            print(f"Save failed: {e}")
            return None
        return path


class mlm_pretrainer(_BasePretrainer):
    """Adds `gather_masked` (default True: the head runs on the masked
    positions only; False gives the full (b, s, vocab) logits, the
    reference's literal compute) and `gather_capacity` (default
    `default_gather_capacity(s)`)."""

    kind = "mlm"

    def __init__(self, p: Dict[str, Any]):
        super().__init__(p)
        self.gather_masked = p.get("gather_masked", True)
        self.gather_capacity = p.get("gather_capacity")

    def _apply(self, batch):
        ids, mask = batch["input_ids"], batch["attention_mask"]
        if not self.gather_masked:
            return self.model(ids, mask)
        cap = self.gather_capacity or default_gather_capacity(
            batch["labels"].shape[-1])
        pos, sel, overflow = masked_positions(batch["labels"], cap)
        return self.model(ids, mask, positions=pos), sel, overflow

    def _loss(self, out, batch):
        if not self.gather_masked:
            return mlm_loss(out, batch["labels"], self.layout)
        logits, sel, overflow = out
        loss = mlm_loss(logits, sel, self.layout)
        return torch.where(overflow, torch.full_like(loss, float("nan")),
                           loss)


class mim_pretrainer(_BasePretrainer):
    """Adds `masked_only` (default False: the reference's L1 on the
    markers, DEFECTS #30)."""

    kind = "mim"

    def __init__(self, p: Dict[str, Any]):
        super().__init__(p)
        self.masked_only = p.get("masked_only", False)

    def _apply(self, batch):
        return self.model(batch["input_ids"])

    def _loss(self, out, batch):
        return mim_l1_loss(out, batch["labels"],
                           masked_only=self.masked_only, layout=self.layout)
