"""VQA trainer (counterpart of meant_tpu/train/vqa.py): `soft_target_ce` and
`vqa_trainer`.

Semantics kept from the JAX package (and its reference):
  * loss: cross entropy against SOFT targets (the VQA-v2 min(1, count / 3)
    scores): -sum(target * log_softmax(out)) averaged over the batch, in
    fp32 (torch's CrossEntropyLoss with probability targets);
  * clip to global norm 1.0, then AdamW/Adam (`train/optim.py`, one launch
    of the fused update kernel A1 per step), schedules stepped per epoch;
  * train, validation and test F1 metrics on `argmax(targets)`, the
    confusion matrix kept on the device;
  * early stop with patience 5 on val macro-F1 from `prev_f1 = inf`;
  * after training, the params (and the step) under
    `{file_path}/models/{model_name}/{checkpoint_name}`; a failed write
    prints and training carries on, as in JAX; then an optional test pass.

Batches hold language_input_ids, pixel_values, attention_mask, pixel_mask
(read by no model) and labels (soft targets). Dropout draws from the
default generator of the model's device, seeded from `seed` when the
trainer builds its optimizer, as `meant_trainer` does. `mesh` and `fsdp`
train data parallel and sharded as `meant_trainer` does (train/layout.py).
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, Optional

import torch

from meant_tpu_torch.data.loader import Prefetcher
from meant_tpu_torch.parallel.mesh import rank_zero
from meant_tpu_torch.train import checkpoint as ckpt
from meant_tpu_torch.train.classify import seed_dropout
from meant_tpu_torch.train.layout import DataLayout
from meant_tpu_torch.train.optim import build_optimizer
from meant_tpu_torch.utils.metrics import F1Metrics, confusion_delta


def soft_target_ce(out: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Batch mean of -sum(targets * log_softmax(out)), in fp32."""
    logp = torch.log_softmax(out.to(torch.float32), dim=-1)
    return -(targets.to(torch.float32) * logp).sum(dim=-1).mean()


class vqa_trainer:
    """params: dict with the JAX trainer's keys: model (built on its
    device), model_name, dataset, train_loader, val_loader, test_loader,
    epochs, num_classes, optimizer / lr / decay / beta_1 / beta_2 / lrst /
    t0 / tmax, early_stopping, test_model, file_path, run_id, num_encoders,
    seed, init_params (a partial state_dict that overrides the fresh
    init), mesh, fsdp."""

    def __init__(self, p: Dict[str, Any]):
        self.model = p["model"]
        self.model_name = p.get("model_name", "meant_vqa")
        self.dataset = p.get("dataset", "vqa")
        self.train_loader = p["train_loader"]
        self.val_loader = p.get("val_loader")
        self.test_loader = p.get("test_loader")
        self.num_epochs = p.get("epochs", 1)
        self.num_classes = p["num_classes"]
        self.file_path = p.get("file_path", ".")
        self.run_id = str(p.get("run_id", "0"))
        self.num_encoders = p.get("num_encoders", 1)
        self.early_stopping = p.get("early_stopping", False)
        self.test_model = p.get("test_model", True)
        self.seed = p.get("seed", 0)
        self.init_params = p.get("init_params")
        self.device = next(self.model.parameters()).device
        self.layout = DataLayout(p.get("mesh"), p.get("fsdp", False),
                                 self.device)
        self._opt_kwargs = dict(
            optimizer=p.get("optimizer", "AdamW"),
            learning_rate=p.get("lr", 5e-5), decay=p.get("decay", 0.0),
            beta_1=p.get("beta_1", 0.9), beta_2=p.get("beta_2", 0.999),
            lr_scheduler=p.get("lrst", "cosine_warm"), t0=p.get("t0", 7),
            tmax=p.get("tmax", 10),
            steps_per_epoch=max(len(self.train_loader), 1),
            **self.layout.optimizer_kwargs())
        self.optimizer = None
        self.checkpoint: Optional[str] = None
        self.history = []

    @staticmethod
    def _forward_args(batch) -> tuple:
        return ((batch["language_input_ids"], batch["pixel_values"]),
                {"attention_mask": batch.get("attention_mask")})

    def _init_state(self) -> None:
        """Load `init_params` over the fresh init (the reference's
        pretrained graft), seed dropout, build the optimizer."""
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

    def train_step(self, batch: Dict[str, torch.Tensor]) -> tuple:
        """One optimizer step on a device batch (this rank's rows under a
        mesh); the global batch's loss and confusion delta stay on the
        device."""
        if self.optimizer is None:
            self._init_state()
        self.model.train()
        self.optimizer.gather()
        self.optimizer.zero_grad()
        args, kwargs = self._forward_args(batch)
        out = self.model(*args, **kwargs)
        targets = batch["labels"]
        loss = soft_target_ce(out, targets)
        loss.backward()
        self.optimizer.step()
        return self.layout.mean(loss.detach()), self.layout.sum(
            confusion_delta(out.detach(), targets.argmax(dim=-1),
                            self.num_classes))

    @torch.no_grad()
    def eval_step(self, batch: Dict[str, torch.Tensor]) -> tuple:
        if self.optimizer is not None:
            self.optimizer.gather()
        self.model.eval()
        args, kwargs = self._forward_args(batch)
        out = self.model(*args, **kwargs)
        return (self.layout.mean(soft_target_ce(out, batch["labels"])),
                self.layout.sum(confusion_delta(
                    out, batch["labels"].argmax(dim=-1), self.num_classes)))

    def _metrics(self, loader, set_name: str) -> F1Metrics:
        metrics = F1Metrics(self.num_classes, set_name, self.device)
        for batch in Prefetcher(self.layout.rows(loader), self.device):
            metrics.update_cm(self.eval_step(batch)[1])
        return metrics

    def train(self) -> dict:
        if self.optimizer is None:
            self._init_state()
        prev_f1 = float("inf")
        patience, lost_patience = 0, 5
        final_epoch = 0
        for ep in range(self.num_epochs):
            final_epoch = ep
            t0 = time.time()
            metrics = F1Metrics(self.num_classes, "train", self.device)
            losses = []
            for batch in Prefetcher(self.layout.rows(self.train_loader),
                                    self.device):
                loss, cm = self.train_step(batch)
                metrics.update_cm(cm)
                losses.append(loss)
            train_loss = float(torch.stack(losses).mean())   # one fetch
            print("length: ", str(time.time() - t0))
            metrics.show()
            rec = {"epoch": ep, "train_loss": train_loss}
            if self.val_loader is not None:
                val_f1_macro, _ = self._metrics(self.val_loader,
                                                "validation").show()
                rec["val_f1_macro"] = val_f1_macro
                if self.early_stopping:
                    if val_f1_macro <= prev_f1:
                        patience += 1
                        if patience == lost_patience:
                            print("Stopped at epoch " + str(ep))
                            self.history.append(rec)
                            break
                    else:
                        patience = 0
                    prev_f1 = val_f1_macro
            self.history.append(rec)

        self.checkpoint = self.save(final_epoch + 1)
        results = {"history": self.history}
        if self.test_model and self.test_loader is not None:
            print("Testing...")
            tm = self._metrics(self.test_loader, "test")
            tm.show()
            results["test"] = tm.compute()
        return results

    def save(self, epoch: int) -> Optional[str]:
        """The params and the step under models/; returns the path, or None
        when the write failed."""
        name = ckpt.checkpoint_name(self.model_name, self.num_encoders,
                                    self.dataset, self.run_id, epoch)
        path = os.path.join(self.file_path, "models", self.model_name, name)
        self.optimizer.gather()
        if not rank_zero():
            return path
        try:
            ckpt.save(path, {"params": self.model.state_dict(),
                             "step": self.optimizer.step_count})
        except OSError as e:
            print(f"Your filepath is invalid. Save has failed: {e}")
            return None
        return path
