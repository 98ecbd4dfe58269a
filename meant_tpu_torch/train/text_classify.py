"""Text-classification trainer (counterpart of
meant_tpu/train/text_classify.py): `bce_loss` and `text_classifier_trainer`.

Semantics kept from the JAX package (and its reference):
  * loss: BCE on the model's probabilities, clipped to [1e-7, 1 - 1e-7],
    against one-hot labels (torch's nn.BCELoss), or with `loss` "Cross
    Entropy" the classification trainer's `sigmoid_ce_loss`;
  * clip to global norm 1.0, then AdamW/Adam (`train/optim.py`, one launch
    of the fused update kernel A1 per step), the schedule `constant` unless
    named;
  * each step's latency on the host clock, closed by a fetch of its loss
    (so the step has finished on the device), and per epoch the mean loss
    and the train metrics in `history`.

Batches hold input_ids (b, s) and labels y. Dropout draws from the default
generator of the model's device, seeded from `seed` when the trainer
builds its optimizer. `mesh` and `fsdp` train data parallel and sharded
as `meant_trainer` does (train/layout.py).
"""

from __future__ import annotations

import time
from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F

from meant_tpu_torch.data.loader import Prefetcher
from meant_tpu_torch.train.classify import seed_dropout, sigmoid_ce_loss
from meant_tpu_torch.train.layout import DataLayout
from meant_tpu_torch.train.optim import build_optimizer
from meant_tpu_torch.utils.metrics import F1Metrics, confusion_delta


def bce_loss(out: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """torch nn.BCELoss on probability outputs against one-hot labels, in
    fp32, the probabilities clipped to [1e-7, 1 - 1e-7]."""
    out = torch.clamp(out.to(torch.float32), 1e-7, 1 - 1e-7)
    onehot = F.one_hot(labels.to(torch.int64), out.shape[-1]).to(
        torch.float32)
    return -(onehot * torch.log(out)
             + (1 - onehot) * torch.log(1 - out)).mean()


class text_classifier_trainer:
    """params: dict with the JAX trainer's keys: model (built on its
    device), train_loader, num_classes, epochs, loss ("Binary Cross
    Entropy", the default, or another name for the cross entropy), seed,
    optimizer / lr / decay / lrst, mesh, fsdp. JAX's trainer also takes a
    val_loader, which it never reads; this one does not take it."""

    def __init__(self, p: Dict[str, Any]):
        self.model = p["model"]
        self.loader = p["train_loader"]
        self.num_classes = p.get("num_classes", 2)
        self.num_epochs = p.get("epochs", 1)
        self.loss_name = p.get("loss", "Binary Cross Entropy")
        self.seed = p.get("seed", 0)
        self.device = next(self.model.parameters()).device
        self.layout = DataLayout(p.get("mesh"), p.get("fsdp", False),
                                 self.device)
        self._opt_kwargs = dict(
            optimizer=p.get("optimizer", "AdamW"),
            learning_rate=p.get("lr", 5e-5), decay=p.get("decay", 0.0),
            lr_scheduler=p.get("lrst", "constant"),
            steps_per_epoch=max(len(self.loader), 1),
            **self.layout.optimizer_kwargs())
        self.optimizer = None
        self.latencies = []
        self.history = []

    def loss(self, out: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        if self.loss_name == "Binary Cross Entropy":
            return bce_loss(out, labels)
        return sigmoid_ce_loss(out, labels)

    def train_step(self, batch: Dict[str, torch.Tensor]) -> tuple:
        """One optimizer step on a device batch (this rank's rows under a
        mesh); the global batch's loss and confusion delta stay on the
        device."""
        if self.optimizer is None:
            seed_dropout(self.device, self.seed)
            self.optimizer = build_optimizer(self.model.parameters(),
                                             **self._opt_kwargs)
        self.model.train()
        self.optimizer.gather()
        self.optimizer.zero_grad()
        out = self.model(batch["input_ids"])
        loss = self.loss(out, batch["y"])
        loss.backward()
        self.optimizer.step()
        return self.layout.mean(loss.detach()), self.layout.sum(
            confusion_delta(out.detach(), batch["y"], self.num_classes))

    def train(self) -> list:
        for ep in range(self.num_epochs):
            metrics = F1Metrics(self.num_classes, "train", self.device)
            losses = []
            for batch in Prefetcher(self.layout.rows(self.loader),
                                    self.device):
                t0 = time.perf_counter()
                loss, cm = self.train_step(batch)
                losses.append(float(loss))   # the fetch closes the step
                self.latencies.append(time.perf_counter() - t0)
                metrics.update_cm(cm)
            self.history.append({"epoch": ep,
                                 "train_loss": float(np.mean(losses)),
                                 **{f"train_{k}": v for k, v in
                                    metrics.compute().items()
                                    if not isinstance(v, list)}})
        return self.history
