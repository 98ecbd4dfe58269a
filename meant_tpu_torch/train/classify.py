"""Classification trainer (counterpart of meant_tpu/train/classify.py):
`meant_trainer`, its loss, and the batch-to-forward dispatch.

Semantics kept from the JAX package (and its reference):
  * loss: CrossEntropy over the model's sigmoid outputs (log_softmax of
    them), a weighted mean on eval batches whose padded rows weigh 0;
  * clip to global norm 1.0, then AdamW/Adam (`train/optim.py`, one launch
    of the fused update kernel per step), schedules stepped per epoch;
  * loss and confusion matrix stay on the device inside an epoch: one host
    fetch per epoch; the NaN guard reads that epoch loss;
  * per-epoch validation, early stop with patience 5 on val macro-F1, with
    the reference's `prev_f1 = inf` start (the first epoch counts as no
    improvement);
  * a checkpoint after training, written in the background
    (`train/checkpoint.py`, lanes "params" and "opt") while the optional
    test pass runs and its confusion matrix is drawn to
    `{file_path}/output_files/{dataset}/plots/confusion_{model}_{run}.png`
    ("confusion-matrix plot skipped: ..." where matplotlib is missing);
    then the writes are waited for.

The price baselines `mlp` and `lstm` (PER_DAY_MODELS) give one output
per lag step (b, lag, c); JAX's trainer cannot take those (its loss
gathers along the last axis of a (b, 1) label index and fails). Training
them on the target (last) day's output (`row_outputs`) is this port's own
choice, not a rule of the JAX package or of its reference. Any other
model's output goes to the loss as it is. Serving returns the whole
output.

Dropout draws from the default generator of the model's device, seeded
from `seed` when the trainer builds its optimizer; torch cannot give the
bits JAX's dropout draws, so runs agree with the JAX trainer only with
dropout off. `mu_dtype` (a bf16 first moment) and `accumulation_steps`
(optax.MultiSteps: the running mean of k micro-steps' gradients, one
update every k-th, leftovers carried into the next epoch) ride on the
optimizer (`train/optim.py`).

`mesh` (a DeviceMesh, parallel/mesh.py) trains data parallel over its
leading axis: each rank takes its rows of every global batch (which must
divide over the axis, as JAX's device_put requires), the flat gradient is
averaged over the axis before the clip and A1, and the losses, confusion
matrices and eval outputs are reduced to the global batch's. `fsdp=True`
shards the parameters and both moments over that axis too (ZeRO over
FlatAdam's flat buffers; a world-sized mesh is made when none is given).
A model cut by `parallel.parallelize_model` over the same mesh's 'model'
axis trains tensor parallel (dp x tp, fsdp x tp, or a hybrid mesh whose
leading axis is 'dcn'); every rank seeds its dropout from `seed`, so the
replicated parts draw the same masks across the model axis.
Checkpoints hold the whole state whatever the layout; rank 0 writes them
(train/layout.py).
"""

from __future__ import annotations

import math
import os
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from meant_tpu_torch.data.loader import Prefetcher
from meant_tpu_torch.parallel.mesh import rank_zero
from meant_tpu_torch.train import checkpoint as ckpt
from meant_tpu_torch.train.layout import DataLayout, weighted_mean
from meant_tpu_torch.train.optim import build_optimizer
from meant_tpu_torch.utils.metrics import F1Metrics, confusion_delta

# kwargs-era models consume the batch dict directly (`forward(**batch)`).
KWARGS_MODELS = ("meant_src", "meant_price", "meant_timesformer",
                 "meant_mean_pooling", "meant_mosi", "mlp", "lstm")
_NON_INPUT_KEYS = ("y", "_weight", "labels")
# price baselines with one output per lag step
PER_DAY_MODELS = ("mlp", "lstm")
# paper-generation models take positional TempStock-layout inputs (tweets,
# graphs, attention_masks, prices, macds), and so do meant_tweet_price,
# teanet and the HF baselines (the target day's tweets, and charts)
HF_MODELS = ("bertweet", "vl_bert", "vilt")
POSITIONAL_MODELS = ("meant", "meant_vision", "meant_tweet",
                     "meant_tweet_no_lag", "meantPrice", "meant_tweet_price",
                     "teanet") + HF_MODELS


def model_inputs(model_name: str, batch: Dict[str, Any]) -> tuple:
    """(args, kwargs) for `model(*args, **kwargs)`."""
    if model_name in KWARGS_MODELS:
        return (), {k: v for k, v in batch.items()
                    if k not in _NON_INPUT_KEYS}
    if model_name == "meant":
        return (batch["tweets"], batch["graphs"]), \
               {"attention_mask": batch.get("attention_masks")}
    if model_name == "meant_vision":
        return (batch["graphs"],), {}
    if model_name == "meant_tweet":
        return (batch["tweets"],), \
               {"attention_mask": batch.get("attention_masks")}
    if model_name in ("bertweet", "bert", "finbert"):
        # the HF text baselines run on the target day only
        return (batch["tweets"][:, -1],), {}
    if model_name == "meant_tweet_no_lag":
        # single-day ablation: the target day only
        tw = batch["tweets"]
        return ((tw[:, -1] if tw.ndim == 3 else tw),), {}
    if model_name == "meantPrice":
        return (batch["tweets"], batch["graphs"], batch["prices"]), {}
    if model_name == "meant_tweet_price":
        return (batch["tweets"], batch["prices"]), \
               {"attention_mask": batch.get("attention_masks")}
    if model_name in ("vl_bert", "vilt"):
        # the multimodal HF baselines: the target day only
        return (batch["tweets"][:, -1], batch["graphs"][:, -1]), {}
    if model_name == "teanet":
        # TempStock feeds macds, Stocknet prices
        price = batch["macds"] if "macds" in batch else batch["prices"]
        return (batch["tweets"], price), {}
    # meant_vqa runs through its own harness (train/vqa.py), as in JAX
    raise NotImplementedError(f"model {model_name} has no batch dispatch "
                              f"in the classification trainer")


def row_outputs(model_name: str, out: torch.Tensor) -> torch.Tensor:
    """The output the loss reads: the target (last) day's (b, num_classes)
    of a price baseline's (b, lag, num_classes), any other model's as it
    is."""
    return out[:, -1] if model_name in PER_DAY_MODELS else out


def _nll(out: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(out.to(torch.float32), dim=-1)
    return -logp.gather(-1, labels.to(torch.int64)[:, None]).squeeze(-1)


def sigmoid_ce_loss(out: torch.Tensor, labels: torch.Tensor,
                    weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """CrossEntropy over the model's sigmoid outputs (reference
    convention), in fp32."""
    nll = _nll(out, labels)
    if weight is None:
        return nll.mean()
    return (nll * weight).sum() / torch.clamp(weight.sum(), min=1.0)


def seed_dropout(device: torch.device, seed: int) -> None:
    """Seed the default generator of `device`, which dropout draws from."""
    if device.type == "cuda":
        index = device.index
        if index is None:
            index = torch.cuda.current_device()
        torch.cuda.default_generators[index].manual_seed(seed)
    else:
        torch.default_generator.manual_seed(seed)


class meant_trainer:
    """params: dict with the reference's keys: model (built on its device),
    model_name, dataset, train_loader, val_loader, test_loader, epochs,
    num_classes, lag, file_path, run_id, num_encoders, optimizer / lr /
    decay / beta_1 / beta_2 / lr_scheduler (or lrst) / t0 / tmax,
    early_stopping, test_model, seed, init_params (a state_dict), mu_dtype
    (None or torch.bfloat16), accumulation_steps, mesh, fsdp."""

    def __init__(self, p: Dict[str, Any]):
        self.model = p["model"]
        self.model_name = p["model_name"]
        self.dataset = p.get("dataset", "Tempstock")
        self.train_loader = p["train_loader"]
        self.val_loader = p.get("val_loader")
        self.test_loader = p.get("test_loader")
        self.num_epochs = p.get("epochs", 1)
        self.num_classes = p.get("num_classes", 2)
        self.lag = p.get("lag", 5)
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
            lr_scheduler=p.get("lrst", p.get("lr_scheduler", "cosine_warm")),
            t0=p.get("t0", 7), tmax=p.get("tmax", 10),
            steps_per_epoch=max(len(self.train_loader), 1),
            mu_dtype=p.get("mu_dtype"),
            accumulation_steps=p.get("accumulation_steps", 1),
            **self.layout.optimizer_kwargs())
        self.optimizer = None
        self.history = []

    # ---- setup -----------------------------------------------------------
    def _apply_init_params(self) -> None:
        if self.optimizer is not None:
            self.optimizer.gather()     # FSDP: the parameters whole
        if self.init_params is not None:
            self.model.load_state_dict(self.init_params)
            self.init_params = None
            if self.optimizer is not None:
                self.optimizer.take_params()

    def _init_state(self) -> None:
        """Load `init_params`, seed dropout, build the optimizer (which
        flattens the parameters into its buffers)."""
        self._apply_init_params()
        seed_dropout(self.device, self.seed)
        self.optimizer = build_optimizer(self.model.parameters(),
                                         **self._opt_kwargs)

    # ---- steps -----------------------------------------------------------
    def train_step(self, batch: Dict[str, torch.Tensor]) -> tuple:
        """One optimizer step (a micro-step under accumulation) on a device
        batch (this rank's rows under a mesh); returns the global batch's
        loss and confusion delta as device tensors (no host sync)."""
        if self.optimizer is None:
            self._init_state()
        self.model.train()
        self.optimizer.gather()
        self.optimizer.zero_grad()
        args, kwargs = model_inputs(self.model_name, batch)
        out = row_outputs(self.model_name,
                          self.model(*args, **kwargs))
        loss = sigmoid_ce_loss(out, batch["y"])
        loss.backward()
        self.optimizer.step()
        out = out.detach()
        return (self.layout.mean(loss.detach()),
                self.layout.sum(confusion_delta(out, batch["y"],
                                                self.num_classes)))

    @torch.no_grad()
    def eval_step(self, batch: Dict[str, torch.Tensor]) -> tuple:
        """Loss, confusion matrix (padded rows excluded) and outputs of one
        device batch with a `_weight` vector (under a mesh: the global
        batch's loss and confusion matrix, this rank's outputs)."""
        self._apply_init_params()
        self.model.eval()
        c = self.num_classes
        labels, weight = batch["y"].to(torch.int64), batch["_weight"]
        args, kwargs = model_inputs(self.model_name, batch)
        out = row_outputs(self.model_name,
                          self.model(*args, **kwargs))
        loss = weighted_mean(_nll(out, labels), weight, self.layout)
        real = weight > 0
        idx = torch.where(real, labels, c) * c + out.argmax(dim=-1)
        cm = torch.zeros((c + 1) * c, dtype=torch.int64, device=out.device)
        cm.index_add_(0, idx, real.to(torch.int64))
        return loss, self.layout.sum(cm.reshape(c + 1, c)[:c]), out

    # ---- loops -----------------------------------------------------------
    def train(self) -> dict:
        if self.optimizer is None:
            self._init_state()
        prev_f1 = float("inf")
        patience, lost_patience = 0, 5
        final_epoch = 0
        for ep in range(self.num_epochs):
            final_epoch = ep
            t0 = time.time()
            train_metrics = F1Metrics(self.num_classes, "train", self.device)
            losses = []
            for batch in Prefetcher(self.layout.rows(self.train_loader),
                                    self.device):
                loss, cm = self.train_step(batch)
                train_metrics.update_cm(cm)
                losses.append(loss)
            epoch_loss = float(torch.stack(losses).mean())  # one fetch
            if math.isnan(epoch_loss):
                print("nans encountered. Current state of performance:")
                train_metrics.show()
                raise FloatingPointError("NaN loss")
            print("length: ", str(time.time() - t0))
            print("loss total: ", epoch_loss * max(len(losses), 1))
            train_metrics.show()
            record = {"epoch": ep, "train_loss": epoch_loss,
                      **{f"train_{k}": v for k, v in
                         train_metrics.compute().items()
                         if not isinstance(v, list)}}
            if self.val_loader is not None:
                val_f1_macro, _, val_metrics = self.evaluate(
                    self.val_loader, "validation")
                record.update({f"val_{k}": v for k, v in val_metrics.items()
                               if not isinstance(v, list)})
                if self.early_stopping:
                    if val_f1_macro <= prev_f1:
                        patience += 1
                        if patience == lost_patience:
                            print("Stopped at epoch " + str(ep))
                            self.history.append(record)
                            break
                    else:
                        patience = 0
                    prev_f1 = val_f1_macro
            self.history.append(record)

        # the checkpoint writes in the background while the test pass runs
        checkpoint = self.save(final_epoch + 1, block=False)
        results = {"history": self.history}
        if self.test_model and self.test_loader is not None:
            print("Testing...")
            _, _, results["test"] = self.evaluate(self.test_loader, "test")
            # confusion-matrix artifact (`src/trainer.py:316-331`)
            try:
                from meant_tpu_torch.utils.observability import \
                    save_confusion_matrix
                save_confusion_matrix(
                    np.asarray(results["test"]["confusion"]),
                    os.path.join(self.file_path, "output_files",
                                 self.dataset, "plots",
                                 f"confusion_{self.model_name}_"
                                 f"{self.run_id}.png"),
                    title=f"{self.model_name} {self.dataset}")
            except Exception as e:
                print(f"confusion-matrix plot skipped: {e}")
        try:
            ckpt.wait_for_saves()   # the files are whole before returning
        except Exception as e:
            print(f"Your filepath is invalid. Save has failed: {e}")
            checkpoint = None
        results["checkpoint"] = checkpoint
        return results

    def evaluate(self, loader, set_name: str):
        self._apply_init_params()
        metrics = F1Metrics(self.num_classes, set_name, self.device)
        # scores for AUROC stay on the device; one fetch per evaluation
        scores, labels, weights = [], [], []
        for batch in Prefetcher(self.layout.rows(loader), self.device):
            _, cm, out = self.eval_step(batch)
            metrics.update_cm(cm)
            if self.num_classes == 2:
                scores.append(out)
                labels.append(batch["y"])
                weights.append(batch["_weight"])
        if scores:
            gather = self.layout.gather
            real = gather(torch.cat(weights)) > 0
            metrics._scores.append(
                gather(torch.cat(scores))[real].float().cpu().numpy())
            metrics._labels.append(
                gather(torch.cat(labels))[real].cpu().numpy())
        f1_macro, f1_micro = metrics.show()
        return f1_macro, f1_micro, metrics.compute()

    # ---- persistence ------------------------------------------------------
    def _paths(self, epoch: int) -> tuple:
        name = ckpt.checkpoint_name(self.model_name, self.num_encoders,
                                    self.dataset, self.run_id, epoch)
        return (os.path.join(self.file_path, "models", self.model_name,
                             name),
                os.path.join(self.file_path, "optimizers", self.model_name,
                             name))

    def save(self, epoch: int, block: bool = True) -> Optional[str]:
        """Model params under models/ and optimizer state under
        optimizers/, on the lanes "params" and "opt" so the two writes
        overlap; returns the params path, or None when a write failed (the
        reference tolerates a failed save). block=False returns once both
        are snapshotted to host memory; `checkpoint.wait_for_saves` is the
        barrier."""
        path, opt_path = self._paths(epoch)
        step = self.optimizer.step_count if self.optimizer else 0
        self._apply_init_params()
        # every rank gathers (FSDP); rank 0 writes
        opt_state = (self.optimizer.state_dict() if self.optimizer
                     else None)
        if not rank_zero():
            return path
        try:
            ckpt.save(path, {"params": self.model.state_dict(),
                             "step": step}, block=False, lane="params")
            if opt_state is not None:
                ckpt.save(opt_path, {"opt_state": opt_state, "step": step},
                          block=block, lane="opt")
            if block:
                ckpt.wait_for_saves()
        except Exception as e:
            print(f"Your filepath is invalid. Save has failed: {e}")
            return None
        return path

    def load_params(self, path: str) -> None:
        """Params of a checkpoint, loaded before the next train/evaluate."""
        self.init_params = ckpt.restore(path, self.device)["params"]

    def resume(self, epoch: int) -> None:
        """Restore params and optimizer state from the epoch-`epoch`
        checkpoints (`in_loop_train.py:540-541,569-575`)."""
        path, opt_path = self._paths(epoch)
        self.init_params = ckpt.restore(path, self.device)["params"]
        self._init_state()
        try:
            opt = ckpt.restore(opt_path, self.device)
        except FileNotFoundError as e:
            print(f"optimizer state not restored ({e}); fresh optimizer")
            return
        self.optimizer.load_state_dict(opt["opt_state"])
