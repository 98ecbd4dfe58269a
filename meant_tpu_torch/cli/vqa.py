"""VQA transfer harness (counterpart of meant_tpu/cli/vqa.py), with the same
flag names.

    python -m meant_tpu_torch.cli.vqa -rid 0 [--data_dir DIR] [-nec 12] \
        [-nc 3130] [-tb 16] [-ne 1] [--device cpu]

Data: `DIR/vqa_prepared.npz` with input_ids, images, attention_mask,
pixel_mask and soft_targets (written offline with `data/vqa.py`'s helpers),
else a synthetic set of `--synthetic_n` questions of 24 tokens, 4-channel
charts at `--image_size` and one-hot targets over `-nc` answers, drawn from
RandomState(0). The first max(n // 10, batch) rows validate, the next as
many test, the rest train. The model is `meant_vqa` (`-nec` encoders a
tower, patch 16, no lag) trained by `vqa_trainer`; the checkpoint lands
under `{file_path}/models/{model_name}/`.

As in the JAX harness, `--flash` reaches the model as the raw string, so
any value, "false" and the default "auto" included, takes the flash path
(R1 + K1 forward, K2 backward on the card; ROADMAP §3, reference
behaviour).
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from meant_tpu_torch.cli.common import base_parser, refuse_unported
from meant_tpu_torch.data.loader import ArrayLoader
from meant_tpu_torch.models import EmbeddingConfig, meant_vqa
from meant_tpu_torch.train.vqa import vqa_trainer

SYNTHETIC_TOKENS = 24


def load_vqa(args) -> dict:
    if args.data_dir:
        with np.load(os.path.join(args.data_dir, "vqa_prepared.npz")) as z:
            return {"language_input_ids": z["input_ids"],
                    "pixel_values": z["images"],
                    "attention_mask": z["attention_mask"],
                    "pixel_mask": z["pixel_mask"],
                    "labels": z["soft_targets"]}
    print("No --data_dir: synthetic VQA records (smoke mode).")
    rng = np.random.RandomState(0)
    n, s, ncls = args.synthetic_n, SYNTHETIC_TOKENS, args.num_classes
    labels = np.zeros((n, ncls), np.float32)
    hard = rng.randint(0, ncls, size=n)
    labels[np.arange(n), hard] = 1.0
    size = args.image_size
    return {
        "language_input_ids": rng.randint(
            2, args.vocab_size - 1, (n, s)).astype(np.int32),
        "pixel_values": rng.randn(n, 4, size, size).astype(np.float32),
        "attention_mask": np.ones((n, s), np.float32),
        "pixel_mask": np.ones((n, size, size), np.float32),
        "labels": labels,
    }


def split(data: dict, batch_size: int) -> tuple:
    """(train, val, test): the first max(n // 10, batch) rows validate, the
    next as many test, the rest train."""
    n = len(data["labels"])
    n_val = max(n // 10, batch_size)
    return ({k: v[2 * n_val:] for k, v in data.items()},
            {k: v[:n_val] for k, v in data.items()},
            {k: v[n_val:2 * n_val] for k, v in data.items()})


def build_model(args) -> meant_vqa:
    """The harness's model on args.device (the card unless named), with
    the raw --flash string as JAX passes it."""
    refuse_unported(args)
    size = args.image_size
    emb = EmbeddingConfig(vocab_size=args.vocab_size,
                          hidden_size=args.text_dim)
    return meant_vqa(args.text_dim, args.image_dim, 4, size, size, 16, 1,
                     args.num_classes, embedding=emb, flash=bool(args.flash),
                     num_heads=args.num_heads,
                     num_encoders=args.num_encoders,
                     scan_layers=bool(args.scan_layers), remat=args.remat,
                     dtype=torch.bfloat16 if args.bf16 else None,
                     device=args.device, seed=args.seed)


def main(argv=None) -> dict:
    """Train as the CLI does; returns the trainer's results (history, test
    metrics) with the checkpoint path and the trainer."""
    args = base_parser().parse_args(argv)
    data = load_vqa(args)
    train, val, test = split(data, args.train_batch_size)
    model = build_model(args)
    bs = args.train_batch_size
    trainer = vqa_trainer({
        "model": model, "model_name": args.model_name, "dataset": "vqa",
        "train_loader": ArrayLoader(train, bs, shuffle=True),
        "val_loader": ArrayLoader(val, bs),
        "test_loader": ArrayLoader(test, bs),
        "epochs": args.num_epochs, "num_classes": args.num_classes,
        "optimizer": args.optimizer, "lr": args.learning_rate,
        "decay": args.decay, "beta_1": args.beta_1, "beta_2": args.beta_2,
        "lrst": args.learning_rate_scheduler_type, "t0": args.t0,
        "tmax": args.tmax, "early_stopping": args.early_stopping,
        "test_model": args.test_model, "file_path": args.file_path,
        "run_id": args.run_id, "num_encoders": args.num_encoders,
        "seed": args.seed,
    })
    t0 = time.time()
    results = trainer.train()
    print("total time:", time.time() - t0)
    results["checkpoint"] = trainer.checkpoint
    results["trainer"] = trainer
    return results


if __name__ == "__main__":
    main()
