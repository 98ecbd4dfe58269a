"""Resumable NER fine-tune harness (counterpart of
meant_tpu/cli/checkpoint_train.py), with the same flag names.

    python -m meant_tpu_torch.cli.checkpoint_train -rid 0 -ne 1 -fp DIR
    python -m meant_tpu_torch.cli.checkpoint_train -rid 0 --epoch 1 -fp DIR

Data: `ner_prepared.npz` (input_ids, attention_mask, labels with -100
alignment) in --data_dir, else a synthetic set (RandomState(0) ids, tags
id % num_classes, the first position unlabelled). The first max(n // 10,
batch) rows validate, the rest train. The model is a `TokenClassifier`
trained by `ner_trainer` under the name "ner", so a run's checkpoint lands
at `{file_path}/models/ner/ner_<nec>_<dataset>_<rid>_<epochs>`; `--epoch
k` restores the parameters of that name at epoch k before training (the
job-chaining workflow). The run trains on the card unless --device names
another device.
"""

from __future__ import annotations

import os

import numpy as np

from meant_tpu_torch.cli.common import base_parser, reject_stack_flags
from meant_tpu_torch.cli.in_loop_genia import (finish, optimizer_keys,
                                               token_classifier)
from meant_tpu_torch.data.loader import ArrayLoader
from meant_tpu_torch.train import checkpoint as ckpt
from meant_tpu_torch.train.ner import ner_trainer


def load_data(args) -> dict:
    if args.data_dir:
        z = np.load(os.path.join(args.data_dir, "ner_prepared.npz"))
        return {k: z[k] for k in ("input_ids", "attention_mask", "labels")}
    print("No --data_dir: synthetic NER data (smoke mode).")
    rng = np.random.RandomState(0)
    n, s = args.synthetic_n, args.seq_len
    ids = rng.randint(4, args.vocab_size - 1, size=(n, s)).astype(np.int32)
    labels = (ids % args.num_classes).astype(np.int32)
    labels[:, 0] = -100
    return {"input_ids": ids, "labels": labels,
            "attention_mask": np.ones((n, s), np.float32)}


def resume_path(args, epoch: int) -> str:
    name = ckpt.checkpoint_name("ner", args.num_encoders, args.dataset,
                                args.run_id, epoch)
    return os.path.join(args.file_path, "models", "ner", name)


def prepare(argv=None) -> tuple:
    """(trainer, the validation loader token_f1 reads), the model built
    and, with --epoch k, epoch k's parameters set as the trainer's
    `init_params` (loaded when training starts)."""
    args = base_parser().parse_args(argv)
    reject_stack_flags(args, "checkpoint_train")
    data = load_data(args)
    bs = args.train_batch_size
    n_val = max(len(data["labels"]) // 10, bs)
    train = {k: v[n_val:] for k, v in data.items()}
    val = {k: v[:n_val] for k, v in data.items()}
    keys = optimizer_keys(args)
    for key in ("decay", "beta_1", "beta_2"):
        keys.pop(key)        # JAX's harness passes none: the defaults hold
    trainer = ner_trainer({
        "model": token_classifier(args), "model_name": "ner",
        "dataset": args.dataset,
        "train_data": ArrayLoader(train, bs, shuffle=True),
        "val_data": ArrayLoader(val, bs), **keys})
    if args.epoch > 0:
        # the previous epoch's parameters (a fresh optimizer, as in JAX)
        path = resume_path(args, args.epoch)
        trainer.init_params = ckpt.restore(path, trainer.device)["params"]
        print(f"resumed from {path}")
    return trainer, ArrayLoader(val, bs), args.num_classes


def main(argv=None) -> dict:
    """Train as the CLI does; returns the history, the validation set's
    token metrics, the checkpoint path and the trainer."""
    return finish(*prepare(argv))


if __name__ == "__main__":
    main()
