"""Legacy per-ticker shard-streaming harness (counterpart of
meant_tpu/cli/train_legacy.py), with the same flag names.

    python -m meant_tpu_torch.cli.train_legacy -rid 0 [--data_dir DIR] \
        [-mn meant] [-ne 10] [-tb 16] [--device cpu]

Data: every `.npz` of --data_dir (sorted; one a ticker, holding the
model's TempStock arrays: tweets, graphs, attention_masks, macds, y),
streamed shard by shard (`ShardStream`), or a synthetic TempStock-shaped
set. The model is the CLI's `build_model`; `meant_trainer` trains it with
Adam on the `cosine` schedule, with no validation or test pass, and saves
the checkpoint. The run trains on the card unless --device names another
device.
"""

from __future__ import annotations

import os

import numpy as np

from meant_tpu_torch.cli.common import base_parser, build_model
from meant_tpu_torch.data.datasets import synthetic_tempstock
from meant_tpu_torch.data.loader import ArrayLoader
from meant_tpu_torch.train.classify import meant_trainer


def shard_paths(data_dir: str) -> list:
    return sorted(os.path.join(data_dir, f) for f in os.listdir(data_dir)
                  if f.endswith(".npz"))


class ShardStream:
    """Batches shard by shard: `__len__` counts every shard's full batches
    (read once), `__iter__` loads one shard at a time."""

    def __init__(self, paths, batch_size: int):
        self.paths = paths
        self.batch_size = batch_size
        self._len = None

    def __len__(self):
        if self._len is None:
            self._len = sum(len(ArrayLoader(dict(np.load(p)),
                                            self.batch_size))
                            for p in self.paths)
        return self._len

    def __iter__(self):
        for p in self.paths:
            yield from ArrayLoader(dict(np.load(p)), self.batch_size)


def main(argv=None) -> dict:
    """Train as the CLI does; returns the trainer's results (history,
    checkpoint path) with the trainer under "trainer"."""
    args = base_parser().parse_args(argv)
    model = build_model(args)
    if args.data_dir:
        stream = ShardStream(shard_paths(args.data_dir),
                             args.train_batch_size)
    else:
        print("No --data_dir: synthetic shards (smoke mode).")
        arrays = synthetic_tempstock(n=args.synthetic_n, lag=args.lag,
                                     seq=args.seq_len, channels=4,
                                     size=args.image_size,
                                     vocab=args.vocab_size - 1)
        stream = ArrayLoader(arrays, args.train_batch_size, shuffle=True)
    trainer = meant_trainer({
        "model": model, "model_name": args.model_name,
        "dataset": args.dataset, "train_loader": stream,
        "epochs": args.num_epochs, "num_classes": args.num_classes,
        "lag": args.lag, "file_path": args.file_path, "run_id": args.run_id,
        "num_encoders": args.num_encoders,
        "optimizer": "Adam", "lr": args.learning_rate,
        "lrst": "cosine", "tmax": args.tmax, "test_model": False})
    results = trainer.train()
    results["trainer"] = trainer
    return results


if __name__ == "__main__":
    main()
