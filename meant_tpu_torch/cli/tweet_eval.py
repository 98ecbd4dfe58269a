"""tweet_eval-style text-classification fine-tune (counterpart of
meant_tpu/cli/tweet_eval.py), with the same flag names.

    python -m meant_tpu_torch.cli.tweet_eval -rid 0 [--data_dir DIR] \
        [-nc 7] [-nec 12] [--seq_len 128] [-tb 16] [-ne 2] [--device cpu]

Data: the `text` and `label` columns of the first `.csv` in --data_dir,
read with the standard library (`data.datasets.read_csv_texts`) and hashed
into ids (`fnv1a_tokenize`: BOS / EOS, pad id 1, `--seq_len` tokens), else
`--synthetic_n` synthetic tweets whose second token is 3 + the label. The
model is `bertweet_wrapper` (`-nec` layers, `--text_dim` wide,
`--num_heads` heads), trained by `text_classifier_trainer` with the cross
entropy on its sigmoid outputs; the mean step latency is printed last.
`--scan_layers` / `--remat` are refused (no meant-family towers).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from meant_tpu_torch.cli.common import (base_parser, refuse_unported,
                                        reject_stack_flags)
from meant_tpu_torch.data.datasets import fnv1a_tokenize, read_csv_texts
from meant_tpu_torch.data.loader import ArrayLoader
from meant_tpu_torch.models import bertweet_wrapper
from meant_tpu_torch.train.text_classify import text_classifier_trainer


def load_data(args) -> dict:
    if args.data_dir:
        for name in os.listdir(args.data_dir):
            if name.endswith(".csv"):
                path = os.path.join(args.data_dir, name)
                ids, _ = fnv1a_tokenize(read_csv_texts(path, "text"),
                                        args.seq_len, args.vocab_size)
                labels = np.asarray(read_csv_texts(path, "label"))
                return {"input_ids": ids, "y": labels.astype(np.int32)}
        raise FileNotFoundError(f"no csv in {args.data_dir}")
    print("No --data_dir: synthetic tweets (smoke mode).")
    rng = np.random.RandomState(0)
    n = args.synthetic_n
    ids = rng.randint(2, args.vocab_size - 1,
                      size=(n, args.seq_len)).astype(np.int32)
    y = rng.randint(0, args.num_classes, size=n).astype(np.int32)
    ids[:, 1] = 3 + y
    return {"input_ids": ids, "y": y}


def main(argv=None) -> dict:
    """Fine-tune as the CLI does; returns the history and the trainer."""
    args = base_parser().parse_args(argv)
    reject_stack_flags(args, "tweet_eval")
    refuse_unported(args)
    data = load_data(args)
    model = bertweet_wrapper(
        input_dim=args.text_dim, output_dim=args.num_classes,
        vocab_size=args.vocab_size, num_layers=args.num_encoders,
        num_heads=args.num_heads,
        dtype=torch.bfloat16 if args.bf16 else None, device=args.device,
        seed=args.seed)
    trainer = text_classifier_trainer({
        "model": model,
        "train_loader": ArrayLoader(data, args.train_batch_size,
                                    shuffle=True),
        "epochs": args.num_epochs, "num_classes": args.num_classes,
        "lr": args.learning_rate, "decay": args.decay,
        "lrst": args.learning_rate_scheduler_type,
        "optimizer": args.optimizer, "loss": "Cross Entropy",
        "seed": args.seed,
    })
    hist = trainer.train()
    print(f"mean step latency: "
          f"{np.mean(trainer.latencies) * 1e3:.2f} ms")
    return {"history": hist, "trainer": trainer}


if __name__ == "__main__":
    main()
