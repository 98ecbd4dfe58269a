"""MLM pretraining harness (counterpart of meant_tpu/cli/pretrain_mlm.py),
with the same flag names.

    python -m meant_tpu_torch.cli.pretrain_mlm -rid 0 [--data_dir DIR] \
        [-nec 12] [-ne 10] [-tb 16] [--full_mlm_head] [--device cpu]

Texts: the first column of the first `.parquet` or `.csv` in --data_dir,
in `os.listdir` order as in the JAX harness, or synthetic texts when there
is no --data_dir. A `.csv` is read with the standard library
(`data.datasets.read_csv_texts`, header row first); a `.parquet` by
`data.datasets.read_parquet_texts` (`data/parquet.py`, the standard
library and numpy: UNCOMPRESSED, SNAPPY and GZIP pages of strings,
integers, floats and booleans; the first column that is not a pandas
index; another codec, encoding or type raises NotImplementedError naming
it). Both read a missing value as "nan". The texts are hashed into ids
(`hash_tokenize`, BOS/EOS, pad id 1, vocab_size - 2 buckets), masked
(`mask_tokens`, Bernoulli 0.15, mask id vocab_size - 1, seed = the run id
when it is a number), and split into `max(n // 10, batch)` validation rows
and the rest for training. The model is `meant_language_pretrainer` with
the tied head, trained by `mlm_pretrainer` on the gathered masked positions
(`--full_mlm_head` computes the head everywhere); the checkpoint lands
under `{file_path}/models/meant_language_pretrainer/`.

As in the JAX harness, `--flash` is taken as given: any value but the empty
string, "false" and the default "auto" included, turns the flash path on
and the padding mask off (ROADMAP §3, reference behaviour). `--remat` and
`--scan_layers` reach the tower, as in the JAX harness.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from meant_tpu_torch.cli.common import base_parser, cli_mesh
from meant_tpu_torch.data.datasets import (hash_tokenize, read_csv_texts,
                                            read_parquet_texts)
from meant_tpu_torch.data.loader import ArrayLoader
from meant_tpu_torch.data.masking import mask_tokens
from meant_tpu_torch.models import (EmbeddingConfig,
                                    meant_language_pretrainer)
from meant_tpu_torch.train.pretrain import mlm_pretrainer

MODEL_NAME = "meant_language_pretrainer"


def load_text(args) -> list:
    if args.data_dir:
        for name in os.listdir(args.data_dir):
            if name.endswith(".parquet"):
                return read_parquet_texts(os.path.join(args.data_dir, name))
            if name.endswith(".csv"):
                return read_csv_texts(os.path.join(args.data_dir, name))
        raise FileNotFoundError(f"no parquet/csv in {args.data_dir}")
    print("No --data_dir: synthetic token streams (smoke mode).")
    rng = np.random.RandomState(0)
    return [" ".join(f"w{rng.randint(1000)}" for _ in range(30))
            for _ in range(args.synthetic_n)]


def split(data: dict, batch_size: int) -> tuple:
    """(train, val): the first max(n // 10, batch_size) rows validate."""
    n = len(next(iter(data.values())))
    n_val = max(n // 10, batch_size)
    return ({k: v[n_val:] for k, v in data.items()},
            {k: v[:n_val] for k, v in data.items()})


def mlm_arrays(texts: list, args) -> dict:
    """input_ids (masked), labels and attention_mask of `texts`."""
    pad_id, mask_id = 1, args.vocab_size - 1
    tok = hash_tokenize(args.vocab_size - 2, args.seq_len)
    ids = np.full((len(texts), args.seq_len), pad_id, np.int32)
    for i, t in enumerate(texts):
        enc = tok(t)[: args.seq_len]
        ids[i, : len(enc)] = enc
    seed = int(args.run_id) if str(args.run_id).isdigit() else 0
    inputs, labels = mask_tokens(ids, mask_token_id=mask_id,
                                 special_ids=[0, 1, 2], seed=seed)
    return {"input_ids": inputs, "labels": labels,
            "attention_mask": (ids != pad_id).astype(np.float32)}


def build_model(args) -> meant_language_pretrainer:
    """The harness's model on args.device (the card unless named)."""
    emb = EmbeddingConfig(vocab_size=args.vocab_size,
                          hidden_size=args.text_dim)
    return meant_language_pretrainer(
        num_encoders=args.num_encoders, embedding=emb,
        text_dim=args.text_dim, num_heads=args.num_heads,
        flash=bool(args.flash), scan_layers=bool(args.scan_layers),
        remat=args.remat, dtype=torch.bfloat16 if args.bf16 else None,
        device=args.device, seed=args.seed)


def main(argv=None) -> dict:
    """Pretrain as the CLI does; returns the history, the checkpoint path
    and the trainer."""
    args = base_parser().parse_args(argv)
    data = mlm_arrays(load_text(args), args)
    mesh = cli_mesh(args)
    model = build_model(args)
    train, val = split(data, args.train_batch_size)
    trainer = mlm_pretrainer({
        "model": model, "model_name": MODEL_NAME, "dataset": args.dataset,
        "train_data": ArrayLoader(train, args.train_batch_size,
                                  shuffle=True),
        "val_data": ArrayLoader(val, args.train_batch_size),
        "epochs": args.num_epochs, "lr": args.learning_rate,
        "decay": args.decay, "beta_1": args.beta_1, "beta_2": args.beta_2,
        "lrst": args.learning_rate_scheduler_type, "t0": args.t0,
        "tmax": args.tmax, "optimizer": args.optimizer,
        "file_path": args.file_path, "run_id": args.run_id,
        "num_encoders": args.num_encoders, "seed": args.seed, "mesh": mesh,
        "gather_masked": not args.full_mlm_head,
    })
    t0 = time.time()
    hist = trainer.train()
    print("total time:", time.time() - t0)
    return {"history": hist, "checkpoint": trainer.checkpoint,
            "trainer": trainer}


if __name__ == "__main__":
    main()
