"""Classifier training harness (counterpart of
meant_tpu/cli/in_loop_train.py), with the same flag names.

    python -m meant_tpu_torch.cli.in_loop_train -rid 0 [-mn meant] \
        [--data_dir DIR] [--flash true] [-ne 10] [-tb 16] [--device cpu]

Data (`cli.common.dataset_arrays`): with --data_dir, the TempStock-small
`.npy` arrays of DIR (`graphs_5.npy`, `tweets_5.npy`,
`attention_masks_5.npy`, `macds_5.npy`, `y_resampled_5.npy` at lag 5;
`--normalize` shifts the graphs by their mean), which the paper
generation reads. Without it, the paper generation gets a synthetic
TempStock-shaped set and meant_src a synthetic kwargs-family set
(`--synthetic_n` rows). Either is split 60/20/20 as the reference splits.
`--hf_cache DIR` initialises the model from a local HuggingFace cache
(`utils.hf_cache.hf_graft`: bertweet's whole backbone into `-mn bertweet`,
ViLT's and VisualBERT's checkpoints with bertweet's word table into `vilt`
and `vl_bert`, bertweet's embedding into the meant family; a missing cache
raises FileNotFoundError, a head count other than the model's a
ValueError). `-p true -ptm PATH` then grafts the encoder towers and the
embedding of a pretraining checkpoint (`cli.pretrain_mlm`,
`cli.pretrain_mim`) over that (`train.checkpoint.graft`); both land
before the first step.
`--buckets 128,256,...` trains on length-bucketed batches
(`data.loader.BucketedLoader`, built as the JAX CLI builds it: each batch
from one bucket, tweets / input_ids / attention_masks cut to its length,
shuffled); the kwargs family's mask is `attention_mask`, which the port
buckets and cuts with the rest (the JAX CLI gives that family no
`attention_masks` and fails).
`--remat {full,dots}` and `--scan_layers` reach the meant-family towers
(nn/stack.py); another `-mn` refuses them. `--mu_bf16` stores the first
Adam moment in bf16 (A1's bf16-m variant). Under `torchrun
--nproc_per_node N` it trains data parallel over the N ranks (each takes
its rows of every global batch of -tb rows); `--fsdp` also shards the
parameters and Adam moments over them (and runs at one rank without
torchrun); rank 0 prints and saves.
The run trains on the card unless --device names another device, saves the
checkpoint after training and evaluates the test split.
"""

from __future__ import annotations

import time

import torch

from meant_tpu_torch.cli.common import (base_parser, build_model,
                                        cli_mesh, dataset_arrays)
from meant_tpu_torch.data.datasets import split_arrays
from meant_tpu_torch.data.loader import ArrayLoader, BucketedLoader
from meant_tpu_torch.train import checkpoint as ckpt
from meant_tpu_torch.train.classify import meant_trainer
from meant_tpu_torch.utils.hf_cache import hf_graft


def train_loader(args, train: dict):
    """The training batches: with --buckets a shuffled `BucketedLoader`
    (meant_tpu/cli/in_loop_train.py:49-59), else a shuffled
    `ArrayLoader`."""
    if not args.buckets:
        return ArrayLoader(train, args.train_batch_size, shuffle=True)
    seq_keys, length_key = ("tweets", "input_ids", "attention_masks"), \
        "attention_masks"
    if "attention_mask" in train:              # the kwargs family's set
        seq_keys, length_key = seq_keys + ("attention_mask",), \
            "attention_mask"
    return BucketedLoader(train, args.train_batch_size,
                          buckets=tuple(int(x)
                                        for x in args.buckets.split(",")),
                          shuffle=True, seq_keys=seq_keys,
                          length_key=length_key)


def prepare(argv=None) -> meant_trainer:
    """The CLI's trainer, its model built and, with `--hf_cache` and
    `-p true -ptm PATH`, the cache's weights and then the checkpoint's
    towers and embedding grafted in as its `init_params` (loaded when
    training starts)."""
    args = base_parser().parse_args(argv)
    if args.image_only and args.language_only:
        raise AssertionError(
            "Cannot be an image only AND a language only task")
    mesh = cli_mesh(args)
    model = build_model(args)
    train, val, test = split_arrays(dataset_arrays(args))
    bs = args.train_batch_size
    trainer = meant_trainer({
        "model": model, "model_name": args.model_name,
        "dataset": args.dataset,
        "train_loader": train_loader(args, train),
        "val_loader": ArrayLoader(val, bs, drop_remainder=False),
        "test_loader": ArrayLoader(test, bs, drop_remainder=False),
        "epochs": args.num_epochs, "epoch": args.epoch,
        "num_classes": args.num_classes, "lag": args.lag,
        "file_path": args.file_path, "run_id": args.run_id,
        "num_encoders": args.num_encoders,
        "optimizer": args.optimizer, "lr": args.learning_rate,
        "decay": args.decay, "beta_1": args.beta_1, "beta_2": args.beta_2,
        "lrst": args.learning_rate_scheduler_type, "t0": args.t0,
        "tmax": args.tmax, "early_stopping": args.early_stopping,
        "test_model": args.test_model, "seed": args.seed,
        "mu_dtype": torch.bfloat16 if args.mu_bf16 else None,
        "mesh": mesh, "fsdp": args.fsdp,
    })
    if args.hf_cache:
        # the reference's from_pretrained init, from a local cache
        sd = model.state_dict()
        trainer.init_params = {**sd, **hf_graft(
            args.model_name, sd, args.num_encoders, args.num_heads,
            cache_dir=args.hf_cache)}
        print(f"initialized {args.model_name} from local HF cache "
              f"{args.hf_cache}")
    if args.pretrained and args.pretrained_model:
        restored = ckpt.restore(args.pretrained_model, trainer.device)
        trainer.init_params = ckpt.graft(
            trainer.init_params or model.state_dict(), restored["params"])
    return trainer


def main(argv=None) -> dict:
    """Train as the CLI does; returns the trainer's results (history,
    checkpoint path, test metrics) with the trainer under "trainer"."""
    t0 = time.time()
    trainer = prepare(argv)
    results = trainer.train()
    print("total time:", time.time() - t0)
    results["trainer"] = trainer
    return results


if __name__ == "__main__":
    main()
