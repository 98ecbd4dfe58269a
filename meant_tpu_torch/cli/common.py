"""Shared CLI plumbing (counterpart of meant_tpu/cli/common.py): the
reference's flags under the JAX package's names, the refusal of flags not
ported yet, the CLI's data (`--data_dir` TempStock-small, else a synthetic
set of the model's family), and `build_model` for every --model_name of the
JAX CLI."""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from meant_tpu_torch import models
from meant_tpu_torch.data.datasets import (load_tempstock_small,
                                           synthetic_tempstock)
from meant_tpu_torch.device import resolve_device
from meant_tpu_torch.parallel.mesh import make_mesh, rank_zero
from meant_tpu_torch.train.classify import KWARGS_MODELS, POSITIONAL_MODELS


def str2bool(v):
    if isinstance(v, bool):
        return v
    if v.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if v.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError("Boolean value expected.")


def base_parser() -> argparse.ArgumentParser:
    """The reference's flag set under the JAX package's names
    (meant_tpu/cli/common.py), plus --device."""
    p = argparse.ArgumentParser()
    # learning-rate schedule and optimizer
    p.add_argument("-t0", "--t0", type=int, default=7)
    p.add_argument("-tm", "--tmax", type=int, default=10)
    p.add_argument("-lrst", "--learning_rate_scheduler_type", type=str,
                   default="cosine_warm")
    p.add_argument("-l", "--learning_rate", type=float, default=5e-5)
    p.add_argument("-o", "--optimizer", type=str, default="AdamW")
    p.add_argument("-d", "--decay", type=float, default=0.0)
    p.add_argument("-b1", "--beta_1", type=float, default=0.9)
    p.add_argument("-b2", "--beta_2", type=float, default=0.999)
    # training loop
    p.add_argument("-e", "--epoch", type=int, default=0)
    p.add_argument("-ne", "--num_epochs", type=int, default=10)
    p.add_argument("-es", "--early_stopping", type=str2bool, nargs="?",
                   const=False, default=False)
    p.add_argument("-s", "--stoppage", type=float, default=1e-4)
    p.add_argument("-tb", "--train_batch_size", type=int, default=16)
    p.add_argument("-eb", "--eval_batch_size", type=int, default=1)
    p.add_argument("-tesb", "--test_batch_size", type=int, default=1)
    p.add_argument("-testm", "--test_model", type=str2bool, nargs="?",
                   const=True, default=True)
    # model
    p.add_argument("-mn", "--model_name", type=str, default="meant")
    p.add_argument("-nc", "--num_classes", type=int, default=2)
    p.add_argument("-t", "--task", type=str, default="classification")
    p.add_argument("-cl", "--cache_location", type=str)
    p.add_argument("-di", "--dimension", type=int, default=128)
    p.add_argument("-nl", "--num_layers", type=int, default=3)
    p.add_argument("-do", "--dropout", type=float, default=0.0)
    p.add_argument("-ptm", "--pretrained_model", type=str, default=None)
    p.add_argument("-p", "--pretrained", type=str2bool, nargs="?",
                   const=False, default=False,
                   help="with -ptm: graft the encoder towers and embedding "
                        "of that pretraining checkpoint into the model")
    p.add_argument("-nec", "--num_encoders", type=int, default=12)
    p.add_argument("-img", "--image_only", type=str2bool, nargs="?",
                   const=False, default=False)
    p.add_argument("-lang", "--language_only", type=str2bool, nargs="?",
                   const=False, default=False)
    p.add_argument("-hf", "--hugging_face_model", type=str2bool, nargs="?",
                   const=False, default=False)
    p.add_argument("-hfd", "--hugging_face_data", type=str, default=None)
    p.add_argument("-hft", "--hugging_face_tokenizer", type=str,
                   default=None)
    # miscellaneous
    p.add_argument("-db", "--debug", type=bool, default=False)
    p.add_argument("-fp", "--file_path", type=str, default=".")
    p.add_argument("-rid", "--run_id", type=str, required=True)
    p.add_argument("-lag", "--lag", type=int, default=5)
    p.add_argument("-norm", "--normalize", type=str2bool, nargs="?",
                   const=False, default=False)
    p.add_argument("-ds", "--dataset", type=str, default="Tempstock")
    p.add_argument("--data_dir", type=str, default=None,
                   help="directory with the TempStock-small .npy arrays; "
                        "synthetic data when omitted")
    p.add_argument("--bf16", type=str2bool, nargs="?", const=True,
                   default=True, help="bf16 activations (fp32 params)")
    p.add_argument("--flash", type=str, nargs="?", const="auto",
                   default="auto",
                   help="flash-attention kernels: true/false/auto (auto = "
                        "on for seq_len >= 256)")
    p.add_argument("--track", type=str2bool, nargs="?", const=False,
                   default=False)
    p.add_argument("--synthetic_n", type=int, default=64,
                   help="synthetic sample count when no data is given")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the random init and of dropout")
    p.add_argument("--logits_head", type=str2bool, nargs="?", const=True,
                   default=False,
                   help="classifier emits logits instead of sigmoid outputs")
    p.add_argument("--buckets", type=str, default=None,
                   help="comma-separated length buckets for bucketed "
                        "training batches (e.g. 128,256,384,512) — the "
                        "static-shape equivalent of dynamic padding")
    p.add_argument("--hf_cache", type=str, default=None,
                   help="local HuggingFace cache (hub layout or snapshot "
                        "directory): initialise from its weights as the "
                        "reference's from_pretrained flow does "
                        "(utils/hf_cache.hf_graft); nothing is downloaded, "
                        "and a missing cache raises")
    p.add_argument("--fsdp", type=str2bool, nargs="?", const=True,
                   default=False,
                   help="shard the parameters and Adam moments over the "
                        "data axis (ZeRO over the optimizer's flat "
                        "buffers; the classification trainer)")
    p.add_argument("--mu_bf16", type=str2bool, nargs="?", const=True,
                   default=False,
                   help="store the first Adam moment in bf16 (the trainer's "
                        "optimizer; the other CLIs take and ignore it)")
    p.add_argument("--scan_layers", type=str2bool, nargs="?", const=True,
                   default=False,
                   help="the JAX package's scanned towers (nn/stack.py): "
                        "one module per block, rematerialised with 'dots' "
                        "unless --remat says otherwise (meant-family "
                        "towers)")
    p.add_argument("--remat", nargs="?", const="full", default=False,
                   choices=["full", "dots"],
                   help="rematerialise encoder blocks in training: bare "
                        "--remat = 'full' (save nothing), '--remat dots' = "
                        "selective (matrix-product outputs saved; "
                        "nn/stack.py)")
    p.add_argument("--full_mlm_head", action="store_true",
                   help="MLM harness: compute the head over all (b, s) "
                        "positions instead of the gathered masked ones")
    p.add_argument("--seq_len", type=int, default=128)
    p.add_argument("--image_size", type=int, default=224)
    p.add_argument("--text_dim", type=int, default=768)
    p.add_argument("--image_dim", type=int, default=768)
    p.add_argument("--vocab_size", type=int, default=64001)
    p.add_argument("--num_heads", type=int, default=8)
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the CUDA card; 'cpu' runs "
                        "the plain PyTorch path)")
    return p


# the models that take --scan_layers / --remat
# (meant_tpu/cli/common.py:221-230)
SCAN_MODELS = ("meant", "meant_src", "meant_vision", "meant_tweet",
               "meant_tweet_no_lag", "meantPrice", "meant_vqa",
               "meant_timesformer", "meant_mean_pooling", "meant_mosi")


def cli_mesh(args):
    """The mesh a training CLI runs on: the world's data-parallel mesh
    under torchrun (WORLD_SIZE set) or with --fsdp, else None (one
    process, no process group). Ranks other than 0 print nothing (their
    standard output is discarded); rank 0 prints and saves. Call it
    before building the model: on the card it selects this rank's
    device."""
    if "WORLD_SIZE" not in os.environ and not getattr(args, "fsdp", False):
        return None
    mesh = make_mesh(device=getattr(args, "device", None))
    if not rank_zero():
        sys.stdout = open(os.devnull, "w")
    return mesh


def reject_stack_flags(args, harness: str) -> None:
    """--scan_layers / --remat reach meant-family towers only: a harness
    that builds an HF backbone refuses them rather than ignore them."""
    if getattr(args, "scan_layers", False) or getattr(args, "remat", False):
        raise SystemExit(f"--scan_layers/--remat are not supported by the "
                         f"{harness} harness (no meant-family towers)")


def split_train_val_test(data: dict):
    """(train, val, test) of a dict of arrays in contiguous slices, as the
    JAX package splits the NER sets: the first n // 10 rows (at least 1)
    validate, the next as many test, the rest train; on a set too small
    for three slices the val slice doubles as test."""
    n = len(next(iter(data.values())))
    n_val = max(n // 10, 1)
    n_test = n_val if n > 2 * n_val else 0
    val = {k: v[:n_val] for k, v in data.items()}
    test = ({k: v[n_val:n_val + n_test] for k, v in data.items()}
            if n_test else val)
    train = {k: v[n_val + n_test:] for k, v in data.items()}
    return train, val, test


def load_config(name: str) -> dict:
    """A model configuration of the package's `configs/<name>.json` (a
    copy of the JAX package's, the reference's `src/hug/configs`)."""
    path = os.path.join(os.path.dirname(__file__), "..", "configs",
                        f"{name}.json")
    with open(path) as f:
        return json.load(f)


# the positional --model_name values; train.classify.model_inputs refuses
# meant_vqa, which trains through its own harness (cli/vqa.py)
PAPER_MODELS = POSITIONAL_MODELS + ("meant_vqa",)
# the price-only models, which read `prices` alone
PRICE_MODELS = ("meant_price", "mlp", "lstm")
MOSI_FRAMES = 50


def synthetic_batch(args, n: int, seed: int = 0) -> dict:
    """A synthetic batch of the model's family, as the JAX serving CLI
    shapes one (meant_tpu/cli/serve.py:54-84), with random labels `y`:
    prices alone (width 5) for the price models; MOSI's 50 frames of
    pre-embedded text (text_dim floats), video (20) and audio (130) with
    an all-ones audio mask; input_ids / pixels / prices / attention_mask
    for the rest of the kwargs family; tweets / graphs (4 channels) /
    attention_masks for the positional models (the HF baselines included),
    with prices of width 4 for meantPrice and teanet and 5 for
    meant_tweet_price."""
    name = args.model_name
    rng = np.random.RandomState(seed)
    lag, s, size = args.lag, args.seq_len, args.image_size
    if name in PRICE_MODELS:
        batch = {"prices": rng.randn(n, lag, 5).astype(np.float32)}
    elif name == "meant_mosi":
        f = MOSI_FRAMES
        batch = {"input_ids": rng.randn(n, f, args.text_dim).astype(
                     np.float32),
                 "pixels": rng.randn(n, f, 20).astype(np.float32),
                 "audio": rng.randn(n, f, 130).astype(np.float32),
                 "audio_mask": np.ones((n, f), np.float32)}
    elif name in KWARGS_MODELS:
        ids = rng.randint(2, args.vocab_size - 1, size=(n, lag, s))
        batch = {"input_ids": ids.astype(np.int32),
                 "pixels": rng.randn(n, lag, 3, size, size).astype(
                     np.float32),
                 "prices": rng.randn(n, lag, 5).astype(np.float32),
                 "attention_mask": np.ones((n, lag, s), np.float32)}
    else:
        ids = rng.randint(2, args.vocab_size - 1, size=(n, lag, s))
        batch = {"tweets": ids.astype(np.int32),
                 "graphs": rng.randn(n, lag, 4, size, size).astype(
                     np.float32),
                 "attention_masks": np.ones((n, lag, s), np.float32)}
        if name in ("meantPrice", "meant_tweet_price", "teanet"):
            width = 5 if name == "meant_tweet_price" else 4
            batch["prices"] = rng.randn(n, lag, width).astype(np.float32)
    batch["y"] = rng.randint(0, args.num_classes, size=(n,)).astype(np.int32)
    return batch


def dataset_arrays(args) -> dict:
    """The CLI's data, as the JAX training CLI picks it
    (meant_tpu/cli/in_loop_train.py:33-43): with --data_dir the
    TempStock-small arrays, else `synthetic_tempstock` for the paper
    generation. The kwargs family (meant_src, the price models, the
    TimeSformer family) gets its synthetic serving set, as do
    meant_tweet_price and teanet without --data_dir: the JAX CLI hands
    every model `synthetic_tempstock`, which holds no array the kwargs
    family or meant_tweet_price reads, and fails in the forward.
    TempStock-small holds none either, so `--data_dir` is refused for the
    kwargs family; teanet reads its macds, and meant_tweet_price raises a
    KeyError for its prices, as meantPrice does."""
    if args.model_name in ("meant_tweet_price", "teanet") and \
            not args.data_dir:
        print("No --data_dir given: running on a synthetic set of "
              f"{args.model_name}'s inputs (smoke mode).")
        return synthetic_batch(args, args.synthetic_n)
    if args.model_name in KWARGS_MODELS:
        if args.data_dir:
            raise ValueError(
                f"--data_dir loads TempStock-small (tweets, graphs, "
                f"attention_masks, macds, y), which {args.model_name} does "
                f"not read (input_ids, pixels, prices, attention_mask)")
        print("No --data_dir given: running on a synthetic kwargs-family "
              "set (smoke mode).")
        return synthetic_batch(args, args.synthetic_n)
    if args.data_dir:
        return load_tempstock_small(args.data_dir,
                                    lag_suffix=f"_{args.lag}",
                                    normalize=args.normalize)
    print("No --data_dir given: running on synthetic TempStock-shaped data "
          "(smoke mode).")
    return synthetic_tempstock(n=args.synthetic_n, lag=args.lag,
                               seq=args.seq_len, channels=4,
                               size=args.image_size,
                               vocab=args.vocab_size - 1)


def build_model(args, device=None):
    """The models by the reference's --model_name values, built on
    `device` (args.device, else the card), with the JAX CLI's arguments
    (meant_tpu/cli/common.py:253-306), `--scan_layers` and `--remat`
    included. A name the JAX CLI does not build raises."""
    name = args.model_name
    scan_layers = bool(getattr(args, "scan_layers", False))
    remat = getattr(args, "remat", False)
    if (scan_layers or remat) and name not in SCAN_MODELS:
        # as the JAX CLI: refuse rather than ignore, so a run never claims
        # a configuration the model did not use
        raise SystemExit(f"--scan_layers/--remat are only supported by "
                         f"{'/'.join(SCAN_MODELS)} (got --model_name {name})")
    if name not in KWARGS_MODELS + PAPER_MODELS:
        raise NotImplementedError(f"model {name} is not supported")
    if isinstance(args.flash, str):
        if args.flash.lower() == "auto":
            args.flash = args.seq_len >= 256
        else:
            args.flash = args.flash.lower() in ("yes", "true", "t", "y", "1")
    device = resolve_device(device if device is not None
                            else getattr(args, "device", None))
    td, imd, size, lag, nc = (args.text_dim, args.image_dim, args.image_size,
                              args.lag, args.num_classes)
    emb = models.EmbeddingConfig(vocab_size=args.vocab_size, hidden_size=td)
    dtype = torch.bfloat16 if args.bf16 else None
    base = dict(device=device, seed=args.seed)
    common = dict(num_heads=args.num_heads, num_encoders=args.num_encoders,
                  dtype=dtype, scan_layers=scan_layers, remat=remat, **base)
    logits_head = bool(args.logits_head)
    if name == "meant":
        return models.meant(td, imd, 4, size, size, 16, lag, nc,
                            embedding=emb, flash=args.flash, channels=4,
                            logits_head=logits_head, **common)
    if name == "meant_src":
        return models.meant_src(td, imd, 5, size, size, 16, lag, nc,
                                embedding=emb, flash=args.flash, channels=3,
                                seq_len=512, logits_head=logits_head,
                                **common)
    if name == "meant_vision":
        return models.meant_vision(imd, 4, size, size, 16, lag, nc,
                                   flash=args.flash, channels=4, **common)
    if name == "meant_tweet":
        return models.meant_tweet(td, 4, lag, nc, embedding=emb,
                                  flash=args.flash, **common)
    if name == "meant_tweet_no_lag":
        return models.meant_tweet_no_lag(td, 4, size, size, 16, nc,
                                         embedding=emb, **common)
    if name == "meantPrice":
        return models.meantPrice(td, imd, 4, size, size, 16, lag, nc,
                                 embedding=emb, **common)
    if name == "meant_vqa":
        return models.meant_vqa(td, imd, 4, size, size, 16, 1, nc,
                                embedding=emb, flash=args.flash, **common)
    if name == "meant_tweet_price":
        return models.meantTweetPrice(
            td, 5, lag, nc, embedding=emb, flash=args.flash,
            num_heads=args.num_heads, num_encoders=args.num_encoders,
            dtype=dtype, **base)
    if name == "meant_price":
        # the reference's 8 heads: at price_dim 5 the head dim clamps to 1
        return models.meant_price(5, lag, nc, num_heads=8, dtype=dtype,
                                  **base)
    if name in ("meant_timesformer", "meant_mean_pooling"):
        cls = getattr(models, name)
        return cls(td, imd, 5, size, size, 16, lag, nc, embedding=emb,
                   flash=args.flash, channels=3, **common)
    if name == "meant_mosi":
        # as the JAX CLI builds it: --flash does not reach meant_mosi
        return models.meant_mosi(td, imd, lag=MOSI_FRAMES, num_classes=nc,
                                 embedding=None, **common)
    if name == "teanet":
        return models.teanet(dim=args.dimension, num_heads=4,
                             num_classes=nc, vocab_size=args.vocab_size,
                             price_dim=4, num_layers=args.num_layers,
                             dtype=dtype, **base)
    if name == "mlp":
        return models.mlpEncoder(5, nc, args.dimension, args.num_layers,
                                 **base)
    if name == "lstm":
        return models.LSTMEncoder(5, nc, args.dimension, args.num_layers,
                                  **base)
    hf = {"bertweet": models.bertweet_wrapper,
          "vl_bert": models.vl_BERT_Wrapper, "vilt": models.ViltWrapper}
    return hf[name](input_dim=td, output_dim=nc, vocab_size=args.vocab_size,
                    num_layers=args.num_encoders, num_heads=args.num_heads,
                    dtype=dtype, **base)
