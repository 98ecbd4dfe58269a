"""Config-driven HF fine-tune harness (counterpart of
meant_tpu/cli/hug_train.py), with the same flag names.

    python -m meant_tpu_torch.cli.hug_train -rid 0 [-mn roberta_tweet] \
        [-nc 15] [-t token_classification|classification] \
        [--pretrained true [-cl DIR]] [--config_json PATH] [--device cpu]

`-mn NAME` reads `configs/NAME.json` (the package's copy of the JAX
package's configs; `--config_json` names another file) and builds the
model at its width, depth, heads, vocabulary and dropout. `-nc` always
sizes the head (a warning says when the config's `num_labels` differs).

* `token_classification` (the default): a `TokenClassifier` trained by
  `ner_trainer` on `in_loop_genia`'s data, split in contiguous slices,
  with the test set's token metrics; the checkpoint lands under
  `{file_path}/models/<NAME>/`. `--pretrained true` grafts the backbone of
  a torch state dict `<-cl or ~/.cache/meant_tpu/hf>/<NAME>.bin` (or
  `.pt`) whose keys carry the `roberta.` prefix; with no such file it
  prints "no local HF cache (...); training from scratch" and trains on, as
  the JAX harness does. Any other failure raises (a position table of
  other than 130 rows, for one: the backbone's table has 130 rows
  whatever the config says).
* `classification`: `bertweet_wrapper` trained by
  `text_classifier_trainer` (cross entropy) on `text_labels.json` in
  --data_dir ([{"text": ..., "label": int}, ...]) or a synthetic set.

The run trains on the card unless --device names another device.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from meant_tpu_torch.cli.common import (base_parser, load_config,
                                        reject_stack_flags,
                                        split_train_val_test)
from meant_tpu_torch.cli.in_loop_genia import (finish, load_data,
                                               optimizer_keys)
from meant_tpu_torch.data.loader import ArrayLoader
from meant_tpu_torch.native import fnv1a_tokenize
from meant_tpu_torch.train.ner import TokenClassifier, ner_trainer
from meant_tpu_torch.utils.port import import_hf_roberta
from meant_tpu_torch.weights import state_dict_from_jax


def hug_parser():
    p = base_parser()
    p.add_argument("-js", "--join_size", type=int, default=1,
                   help="Number of sentences to join together in each "
                        "training example")
    p.add_argument("-m", "--metric", type=str, default=None,
                   help="Evaluation metric")
    p.add_argument("--config_json", type=str, default=None,
                   help="explicit config path (overrides "
                        "configs/<model_name>.json)")
    p.set_defaults(task="token_classification", num_classes=9,
                   model_name="bert_ner")
    return p


def _load_cfg(args) -> dict:
    if args.config_json:
        with open(args.config_json) as f:
            return json.load(f)
    return load_config(args.model_name)


def build_from_config(args):
    """(TokenClassifier at the config's geometry, the config, the head's
    label count). The head has --num_classes labels (the reference
    replaces the config's head, `in_loop_train.py:384`); a config whose
    num_labels differs gets a warning."""
    cfg = _load_cfg(args)
    num_labels = args.num_classes or cfg.get("num_labels", 2)
    cfg_labels = cfg.get("num_labels")
    if cfg_labels is not None and cfg_labels != num_labels:
        print(f"WARNING: config declares num_labels={cfg_labels} but the "
              f"head is built with --num_classes={num_labels} (the "
              f"reference's classifier overwrite, in_loop_train.py:384). "
              f"Pass --num_classes {cfg_labels} to match the config.")
    model = TokenClassifier(
        num_labels=num_labels, vocab_size=cfg["vocab_size"],
        hidden_size=cfg["hidden_size"], num_layers=cfg["num_hidden_layers"],
        num_heads=cfg["num_attention_heads"],
        dropout=cfg.get("hidden_dropout_prob", 0.1),
        dtype=torch.bfloat16 if args.bf16 else None, device=args.device,
        seed=args.seed)
    return model, cfg, num_labels


def _local_hf_backbone(args, cfg) -> dict:
    """The backbone entries (`roberta.`, the port's keys) of the torch
    state dict `<cache>/<model_name>.bin` (or `.pt`); the head keeps its
    fresh init. A pooler in the file is left out: the model has none (JAX
    carries it unused). Raises FileNotFoundError when neither file
    exists."""
    cache = args.cache_location or os.path.join(
        os.path.expanduser("~"), ".cache", "meant_tpu", "hf")
    for ext in (".bin", ".pt"):
        path = os.path.join(cache, args.model_name + ext)
        if os.path.exists(path):
            sd = torch.load(path, map_location="cpu", weights_only=True)
            tree = import_hf_roberta(sd, cfg["num_hidden_layers"],
                                     num_heads=cfg["num_attention_heads"])
            tree.pop("pooler", None)
            return state_dict_from_jax({"roberta": tree})
    raise FileNotFoundError(f"no {args.model_name}.bin/.pt under {cache}")


def load_sequence_data(args) -> dict:
    """Sequence-classification data: text_labels.json under --data_dir,
    else synthetic texts."""
    if args.data_dir:
        with open(os.path.join(args.data_dir, "text_labels.json")) as f:
            rows = json.load(f)
        texts = [r["text"] for r in rows]
        labels = [int(r["label"]) for r in rows]
    else:
        print("No --data_dir: synthetic text-classification data "
              "(smoke mode).")
        rng = np.random.RandomState(0)
        texts = [" ".join(f"w{rng.randint(200)}"
                          for _ in range(rng.randint(4, 12)))
                 for _ in range(args.synthetic_n)]
        labels = [int(rng.randint(args.num_classes))
                  for _ in range(args.synthetic_n)]
    ids, mask = fnv1a_tokenize(texts, args.seq_len, args.vocab_size)
    return {"input_ids": ids, "attention_mask": mask.astype(np.float32),
            "y": np.asarray(labels, np.int32)}


def prepare(argv=None) -> tuple:
    """(args, trainer, the test loader or None for `classification`, the
    label count), the model built and, with --pretrained, the cached
    backbone set as the trainer's `init_params` (loaded when training
    starts)."""
    args = hug_parser().parse_args(argv)
    reject_stack_flags(args, "hug_train")
    bs = args.train_batch_size
    eval_bs = max(args.eval_batch_size, bs)
    if args.task == "token_classification":
        model, cfg, num_labels = build_from_config(args)
        args.vocab_size = cfg["vocab_size"]     # the ids must fit the table
        train, val, test = split_train_val_test(load_data(args))
        params = None
        if args.pretrained:
            try:
                params = _local_hf_backbone(args, cfg)
                print(f"grafted local HF cache weights for "
                      f"{args.model_name}")
            except FileNotFoundError as e:
                print(f"no local HF cache ({e}); training from scratch")
        trainer = ner_trainer({
            "model": model, "model_name": args.model_name,
            "dataset": args.hugging_face_data or "local",
            "train_data": ArrayLoader(train, bs, shuffle=True),
            "val_data": ArrayLoader(val, eval_bs),
            **optimizer_keys(args),
            "num_encoders": cfg["num_hidden_layers"],
            "init_params": params})
        return args, trainer, ArrayLoader(test, eval_bs), num_labels
    if args.task == "classification":
        from meant_tpu_torch.models import bertweet_wrapper
        from meant_tpu_torch.train.text_classify import (
            text_classifier_trainer)
        cfg = _load_cfg(args)
        args.vocab_size = cfg["vocab_size"]
        data = load_sequence_data(args)
        n_val = max(len(data["y"]) // 10, 1)
        train = {k: v[n_val:] for k, v in data.items()}
        model = bertweet_wrapper(
            input_dim=cfg["hidden_size"], output_dim=args.num_classes,
            vocab_size=cfg["vocab_size"],
            num_layers=cfg["num_hidden_layers"],
            num_heads=cfg["num_attention_heads"],
            dtype=torch.bfloat16 if args.bf16 else None,
            device=args.device, seed=args.seed)
        trainer = text_classifier_trainer({
            "model": model,
            "train_loader": ArrayLoader(train, bs, shuffle=True),
            "num_classes": args.num_classes, "epochs": args.num_epochs,
            "lr": args.learning_rate, "decay": args.decay,
            "lrst": args.learning_rate_scheduler_type,
            "optimizer": args.optimizer, "loss": "Cross Entropy"})
        return args, trainer, None, args.num_classes
    raise ValueError(f"unsupported task {args.task}")


def main(argv=None) -> dict:
    """Train as the CLI does; returns the history, the test token metrics
    (None for `classification`), the checkpoint path and the trainer."""
    _, trainer, test_loader, num_labels = prepare(argv)
    if test_loader is None:
        return {"history": trainer.train(), "metrics": None,
                "checkpoint": None, "trainer": trainer}
    return finish(trainer, test_loader, num_labels)


if __name__ == "__main__":
    main()
