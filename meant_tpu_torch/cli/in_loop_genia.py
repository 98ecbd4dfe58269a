"""GENIA / JNLPBA NER harness (counterpart of meant_tpu/cli/in_loop_genia.py),
with the same flag names.

    python -m meant_tpu_torch.cli.in_loop_genia -rid 0 [--data_dir DIR] \
        [-js 2] [-nec 12] [-tb 16] [-ne 10] [--device cpu]

Data: with --data_dir, `ner_prepared.npz` (input_ids, attention_mask,
labels) or else `ner_tokens.json` ([{"tokens": [...], "ner_tags": [...]},
...]); without it, a synthetic tagged set drawn from RandomState(0)
(`--synthetic_n` sentences of 4-9 words). Word lists are joined `-js` at a
time (`join_examples`), hashed one id a word between BOS and EOS
(`fnv1a_tokenize`) and labelled on the word positions (`align_labels`).
The set is split in contiguous slices (`split_train_val_test`). The model
is a `TokenClassifier` (9 tags by default) trained by `ner_trainer` (no
clipping); the run reports the test set's macro F1 over labelled tokens
and saves under `{file_path}/models/biobert/`. The run trains on the card
unless --device names another device.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from meant_tpu_torch.cli.common import (base_parser, reject_stack_flags,
                                        split_train_val_test)
from meant_tpu_torch.data.loader import ArrayLoader
from meant_tpu_torch.native import fnv1a_tokenize
from meant_tpu_torch.train.ner import (TokenClassifier, align_labels,
                                       join_examples, ner_trainer)


def genia_parser():
    p = base_parser()
    p.add_argument("-js", "--join_size", type=int, default=1,
                   help="Number of sentences to join together in each "
                        "training example")
    # the reference's defaults (`in_loop_genia.py:363`): 9 JNLPBA tags
    p.set_defaults(num_classes=9, model_name="biobert")
    return p


def _encode_word_level(tokens_list, tags_list, seq_len, vocab_size):
    """One id a word, framed [BOS, w_0..w_{k-1}, EOS, pad...]: word_ids is
    None at BOS, EOS and padding, so only the word positions carry a tag."""
    texts = [" ".join(t) for t in tokens_list]
    ids, enc_mask = fnv1a_tokenize(texts, seq_len, vocab_size)
    word_ids, labels = [], []
    for toks, tags in zip(tokens_list, tags_list):
        k = min(len(toks), seq_len - 2)
        word_ids.append([None] + list(range(k))
                        + [None] * (seq_len - 1 - k))
        labels.append(list(tags))
    return {"input_ids": ids, "labels": align_labels(word_ids, labels),
            "attention_mask": enc_mask.astype(np.float32)}


def load_data(args) -> dict:
    if args.data_dir:
        npz = os.path.join(args.data_dir, "ner_prepared.npz")
        if os.path.exists(npz):
            z = np.load(npz)
            return {k: z[k] for k in ("input_ids", "attention_mask",
                                      "labels")}
        with open(os.path.join(args.data_dir, "ner_tokens.json")) as f:
            rows = json.load(f)
        tokens = [r["tokens"] for r in rows]
        tags = [r.get("ner_tags", r.get("tags")) for r in rows]
        if args.join_size > 1:
            tokens, tags = join_examples(tokens, tags, args.join_size)
        return _encode_word_level(tokens, tags, args.seq_len,
                                  args.vocab_size)
    print("No --data_dir: synthetic GENIA-shaped NER data (smoke mode).")
    rng = np.random.RandomState(0)
    tokens = [[f"w{rng.randint(200)}" for _ in range(rng.randint(4, 10))]
              for _ in range(args.synthetic_n)]
    tags = [[int(rng.randint(args.num_classes)) for _ in t] for t in tokens]
    if args.join_size > 1:
        tokens, tags = join_examples(tokens, tags, args.join_size)
    return _encode_word_level(tokens, tags, args.seq_len, args.vocab_size)


def token_classifier(args) -> TokenClassifier:
    """The harnesses' TokenClassifier at the CLI's widths, on args.device
    (the card unless named)."""
    return TokenClassifier(
        num_labels=args.num_classes, vocab_size=args.vocab_size,
        hidden_size=args.text_dim, num_layers=args.num_encoders,
        num_heads=args.num_heads, dropout=args.dropout,
        dtype=torch.bfloat16 if args.bf16 else None, device=args.device,
        seed=args.seed)


def optimizer_keys(args) -> dict:
    """The trainer's optimizer and run keys the NER harnesses pass."""
    return {"epochs": args.num_epochs, "lr": args.learning_rate,
            "decay": args.decay, "beta_1": args.beta_1,
            "beta_2": args.beta_2,
            "lrst": args.learning_rate_scheduler_type, "t0": args.t0,
            "tmax": args.tmax, "optimizer": args.optimizer,
            "file_path": args.file_path, "run_id": args.run_id,
            "num_encoders": args.num_encoders}


def finish(trainer, test_loader, num_labels: int) -> dict:
    """Train, then the token metrics of `test_loader`; the results dict
    the NER harnesses return."""
    hist = trainer.train()
    metrics = trainer.token_f1(test_loader, num_labels)
    print("Macro test f1:", metrics["f1_macro"])
    return {"history": hist, "metrics": metrics,
            "checkpoint": trainer.checkpoint, "trainer": trainer}


def main(argv=None) -> dict:
    """Train as the CLI does; returns the history, the test metrics, the
    checkpoint path and the trainer."""
    args = genia_parser().parse_args(argv)
    reject_stack_flags(args, "in_loop_genia")
    train, val, test = split_train_val_test(load_data(args))
    bs = args.train_batch_size
    trainer = ner_trainer({
        "model": token_classifier(args), "model_name": args.model_name,
        "dataset": "jnlpba",
        "train_data": ArrayLoader(train, bs, shuffle=True),
        "val_data": ArrayLoader(val, max(args.eval_batch_size, bs)),
        **optimizer_keys(args)})
    return finish(trainer, ArrayLoader(test, max(args.eval_batch_size, bs)),
                  args.num_classes)


if __name__ == "__main__":
    main()
