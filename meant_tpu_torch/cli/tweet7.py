"""tweetner7 NER harness (counterpart of meant_tpu/cli/tweet7.py), with the
same flag names.

    python -m meant_tpu_torch.cli.tweet7 -rid 0 [--crf --impl_crf] \
        [-lrwp 0.1 -lrst linear_warmup] [-nc 15] [--device cpu]

The data and the split are `in_loop_genia`'s (15 tags by default). `--crf`
alone raises NotImplementedError, as the reference does; `--crf
--impl_crf` trains a `CRFTokenClassifier` and decodes the test set with
viterbi under the BIO constraint of `configs/roberta_tweet.json`'s
`id2label` when `-nc` is that tag set's 15, else unconstrained (with a
warning). `-lrwp` sets the per-step `linear_warmup` schedule's warm-up to
that share of the run's steps. The run trains on the card unless --device
names another device.
"""

from __future__ import annotations

import torch

from meant_tpu_torch.cli.common import (load_config, split_train_val_test,
                                        str2bool)
from meant_tpu_torch.cli.in_loop_genia import (finish, genia_parser,
                                               load_data, optimizer_keys,
                                               token_classifier)
from meant_tpu_torch.data.loader import ArrayLoader
from meant_tpu_torch.nn.crf import CRFTokenClassifier, bio_constraint_mask
from meant_tpu_torch.train.ner import ner_trainer


def tweet7_parser():
    p = genia_parser()
    p.add_argument("-crf", "--crf", type=str2bool, nargs="?", const=True,
                   default=False, help="Conditional Random Field?")
    p.add_argument("--impl_crf", type=str2bool, nargs="?", const=True,
                   default=False,
                   help="use the implemented CRF head instead of the "
                        "reference's NotImplementedError")
    p.add_argument("-lrwp", "--lr_warmup_step_ratio", type=float,
                   default=0.0,
                   help="Warmup ratio for our learning rate scheduler")
    # tweetner7's 15 BIO tags (configs/roberta_tweet.json id2label)
    p.set_defaults(model_name="bert_ner", dataset="tweet7", num_classes=15)
    return p


def main(argv=None) -> dict:
    """Train as the CLI does; returns the history, the test metrics, the
    checkpoint path and the trainer."""
    args = tweet7_parser().parse_args(argv)
    if args.crf and not args.impl_crf:
        raise NotImplementedError("Conditional random fields not implemented")
    train, val, test = split_train_val_test(load_data(args))
    bs = args.train_batch_size
    total_steps = max(len(train["labels"]) // bs, 1) * args.num_epochs
    crf = args.crf and args.impl_crf
    constraint = None
    if crf:
        model = CRFTokenClassifier(
            num_labels=args.num_classes, vocab_size=args.vocab_size,
            hidden_size=args.text_dim, num_layers=args.num_encoders,
            num_heads=args.num_heads, dropout=args.dropout,
            dtype=torch.bfloat16 if args.bf16 else None,
            device=args.device, seed=args.seed)
        id2label = {int(k): v for k, v in
                    load_config("roberta_tweet")["id2label"].items()}
        if args.num_classes == len(id2label):
            constraint = bio_constraint_mask(id2label)
        else:
            print(f"WARNING: --num_classes {args.num_classes} does not "
                  f"match the tweetner7 tag set ({len(id2label)} BIO tags), "
                  f"so the CRF runs WITHOUT the BIO transition constraint; "
                  f"viterbi may emit invalid O -> I-X sequences. Pass "
                  f"-nc {len(id2label)} for constrained decoding.")
    else:
        model = token_classifier(args)
    trainer = ner_trainer({
        "crf": crf, "constraint_mask": constraint,
        "model": model, "model_name": args.model_name, "dataset": "tweet7",
        "train_data": ArrayLoader(train, bs, shuffle=True),
        "val_data": ArrayLoader(val, max(args.eval_batch_size, bs)),
        "warmup_steps": int(total_steps * args.lr_warmup_step_ratio),
        "total_steps": total_steps, **optimizer_keys(args)})
    return finish(trainer, ArrayLoader(test, max(args.eval_batch_size, bs)),
                  args.num_classes)


if __name__ == "__main__":
    main()
