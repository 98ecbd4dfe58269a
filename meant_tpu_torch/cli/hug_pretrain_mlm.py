"""hug-suite MLM pretraining (counterpart of
meant_tpu/cli/hug_pretrain_mlm.py), with the same flag names.

    python -m meant_tpu_torch.cli.hug_pretrain_mlm -rid 0 [--data_dir DIR] \
        [-b 16] [--fixed_loss] [--device cpu]

The texts, ids and masking are `cli.pretrain_mlm`'s (`load_text`,
`mlm_arrays`); the first max(n // 10, 1) rows validate. The model is
`hug_roberta_mlm_wrapper` (one scalar a token), trained by
`hug_mlm_pretrainer` with the reference's loss: a soft-target cross entropy
over the SEQUENCE axis with the raw masked-label ids (-100 included) as the
"distribution" (`src/hug/pretrain_mlm.py:185,206`). `--fixed_loss` takes
the squared error against the label ids on the masked positions instead.
The checkpoint lands under `{file_path}/models/roberta_mlm/`. The run trains
on the card unless --device names another device.
"""

from __future__ import annotations

import torch

from meant_tpu_torch.cli.common import (base_parser, reject_stack_flags,
                                        str2bool)
from meant_tpu_torch.cli.pretrain_mlm import load_text, mlm_arrays
from meant_tpu_torch.data.loader import ArrayLoader
from meant_tpu_torch.nn.roberta import hug_roberta_mlm_wrapper
from meant_tpu_torch.train.pretrain import _BasePretrainer


def hug_parser():
    p = base_parser()
    p.add_argument("-b", "--batch_size", type=int, default=16)
    p.add_argument("-dn", "--dataset_name", type=str, default="stmhd")
    p.add_argument("--fixed_loss", type=str2bool, nargs="?", const=True,
                   default=False,
                   help="masked-position MSE instead of the reference's "
                        "soft-target sequence-axis CE")
    p.set_defaults(model_name="roberta_mlm")
    return p


class hug_mlm_pretrainer(_BasePretrainer):
    """Adds `fixed_loss` to the pretrainer's keys; batches hold input_ids,
    attention_mask and labels (-100 where unmasked)."""

    kind = "hug_mlm"

    def __init__(self, p):
        super().__init__(p)
        self.fixed_loss = p.get("fixed_loss", False)

    def _apply(self, batch):
        return self.model(batch["input_ids"], batch["attention_mask"])

    def _loss(self, out, batch):
        target = batch["labels"].to(torch.float32)
        out = out.to(torch.float32)
        if self.fixed_loss:
            valid = (batch["labels"] != -100).to(torch.float32)
            err = (out - target) ** 2 * valid
            return err.sum() / torch.clamp(valid.sum(), min=1.0)
        logp = torch.log_softmax(out, dim=-1)
        return (-(target * logp).sum(dim=-1)).mean()


def main(argv=None) -> dict:
    """Pretrain as the CLI does; returns the history, the checkpoint path
    and the trainer."""
    args = hug_parser().parse_args(argv)
    reject_stack_flags(args, "hug_pretrain_mlm")
    texts = load_text(args)
    data = mlm_arrays(texts, args)
    n_val = max(len(texts) // 10, 1)
    train = {k: v[n_val:] for k, v in data.items()}
    val = {k: v[:n_val] for k, v in data.items()}
    model = hug_roberta_mlm_wrapper(
        input_dim=args.text_dim, vocab_size=args.vocab_size,
        num_layers=args.num_encoders, num_heads=args.num_heads,
        dtype=torch.bfloat16 if args.bf16 else None, device=args.device,
        seed=args.seed)
    trainer = hug_mlm_pretrainer({
        "model": model, "model_name": args.model_name,
        "dataset": args.dataset_name, "fixed_loss": args.fixed_loss,
        "train_data": ArrayLoader(train, args.batch_size, shuffle=True),
        "val_data": ArrayLoader(val, args.batch_size),
        "epochs": args.num_epochs, "lr": args.learning_rate,
        "decay": args.decay, "beta_1": args.beta_1, "beta_2": args.beta_2,
        "lrst": args.learning_rate_scheduler_type, "t0": args.t0,
        "tmax": args.tmax, "optimizer": args.optimizer,
        "file_path": args.file_path, "run_id": args.run_id,
        "num_encoders": args.num_encoders})
    hist = trainer.train()
    return {"history": hist, "checkpoint": trainer.checkpoint,
            "trainer": trainer}


if __name__ == "__main__":
    main()
