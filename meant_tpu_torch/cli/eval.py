"""Standalone evaluation harness (counterpart of meant_tpu/cli/eval.py):
load a checkpoint of the port's trainer, run the test split, print the F1
metrics.

    python -m meant_tpu_torch.cli.eval -rid <id> [-mn meant] \
        -ptm <checkpoint path> [the data flags of in_loop_train]
"""

from __future__ import annotations

from meant_tpu_torch.cli.common import (base_parser, build_model,
                                        dataset_arrays)
from meant_tpu_torch.data.datasets import split_arrays
from meant_tpu_torch.data.loader import ArrayLoader
from meant_tpu_torch.train.classify import meant_trainer


def main(argv=None) -> dict:
    args = base_parser().parse_args(argv)
    model = build_model(args)
    _, _, test = split_arrays(dataset_arrays(args))
    loader = ArrayLoader(test, args.train_batch_size, drop_remainder=False)
    trainer = meant_trainer({
        "model": model, "model_name": args.model_name,
        "dataset": args.dataset, "train_loader": loader,
        "num_classes": args.num_classes, "lag": args.lag,
        "file_path": args.file_path, "run_id": args.run_id,
        "num_encoders": args.num_encoders,
    })
    if args.pretrained_model:
        trainer.load_params(args.pretrained_model)
    _, _, metrics = trainer.evaluate(loader, "test")
    return metrics


if __name__ == "__main__":
    main()
