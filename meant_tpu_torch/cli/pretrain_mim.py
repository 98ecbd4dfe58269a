"""MIM pretraining harness (counterpart of meant_tpu/cli/pretrain_mim.py),
with the same flag names.

    python -m meant_tpu_torch.cli.pretrain_mim -rid 0 [--data_dir DIR] \
        [-nec 12] [-ne 10] [-tb 16] [--masked_only] [--device cpu]

Images: the first `.npy` stack (n, c, H, W) in --data_dir, or synthetic
4-channel images of --image_size when there is no --data_dir. A per-pixel
Bernoulli(0.15) mask (`mask_image`, seed 0), the same split as the MLM
harness, then `meant_vision_pretrainer` (patch 16, the images' channels
and size) trained by `mim_pretrainer` on the L1 of the RGB channels; the
checkpoint lands under `{file_path}/models/meant_vision_pretrainer/`.

As in the JAX harness, `--flash` is taken as given: any value but the empty
string, "false" and the default "auto" included, turns the flash path on
(ROADMAP §3, reference behaviour). `--remat` and `--scan_layers` reach the
tower, as in the JAX harness.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from meant_tpu_torch.cli.common import base_parser, cli_mesh
from meant_tpu_torch.cli.pretrain_mlm import split
from meant_tpu_torch.data.loader import ArrayLoader
from meant_tpu_torch.data.masking import mask_image
from meant_tpu_torch.models import meant_vision_pretrainer
from meant_tpu_torch.train.pretrain import mim_pretrainer

MODEL_NAME = "meant_vision_pretrainer"


def parser():
    p = base_parser()
    p.add_argument("--masked_only", action="store_true",
                   help="DEFECTS #30 repair: L1 on the MASKED pixels only. "
                        "The default is the reference's nn.L1Loss over "
                        "labels that still carry -100 at unmasked pixels")
    return p


def load_images(args) -> np.ndarray:
    if args.data_dir:
        for name in os.listdir(args.data_dir):
            if name.endswith(".npy"):
                return np.load(os.path.join(args.data_dir, name))
        raise FileNotFoundError(f"no .npy in {args.data_dir}")
    print("No --data_dir: synthetic images (smoke mode).")
    rng = np.random.RandomState(0)
    return rng.rand(args.synthetic_n, 4, args.image_size,
                    args.image_size).astype(np.float32)


def build_model(args, images_shape: tuple) -> meant_vision_pretrainer:
    """The harness's model for images of `images_shape` (n, c, H, W) on
    args.device (the card unless named)."""
    _, channels, height, width = images_shape
    return meant_vision_pretrainer(
        num_encoders=args.num_encoders, patch_res=16, channels=channels,
        height=height, width=width, image_dim=args.image_dim,
        num_heads=args.num_heads, flash=bool(args.flash),
        scan_layers=bool(args.scan_layers), remat=args.remat,
        dtype=torch.bfloat16 if args.bf16 else None, device=args.device,
        seed=args.seed)


def main(argv=None) -> dict:
    """Pretrain as the CLI does; returns the history, the checkpoint path
    and the trainer."""
    args = parser().parse_args(argv)
    images = load_images(args)
    inputs, labels = mask_image(images, seed=0)
    mesh = cli_mesh(args)
    model = build_model(args, images.shape)
    train, val = split({"input_ids": inputs, "labels": labels},
                       args.train_batch_size)
    trainer = mim_pretrainer({
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
        "masked_only": args.masked_only,
    })
    t0 = time.time()
    hist = trainer.train()
    print("total time:", time.time() - t0)
    return {"history": hist, "checkpoint": trainer.checkpoint,
            "trainer": trainer}


if __name__ == "__main__":
    main()
