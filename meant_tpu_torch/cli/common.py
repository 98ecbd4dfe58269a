"""Shared CLI plumbing (counterpart of meant_tpu/cli/common.py): the flags
that serving reads, under the JAX package's names, and `build_model` for
the ported models (`meant_src` only so far)."""

from __future__ import annotations

import argparse

import torch

from meant_tpu_torch.device import resolve_device


def str2bool(v):
    if isinstance(v, bool):
        return v
    if v.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if v.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError("Boolean value expected.")


def base_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("-mn", "--model_name", type=str, default="meant")
    p.add_argument("-nc", "--num_classes", type=int, default=2)
    p.add_argument("-nec", "--num_encoders", type=int, default=12)
    p.add_argument("-rid", "--run_id", type=str, required=True)
    p.add_argument("-lag", "--lag", type=int, default=5)
    p.add_argument("--bf16", type=str2bool, nargs="?", const=True,
                   default=True, help="bf16 activations (fp32 params)")
    p.add_argument("--flash", type=str, nargs="?", const="auto",
                   default="auto",
                   help="flash-attention kernel: true/false/auto (auto = on "
                        "for seq_len >= 256)")
    p.add_argument("--synthetic_n", type=int, default=64,
                   help="synthetic sample count when no input is given")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the random init")
    p.add_argument("--logits_head", type=str2bool, nargs="?", const=True,
                   default=False,
                   help="classifier emits logits instead of sigmoid outputs")
    p.add_argument("--scan_layers", type=str2bool, nargs="?", const=True,
                   default=False, help="not ported yet: raises if set")
    p.add_argument("--remat", nargs="?", const="full", default=False,
                   choices=["full", "dots"],
                   help="not ported yet: raises if set")
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


def build_model(args, device=None):
    """The ported models by the reference's --model_name values, built on
    `device` (args.device, else the card)."""
    from meant_tpu_torch.models import EmbeddingConfig, meant_src

    name = args.model_name
    if name != "meant_src":
        raise NotImplementedError(
            f"model {name} is not yet ported to meant_tpu_torch "
            f"(see ROADMAP)")
    if getattr(args, "scan_layers", False) or getattr(args, "remat", False):
        raise NotImplementedError("--scan_layers/--remat are not ported yet "
                                  "(see ROADMAP)")
    if isinstance(args.flash, str):
        if args.flash.lower() == "auto":
            args.flash = args.seq_len >= 256
        else:
            args.flash = args.flash.lower() in ("yes", "true", "t", "y", "1")
    device = resolve_device(device if device is not None
                            else getattr(args, "device", None))
    size = args.image_size
    return meant_src(
        args.text_dim, args.image_dim, 5, size, size, 16, args.lag,
        args.num_classes,
        embedding=EmbeddingConfig(vocab_size=args.vocab_size,
                                  hidden_size=args.text_dim),
        flash=args.flash, num_heads=args.num_heads,
        num_encoders=args.num_encoders, channels=3, seq_len=512,
        logits_head=bool(args.logits_head),
        dtype=torch.bfloat16 if args.bf16 else None, device=device,
        seed=args.seed)
