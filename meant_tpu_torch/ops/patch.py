"""Image patchification (counterpart of meant_tpu/ops/patch.py):
'b c (h p1) (w p2) -> b (h w) (p1 p2 c)', channel fastest."""

from __future__ import annotations

import torch


def patchify(images: torch.Tensor, patch_res: int) -> torch.Tensor:
    """(b, c, H, W) -> (b, (H/p)*(W/p), p*p*c), feature order (p1, p2, c)."""
    b, c, H, W = images.shape
    p = patch_res
    h, w = H // p, W // p
    x = images.reshape(b, c, h, p, w, p).permute(0, 2, 4, 3, 5, 1)
    return x.reshape(b, h * w, p * p * c)
