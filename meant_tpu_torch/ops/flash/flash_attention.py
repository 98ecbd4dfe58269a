"""Flash attention dispatch (counterpart of
meant_tpu/ops/flash/flash_attention.py): builds the fused rotation tables
from a module's frequency buffer (once per sequence length when the module
passes its cache) and calls `flash_mha`."""

from __future__ import annotations

from typing import Optional

import torch

from meant_tpu_torch.ops.flash.kernel import flash_mha
from meant_tpu_torch.ops.rotary import rope_angles, xpos_scale


def _tables(seq_len: int, d_head: int, freqs: torch.Tensor, xpos: bool,
            scale_base: float):
    """(s, d) fp32 qcos/qsin/kcos/ksin: rotary angles on the leading
    rot_dim features with the xPos q-scale and 1/k-scale folded in, and the
    identity (cos=1, sin=0) on the pass-through tail."""
    positions = torch.arange(seq_len, device=freqs.device)
    angles = rope_angles(positions, freqs)
    rot_dim = angles.shape[-1]
    cos, sin = torch.cos(angles), torch.sin(angles)
    if xpos:
        scale = xpos_scale(rot_dim, positions, scale_base)
        q_cos, q_sin = cos * scale, sin * scale
        k_cos, k_sin = cos / scale, sin / scale
    else:
        q_cos = k_cos = cos
        q_sin = k_sin = sin
    tail = (seq_len, d_head - rot_dim)
    pad_c = torch.ones(tail, dtype=torch.float32, device=freqs.device)
    pad_s = torch.zeros(tail, dtype=torch.float32, device=freqs.device)
    return (torch.cat([q_cos, pad_c], -1), torch.cat([q_sin, pad_s], -1),
            torch.cat([k_cos, pad_c], -1), torch.cat([k_sin, pad_s], -1))


def flash_attention(q, k, v, *, scale: float, causal: bool = False,
                    attention_mask: Optional[torch.Tensor] = None,
                    rope_freqs: Optional[torch.Tensor] = None,
                    xpos: bool = False, xpos_scale_base: float = 512.0,
                    tables_cache: Optional[dict] = None):
    """q, k, v: (b, h, s, d). Rotary (plain or xPos) fused into the kernel's
    Q/K load. attention_mask: (b, s) of {0, 1}. tables_cache: a dict owned
    by the caller, which empties it when rope_freqs changes; the tables are
    then built once per (s, d, device) instead of on every call."""
    tables = (None,) * 4
    if rope_freqs is not None:
        s, d = q.shape[2], q.shape[-1]
        key = (s, d, rope_freqs.device)
        cached = None if tables_cache is None else tables_cache.get(key)
        if cached is None:
            # plain tensors even under inference_mode, so a cached table
            # may later meet autograd
            with torch.inference_mode(False):
                cached = _tables(s, d, rope_freqs, xpos, xpos_scale_base)
            if tables_cache is not None:
                tables_cache[key] = cached
        tables = cached
    qcos, qsin, kcos, ksin = tables
    return flash_mha(q, k, v, scale=scale, causal=causal,
                     attention_mask=attention_mask, qcos=qcos, qsin=qsin,
                     kcos=kcos, ksin=ksin)
