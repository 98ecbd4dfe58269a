"""TimeSformer, divided space-time attention (counterpart of
meant_tpu/nn/timesformer.py).

Per layer: time attention (tokens grouped by patch across frames), then
space attention (grouped by frame across patches), then a GEGLU feed
forward, each behind a Flax LayerNorm with a residual. The cls token (index
0) attends over every token, and its key and value lead every time and
space group. q is scaled by dim_head^-0.5 before the product. Frames get 1-D
rotary and patches 2-D axial rotary in the (sin, cos) layout of
`ops.rotary.apply_rot_emb_sincos`, which the flash kernels' rotation pass
does not take, so the rotation stays plain PyTorch.

`flash=True` sends a group of FLASH_MIN_SEQ or more keys (the cls key
included) to flash attention, as the JAX package does: head dim 64 and one
more key than queries, a shape the port's kernels are not built for
(ROADMAP §2 item 3). On a CUDA tensor that branch raises; on the CPU it
runs the plain version of JAX's kernel. The CLI's geometries never reach
it: 224^2 charts make space groups of 197 keys and time groups of 6, MOSI
groups of 21 and 51.

`scan_layers` keeps one module per layer, as the towers do (nn/stack.py),
and rematerialises every layer ("dots" unless `remat` says otherwise), as
JAX's scanned body does; the unrolled layers are not rematerialised, as in
JAX. `weights.state_dict_from_jax` reads JAX's unrolled (`time_attn_{i}`,
...) and scanned (`layers_scan`) layouts into `layers.{i}`.
"""

from __future__ import annotations

from typing import Any, Optional

import torch
from torch import nn

from meant_tpu_torch import ops
from meant_tpu_torch.nn.layers import (Dense, FlaxLayerNorm, SeededInit,
                                       gelu, init_weights)
from meant_tpu_torch.nn.stack import remat_spec, run_block

FLASH_MIN_SEQ = 256


def _attn(q, k, v):
    """softmax(q k^T) v with q pre-scaled; fp32 sums, the weights rounded
    to v's dtype."""
    f32 = torch.float32
    sim = torch.matmul(q.to(f32), k.to(f32).transpose(-1, -2))
    w = torch.softmax(sim, dim=-1).to(v.dtype)
    return torch.matmul(w.to(f32), v.to(f32)).to(v.dtype)


def _flash_group(q, k, v):
    """JAX's `flash_mha(q, k, v, scale=1.0)` over (groups, s, dh) with one
    more key than queries. No kernel of the port takes this shape."""
    if q.device.type != "cpu":
        raise NotImplementedError(
            f"TimeSformer flash attention over {k.shape[1]} keys at head "
            f"dim {q.shape[-1]} (one more key than queries) has no CUDA "
            f"kernel in meant_tpu_torch yet (ROADMAP §2 item 3)")
    return ops.attend(q[:, None], k[:, None], v[:, None], scale=1.0)[:, 0]


class TSAttention(nn.Module):
    """One divided attention: time (group_axis_first=False: group_size=f,
    num_groups=n) or space (True: group_size=n, num_groups=f) over x (b,
    1 + f*n, dim), tokens laid out frame-major."""

    def __init__(self, dim: int, dim_head: int = 64, heads: int = 8,
                 dropout: float = 0.0, flash: bool = False,
                 dtype: Optional[torch.dtype] = None, device=None):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        self.flash = flash
        inner = heads * dim_head
        self.to_qkv = Dense(inner * 3, dim, use_bias=False, dtype=dtype,
                            device=device)
        self.to_out = Dense(dim, inner, dtype=dtype, device=device)
        self.drop = nn.Dropout(dropout)

    def forward(self, x, group_size: int, num_groups: int, rot_sincos=None,
                group_axis_first: bool = False):
        b, n_tok, _ = x.shape
        h, dh = self.heads, self.dim_head
        bh = b * h
        qkv = self.to_qkv(x).reshape(b, n_tok, 3, h, dh).permute(2, 0, 3, 1,
                                                                  4)
        q, k, v = (t.reshape(bh, n_tok, dh) for t in qkv)
        q = q * (dh ** -0.5)
        cls_q, q_ = q[:, :1], q[:, 1:]
        cls_k, k_ = k[:, :1], k[:, 1:]
        cls_v, v_ = v[:, :1], v[:, 1:]
        cls_out = _attn(cls_q, k, v)

        r, g = num_groups, group_size

        def group(t):
            if group_axis_first:        # space: (bh, f, n, dh) -> (bh*f, n)
                return t.reshape(bh * r, g, dh)
            return t.reshape(bh, g, r, dh).transpose(1, 2).reshape(
                bh * r, g, dh)          # time: (bh*n, f, dh)

        def ungroup(t):
            if group_axis_first:
                return t.reshape(bh, r * g, dh)
            return t.reshape(bh, r, g, dh).transpose(1, 2).reshape(
                bh, g * r, dh)

        q_, k_, v_ = group(q_), group(k_), group(v_)
        if rot_sincos is not None:
            q_, k_ = ops.apply_rot_emb_sincos(q_, k_, *rot_sincos)
            q_, k_ = q_.to(v_.dtype), k_.to(v_.dtype)

        def expand_cls(t):
            return t[:, None].expand(bh, r, 1, dh).reshape(bh * r, 1, dh)

        k_ = torch.cat((expand_cls(cls_k), k_), dim=1)
        v_ = torch.cat((expand_cls(cls_v), v_), dim=1)
        if self.flash and k_.shape[1] >= FLASH_MIN_SEQ:
            out = _flash_group(q_, k_, v_)
        else:
            out = _attn(q_, k_, v_)
        out = torch.cat((cls_out, ungroup(out)), dim=1)
        out = out.reshape(b, h, n_tok, dh).transpose(1, 2).reshape(
            b, n_tok, h * dh)
        return self.drop(self.to_out(out))


class GEGLUFeedForward(nn.Module):
    def __init__(self, dim: int, mult: int = 4, dropout: float = 0.0,
                 dtype: Optional[torch.dtype] = None, device=None):
        super().__init__()
        self.proj_in = Dense(dim * mult * 2, dim, dtype=dtype, device=device)
        self.drop = nn.Dropout(dropout)
        self.proj_out = Dense(dim, dim * mult, dtype=dtype, device=device)

    def forward(self, x):
        x, gates = self.proj_in(x).chunk(2, dim=-1)
        return self.proj_out(self.drop(x * gelu(gates)))


def token_shift(x, f: int):
    """Split the features into thirds: the first third moves back one frame
    (the last frame gets zeros), the third forward one (the first gets
    zeros); the rest and the cls token stay."""
    cls_x, tok = x[:, :1], x[:, 1:]
    b, fn, d = tok.shape
    tok = tok.reshape(b, f, fn // f, d)
    chunk = d // 3
    c1, c2 = tok[..., :chunk], tok[..., chunk:2 * chunk]
    c3, rest = tok[..., 2 * chunk:3 * chunk], tok[..., 3 * chunk:]
    c1 = torch.cat((c1[:, 1:], torch.zeros_like(c1[:, :1])), dim=1)
    c3 = torch.cat((torch.zeros_like(c3[:, :1]), c3[:, :-1]), dim=1)
    tok = torch.cat((c1, c2, c3, rest), dim=-1).reshape(b, fn, d)
    return torch.cat((cls_x, tok), dim=1)


class TSBlock(nn.Module):
    """One TimeSformer layer: time attention, space attention, GEGLU feed
    forward, each pre-normed with a residual (and the token shift in front
    of each norm with `shift_tokens`)."""

    def __init__(self, dim: int, dim_head: int, heads: int,
                 attn_dropout: float = 0.0, ff_dropout: float = 0.0,
                 shift_tokens: bool = False, flash: bool = False,
                 dtype: Optional[torch.dtype] = None, device=None):
        super().__init__()
        self.shift_tokens = shift_tokens
        attn = dict(dim_head=dim_head, heads=heads, dropout=attn_dropout,
                    flash=flash, dtype=dtype, device=device)
        self.time_norm = FlaxLayerNorm(dim, device=device)
        self.time_attn = TSAttention(dim, **attn)
        self.space_norm = FlaxLayerNorm(dim, device=device)
        self.space_attn = TSAttention(dim, **attn)
        self.ff_norm = FlaxLayerNorm(dim, device=device)
        self.ff = GEGLUFeedForward(dim, dropout=ff_dropout, dtype=dtype,
                                   device=device)

    def _pre(self, x, norm, f):
        return norm(token_shift(x, f) if self.shift_tokens else x)

    def forward(self, x, f: int, n: int, frame_sin=None, frame_cos=None,
                image_sin=None, image_cos=None):
        frame_rot = None if frame_sin is None else (frame_sin, frame_cos)
        image_rot = None if image_sin is None else (image_sin, image_cos)
        x = self.time_attn(self._pre(x, self.time_norm, f), group_size=f,
                           num_groups=n, rot_sincos=frame_rot,
                           group_axis_first=False) + x
        x = self.space_attn(self._pre(x, self.space_norm, f), group_size=n,
                            num_groups=f, rot_sincos=image_rot,
                            group_axis_first=True) + x
        return self.ff(self._pre(x, self.ff_norm, f)) + x


class TimeSformer(SeededInit, nn.Module):
    """forward(video (b, f, c, H, W)) -> logits (b, num_classes) from the cls
    token, or with `return_tokens` (the reference's `meant_forward`) the
    token sequence (b, 1 + f*n, dim). `head=False` builds no
    out_norm / out_proj, as a JAX model that only asks for tokens has
    none, and always returns the tokens. `cls_token` is drawn N(0, 1) and
    `pos_emb` (rotary_emb=False) N(0, 0.02^2); the weights come from
    `seed`, or from the enclosing model's generator when `seed` is None."""

    def __init__(self, dim: int, num_frames: int, num_classes: int,
                 image_size: int = 224, patch_size: int = 16,
                 channels: int = 3, depth: int = 12, heads: int = 8,
                 dim_head: int = 64, attn_dropout: float = 0.0,
                 ff_dropout: float = 0.0, rotary_emb: bool = True,
                 shift_tokens: bool = False, flash: bool = False,
                 scan_layers: bool = False, remat: Any = False,
                 head: bool = True, dtype: Optional[torch.dtype] = None,
                 device=None, seed: Optional[int] = 0):
        super().__init__()
        if scan_layers and not rotary_emb:
            raise ValueError("TimeSformer(scan_layers=True) requires "
                             "rotary_emb, as in the JAX package")
        self.dim, self.patch_size, self.dim_head = dim, patch_size, dim_head
        self.rotary_emb = rotary_emb
        self.remat = remat_spec((remat or "dots") if scan_layers else False)
        self.to_patch_embedding = Dense(dim, patch_size ** 2 * channels,
                                        dtype=dtype, device=device)
        self.cls_token = nn.Parameter(torch.empty((1, dim), device=device))
        n = (image_size // patch_size) ** 2
        self.pos_emb = (None if rotary_emb else nn.Parameter(
            torch.empty((1 + num_frames * n, dim), device=device)))
        self.layers = nn.ModuleList(
            TSBlock(dim, dim_head, heads, attn_dropout, ff_dropout,
                    shift_tokens, flash, dtype=dtype, device=device)
            for _ in range(depth))
        self.out_norm = FlaxLayerNorm(dim, device=device) if head else None
        self.out_proj = (Dense(num_classes, dim, dtype=dtype, device=device)
                         if head else None)
        if seed is not None:
            init_weights(self, torch.Generator(device=device).manual_seed(
                seed))

    def reset_parameters(self, generator):
        self.cls_token.normal_(0.0, 1.0, generator=generator)
        if self.pos_emb is not None:
            self.pos_emb.normal_(0.0, 0.02, generator=generator)

    def forward(self, video, return_tokens: bool = False):
        b, f, c, height, width = video.shape
        p = self.patch_size
        hp, wp = height // p, width // p
        n = hp * wp
        x = video.reshape(b, f, c, hp, p, wp, p).permute(0, 1, 3, 5, 4, 6, 2)
        x = self.to_patch_embedding(x.reshape(b, f * n, p * p * c))
        cls = self.cls_token[None].expand(b, 1, self.dim).to(x.dtype)
        x = torch.cat((cls, x), dim=1)
        tables = (None,) * 4
        if self.rotary_emb:
            tables = (*ops.frame_rotary_sincos(self.dim_head, f,
                                               device=x.device),
                      *ops.axial_rotary_sincos(self.dim_head, hp, wp,
                                               device=x.device))
        else:
            x = x + self.pos_emb[: x.shape[1]]
        for block in self.layers:
            x = run_block(block, self.remat, x, f, n, *tables)
        if return_tokens or self.out_norm is None:
            return x
        return self.out_proj(self.out_norm(x[:, 0]))
