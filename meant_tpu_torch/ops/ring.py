"""Ring attention: sequence-parallel exact attention over the ranks of a
mesh axis (counterpart of meant_tpu/ops/ring.py).

The sequence is split over the ranks of one mesh axis: each rank holds one
q/k/v chunk, and the K/V chunks (with their key mask) travel once around
the ring, rank to rank+1, while an online softmax accumulates. JAX rotates
them with `ppermute`, which transposes under autodiff; here the shift is
`RingShift`, an autograd Function over `batch_isend_irecv`: forward sends
to rank+1 and receives from rank-1, backward sends the gradient to rank-1
and receives from rank+1.

`ring_attention_local` is the dense per-rank body (plain PyTorch, as in
JAX); `ring_flash_local` runs `flash_mha(..., return_lse=True)` on each
chunk, which always takes the streaming path (R1 + K3 forward, R1 + K4 +
K5 backward), and merges the chunks' (out, lse) pairs; the lse cotangent
of that merge reaches the kernels' backward through delta. Both take the
shift as an argument (`shift(step, tensors)` returns the tensors held at
`step`) and their ring position (`index`, `size`), which default to the
P2P shift and this rank's place in `group`: a caller may play n ranks of
one sequence in one process with a shift that indexes the chunks.
`make_ring_attention` and `ring_attend` wrap them for a mesh.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import torch
import torch.distributed as dist

from meant_tpu_torch.ops.flash.kernel import flash_mha

NEG_INF = float("-inf")


def _p2p(tensors, group, send_to: int, recv_from: int) -> list:
    """Send each tensor to group rank `send_to` and receive its like from
    `recv_from`, all in one batch."""
    out = [torch.empty(t.shape, dtype=t.dtype, device=t.device)
           for t in tensors]
    ops = []
    for t, o in zip(tensors, out):
        ops.append(dist.P2POp(dist.isend, t.contiguous(),
                              dist.get_global_rank(group, send_to), group))
        ops.append(dist.P2POp(dist.irecv, o,
                              dist.get_global_rank(group, recv_from), group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class RingShift(torch.autograd.Function):
    """tensors held by rank-1 of `group`, this rank's sent to rank+1; the
    gradients go the other way. Tensors that need no gradient get none."""

    @staticmethod
    def forward(ctx, group, *tensors):
        ctx.group = group
        n, r = dist.get_world_size(group), dist.get_rank(group)
        out = _p2p(tensors, group, (r + 1) % n, (r - 1) % n)
        ctx.mark_non_differentiable(*(o for t, o in zip(tensors, out)
                                      if not t.requires_grad))
        ctx.grad_of = [t.requires_grad for t in tensors]
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        n, r = dist.get_world_size(ctx.group), dist.get_rank(ctx.group)
        live = [g for g, need in zip(grads, ctx.grad_of) if need]
        back = iter(_p2p(live, ctx.group, (r - 1) % n, (r + 1) % n))
        return (None, *(next(back) if need else None
                        for need in ctx.grad_of))


def p2p_shift(group) -> Callable:
    """The default shift: every step's tensors are the previous step's,
    passed one rank around `group`."""
    return lambda step, tensors: RingShift.apply(group, *tensors)


def _position(group, index, size, shift):
    n = size if size is not None else dist.get_world_size(group)
    idx = index if index is not None else dist.get_rank(group)
    return n, idx, shift or p2p_shift(group)


def _online_update(carry, scores, v_cur):
    """One online-softmax step. scores fp32 (b, h, sq, sk_loc), v_cur
    (b, h, sk_loc, d)."""
    m, l, acc = carry
    m_new = torch.maximum(m, scores.amax(dim=-1, keepdim=True))
    m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
    p = torch.exp(scores - m_safe)
    p = torch.where(torch.isfinite(scores), p, 0.0)
    corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
    l = l * corr + p.sum(dim=-1, keepdim=True)
    acc = acc * corr + torch.matmul(p, v_cur.to(torch.float32))
    return m_new, l, acc


def _stats(q):
    b, h, s_loc, d = q.shape
    f32 = dict(dtype=torch.float32, device=q.device)
    return (torch.full((b, h, s_loc, 1), NEG_INF, **f32),
            torch.zeros((b, h, s_loc, 1), **f32),
            torch.zeros((b, h, s_loc, d), **f32))


def ring_attention_local(q, k, v, kmask=None, *, scale: float,
                         causal: bool = False, group=None,
                         index: Optional[int] = None,
                         size: Optional[int] = None,
                         shift: Optional[Callable] = None):
    """Per-rank body. q/k/v: this rank's chunks (b, h, s_loc, d) of a
    sequence split over `group`; kmask: its (b, s_loc) {0, 1} or None.
    Returns the rank's output chunk (b, h, s_loc, d) in q's dtype."""
    n, idx, shift = _position(group, index, size, shift)
    b, h, s_loc, d = q.shape
    qf = q.to(torch.float32)
    row = idx * s_loc + torch.arange(s_loc, device=q.device)
    held = (k, v, torch.ones((b, s_loc), dtype=torch.float32, device=q.device)
            if kmask is None else kmask.to(torch.float32))
    m, l, acc = _stats(q)
    for i in range(n):
        if i:
            held = shift(i, held)
        k_cur, v_cur, km_cur = held
        src = (idx - i) % n                                # chunk we hold
        scores = torch.matmul(qf, k_cur.to(torch.float32).transpose(-1, -2)
                              ) * scale
        if causal:
            col = src * s_loc + torch.arange(s_loc, device=q.device)
            scores = torch.where(col[None, None, None, :]
                                 <= row[None, None, :, None], scores, NEG_INF)
        scores = scores + (1.0 - km_cur)[:, None, None, :] * -1e9
        m, l, acc = _online_update((m, l, acc), scores, v_cur)
    return (acc / l.clamp_min(1e-30)).to(q.dtype)


def ring_flash_local(q, k, v, kmask=None, *, scale: float,
                     causal: bool = False, group=None,
                     index: Optional[int] = None, size: Optional[int] = None,
                     shift: Optional[Callable] = None,
                     tables: Optional[Callable] = None):
    """Ring attention with the flash kernels as the per-chunk engine: each
    step runs `flash_mha(..., return_lse=True)` (R1 + K3; backward R1 + K4
    + K5) on the local q against the chunk held, and the (out, lse) pairs
    merge with JAX's online combine. Same arguments as
    `ring_attention_local`, and `tables(chunk)` -> (qcos, qsin, kcos, ksin)
    at that chunk's global positions (R1 rotates q with this rank's, k
    with the held chunk's), or None for no rotation. Step 0 attends the
    diagonal chunk with the causal kernel; step i > 0 holds chunk (idx - i)
    mod n, wholly visible when idx >= i and otherwise still launched and
    gated to weight 0, as in JAX."""
    n, idx, shift = _position(group, index, size, shift)
    b, h, s_loc, d = q.shape
    qt = (None, None) if tables is None else tables(idx)[:2]
    held = (k, v, torch.ones((b, s_loc), dtype=torch.float32, device=q.device)
            if kmask is None else kmask.to(torch.float32))
    m, l, acc = _stats(q)
    for i in range(n):
        if i:
            held = shift(i, held)
        k_cur, v_cur, km_cur = held
        kt = (None, None) if tables is None else tables((idx - i) % n)[2:]
        out_i, lse_i = flash_mha(q, k_cur, v_cur, scale=scale,
                                 causal=causal and i == 0,
                                 attention_mask=km_cur, qcos=qt[0],
                                 qsin=qt[1], kcos=kt[0], ksin=kt[1],
                                 force_online=True, return_lse=True)
        if causal and i > idx:      # chunk (idx - i) mod n is in the future
            lse_i = lse_i + NEG_INF
        m_new = torch.maximum(m, lse_i)
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        r = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
        r_i = torch.where(torch.isfinite(lse_i), torch.exp(lse_i - m_safe),
                          0.0)
        l = l * r + r_i
        acc = acc * r + out_i.to(torch.float32) * r_i
        m = m_new
    return (acc / l.clamp_min(1e-30)).to(q.dtype)


def make_ring_attention(mesh, *, scale: float, causal: bool = False,
                        axis: str = "data", use_flash: bool = False,
                        tables: Optional[Callable] = None):
    """fn(q, k, v, attention_mask) over this rank's (b, h, s_loc, d) chunks
    and (b, s_loc) mask of a sequence split over mesh axis `axis`.
    use_flash routes every chunk through the flash kernels
    (`ring_flash_local`, which also takes the rotation `tables`)."""
    group = mesh.get_group(axis)
    if use_flash:
        return functools.partial(ring_flash_local, scale=scale,
                                 causal=causal, group=group, tables=tables)
    if tables is not None:
        raise ValueError("the dense ring takes q and k rotated")
    return functools.partial(ring_attention_local, scale=scale,
                             causal=causal, group=group)


def ring_attend(q, k, v, *, mesh, scale: float, causal: bool = False,
                attention_mask: Optional[torch.Tensor] = None,
                axis: str = "data", use_flash: bool = False):
    """Sequence-parallel attention of global (b, h, s, d) q/k/v, the same
    on every rank (JAX's single-process semantics): each rank takes its
    chunk of the sequence and returns its output chunk (b, h, s / n, d).
    Gradients reach the global inputs at this rank's rows."""
    n, r = mesh[axis].size(), mesh.get_local_rank(axis)
    s = q.shape[2]
    if s % n:
        raise ValueError(f"a sequence of {s} does not divide over {n} ranks")
    s_loc = s // n
    if attention_mask is None:
        attention_mask = torch.ones((q.shape[0], s), dtype=torch.float32,
                                    device=q.device)
    rows = slice(r * s_loc, (r + 1) * s_loc)
    fn = make_ring_attention(mesh, scale=scale, causal=causal, axis=axis,
                             use_flash=use_flash)
    return fn(q[:, :, rows], k[:, :, rows], v[:, :, rows],
              attention_mask[:, rows].to(torch.float32))
