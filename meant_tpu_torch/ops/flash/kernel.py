"""Rotary-fused flash attention, forward and backward (counterpart of
meant_tpu/ops/flash/kernel.py behind `flash_mha`'s custom VJP): the
resident path, forward `_fwd_kernel` (K1) and backward `_bwd_kernel` (K2),
and the streaming path, forward `_fwd_online_kernel` (K3, which also gives
each row's log-sum-exp) and backward `_bwd_dq_kernel` (K4) and
`_bwd_dkdv_kernel` (K5). Every one of them takes q and k rotated once per
call by a rotation pass (R1, part of their design; it replaces no TPU
kernel); the resident backward takes the Qr and Kr its forward made.
`uses_online` routes a call as the JAX package routes it.

On CUDA tensors `flash_mha` launches the hand-written kernels in
`csrc/flash_fwd.cu` (K1, K3), `csrc/flash_bwd.cu` (K2) and
`csrc/flash_bwd_online.cu` (R1, K4, K5), the backwards through a
`torch.autograd.Function` when gradients are needed, or raises; on CPU
tensors it runs their plain versions `flash_mha_reference` (the same math
as the JAX package's `_xla_reference`), `flash_mha_bwd_reference`,
`flash_mha_online_reference` and `flash_mha_bwd_online_reference`. There
is no fallback from a kernel to its plain version. The forwards (R1 + K1,
R1 + K3) are PyTorch custom ops, `meant_tpu_torch::flash_fwd` and
`meant_tpu_torch::flash_fwd_lse`, which the autograd Functions and the
inference path call: `torch.export` keeps them in an exported program and
activation checkpointing sees one operator it can re-run.

Shapes the kernels take: q (b, h, s_q, d) and k, v (b, h, s_k, d), the q
and k lengths separate (causal keeps col <= row, both counted from 0, as
the JAX kernels do), at any head dim d >= 1. The wgmma bodies are built for
64, 96 and 128 (`HEAD_DIMS`); on the card any other d up to 128, odd or
even, is zero-padded to the next of them, and one past 128 to the next
multiple of 64 (`kernel_head_dim`): q, k and v get zero columns, the tables
cos = 1 and sin = 0 there, `scale` stays the caller's, the output is
sliced back. That is exact: the padded lanes add zero to every score. A
padded width that is not one of HEAD_DIMS (d > 128) runs the wide bodies of
csrc/flash_wide.cuh, which stream the contraction over the width and cut
the output into groups of 64-column chunks on a grid axis. The exceptions
are in bf16: at a padded width of 192 or 256 (d in (128, 256]) K1 and K3
run the forwards' wgmma body built at that width (csrc/flash_fwd.cu), and
K2, K4 and K5 the backwards' (csrc/flash_bwd_wgmma.cuh, one or two
consumer warpgroups splitting the gradients' columns); at 384 and
768 (d in (320, 384] and (704, 768]) K1 and K3 run the forwards' body on
its sliced ring (O's columns in groups of 192 on a grid axis, Kr streamed
in 192-column slices), and K2, K4 and K5 at an even d the backwards'
sliced kernels at 384 (csrc/flash_bwd_wgmma.cuh) and the chain body at 768
(csrc/flash_bwd_chain.cuh: S and dP on fp32 FMA chains in column order,
the wide body's bits, formed once per tile pair; the products on wgmma;
on the streaming path K4 + K5 in one call, `flash_bwd_dq_dkdv`, which
forms S and dP once for dq, dk and dv). fp32 past 128, every kernel at
the other widths past 256, and the backwards at an odd d padded to 384 or
768 stay on the wide bodies. Every call is one launch of each kernel at
any d, but the chain body's, three launches a call.

At an odd d the rotation pairs lanes as the JAX kernels' `_rotate_half_lanes`
(meant_tpu/ops/flash/kernel.py:63-71) does, wrapping: lane d-1 pairs with
lane 0 (`rotate_half_lanes`). R1 takes the caller's d beside the padded
width for that, and the backwards' adjoint gives column d-1 of dq and dk
the term sin[0] g[0] of the wrap (in the epilogue of every body: a
shuffle within a warp's quad, or a trip through shared memory where two
warpgroups split the columns; csrc/flash_bwd_wgmma.cuh), which the
forward has no counterpart of where the tables' sin is 0 in column d-1:
at an odd d the JAX flash
backward is not the gradient of its own forward there, and the port
reproduces it (ROADMAP §3).

Left out on purpose (TPU-only in the JAX package): SPMD partitioning,
interpret mode, `block_q` / `block_k`, the VMEM sizing of the blocks and
the outside padding to block multiples -- the CUDA kernels mask their own
ragged edge. The one VMEM model kept is the routing rule (`uses_online`).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from meant_tpu_torch.cuda_build import KernelLauncher, load_library

HEAD_DIMS = (64, 96, 128)      # the head dims the wgmma bodies are built for
WIDE_COLS = 64                 # the wide bodies' slice and chunk width
# The JAX package's routing constants (meant_tpu/ops/flash/kernel.py:56-60,
# 990): K/V stay resident up to K_RESIDENT_LIMIT keys, and the resident
# backward's VMEM model must leave room for a DEFAULT_BLOCK_Q-row q block.
K_RESIDENT_LIMIT = 4096
DEFAULT_BLOCK_Q = 128
_RES_BWD_BUDGET = int(15.5 * 1024 * 1024)
# Relative L2 error a bf16 forward that rounds P at a running max (K3) is
# held to against flash_mha_reference, which rounds the normalised P, on
# the card (chip_smoke.py, tests/test_torch_cuda.py): such a forward reads
# 2.7e-3 to 3.1e-3; a pair of rotated features that shares one table entry
# under xPos reads 6.7e-3 (PERF.md).
BF16_REL_L2 = 5e-3
# K1's own bar against flash_mha_reference. K1 rounds P after normalising,
# where the plain version (and `_fwd_kernel`) rounds it, and reads 5.0e-5
# to 7.5e-5 at the main path's shapes; P rounded at the running max in one
# pass reads 2.8e-3 to 2.9e-3 (tools/k1_faults.py; PERF.md).
K1_BF16_REL_L2 = 1e-3
# Bars of the bf16 backward (K2) against flash_mha_bwd_reference on the card,
# per gradient: 2e-2 relative plus BWD_BF16_ATOL per element, and relative
# L2. K2 rounds P and dS where the plain version does, and reads 6.1e-5 to
# 9.9e-5 relative L2 (one bf16 step per element at most) at the main path's
# shapes; dS rounded toward zero reads 4.7e-3 and a sign slip in the
# rotation's adjoint 0.49 (PERF.md, tools/k2_faults.py).
BWD_BF16_ATOL = 2e-2
BWD_BF16_REL_L2 = 5e-4
# The streaming kernels (K3, K4, K5) are held to BF16_REL_L2 on out and to
# K2's bars on the gradients, and K3's log-sum-exp to LSE_ATOL absolute
# against flash_mha_online_reference on the card (chip_smoke.py,
# tests/test_torch_cuda.py). K3's out is also held to K3_TILED_REL_L2
# against flash_mha_online_tiled_reference, which rounds P where K3 does:
# K3 reads 9.6e-5 to 1.03e-4 there, P rounded after normalising 2.9e-3
# (tools/k3_faults.py; PERF.md).
LSE_ATOL = 1e-4
K3_TILED_REL_L2 = 1e-3
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _dtype_code(q) -> int:
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"flash kernel takes fp32 or bf16, got {q.dtype}")
    return _DTYPE_CODES[q.dtype]


def uses_online(s_k: int, d: int, force_online: Optional[bool] = None,
                return_lse: bool = False) -> bool:
    """Whether `flash_mha` takes the streaming path (K3 forward, K4 + K5
    backward) rather than the resident one (K1, K2): the JAX package's rule
    (meant_tpu/ops/flash/kernel.py:974-998, with no `block_q`, as
    `flash_attention` passes none). Streaming when force_online says so,
    else past K_RESIDENT_LIMIT keys; always for return_lse; and whenever the
    resident backward's VMEM model (50*s_k*d + 2.36*block_q*s_k bytes in
    15.5 MiB) leaves no 128-row q block, which at d=96 is s_k >= 3186.

    That model sizes TPU memory and means nothing to the CUDA kernels. The
    port keeps it because the two paths are not the same function: a batch
    row whose keys are all masked gets P = 1/s from the resident backward
    and P = exp(S - lse) = 1 from the streaming one (-1e9 + log s rounds to
    -1e9 in fp32). Routing as JAX routes keeps the port computing the
    reference's function at every length."""
    if return_lse:
        return True
    online = force_online if force_online is not None else (
        s_k > K_RESIDENT_LIMIT)
    if not online:
        room = _RES_BWD_BUDGET - 50 * s_k * d
        cap = (int(room / (2.36 * s_k)) // 128) * 128 if room > 0 else 0
        online = cap < DEFAULT_BLOCK_Q
    return online


def kernel_head_dim(d: int) -> int:
    """The width a call at head dim d runs at on the card (the wrapper pads
    q, k, v and the tables up to it): for a d up to 128, odd or even, the
    least of HEAD_DIMS at or above it (95 -> 96, 63 -> 64, 7 -> 64); past
    128 the least multiple of WIDE_COLS at or above it. Raises for d <=
    0."""
    if d <= 0:
        raise ValueError(f"a head dim must be positive, got {d}")
    if d <= HEAD_DIMS[-1]:
        return next(k for k in HEAD_DIMS if k >= d)
    return -(-d // WIDE_COLS) * WIDE_COLS


def _kernel_width(d: int) -> bool:
    """Whether the kernels take tensors d wide: one of HEAD_DIMS or a
    multiple of WIDE_COLS."""
    return d in HEAD_DIMS or (d > 0 and d % WIDE_COLS == 0)


def _head_dim(head_dim, d: int) -> int:
    """The caller's head dim of a launch on tensors d wide (d when None)."""
    head_dim = d if head_dim is None else int(head_dim)
    if not 0 < head_dim <= d:
        raise ValueError(f"head_dim {head_dim} must be in [1, {d}]")
    return head_dim


def _check_launch_inputs(q, k, q_like=None, k_like=None, tables=(),
                         kmask=None, num_heads=1, rows=None):
    """What the kernels refuse: q (BH, s_q, d) and k (BH, s_k, d) of one
    dtype, fp32 or bf16, d one of HEAD_DIMS or a multiple of WIDE_COLS
    (`_kernel_width`); every tensor in `q_like` of
    q's shape and `k_like` of k's, in their dtype; tables, when given,
    (qcos, qsin, kcos, ksin) as (s_q, d) and (s_k, d) fp32; every tensor in
    `rows` (per-row statistics) (BH, s_q) fp32; kmask (b | 1, s_k) fp32 or
    None; all contiguous on q's device. Returns the mask's row count (0
    without a mask)."""
    bh, s_q, d = q.shape
    s_k = k.shape[1]
    _dtype_code(q)
    if not _kernel_width(d):
        raise ValueError(f"flash kernels take widths {HEAD_DIMS} or "
                         f"multiples of {WIDE_COLS}, got {d}")
    like = [(name, t, q.shape) for name, t in (q_like or {}).items()]
    like += [(name, t, (bh, s_k, d))
             for name, t in {"k": k, **(k_like or {})}.items()]
    for name, t, shape in like:
        if t.shape != shape or t.dtype != q.dtype:
            raise ValueError(f"{name} {tuple(t.shape)} {t.dtype} must be "
                             f"{tuple(shape)} {q.dtype}")
    for t, s in zip(tables, (s_q, s_q, s_k, s_k)):
        if t.shape != (s, d) or t.dtype != torch.float32:
            raise ValueError(f"rotation tables must be ({s}, {d}) fp32, "
                             f"got {tuple(t.shape)} {t.dtype}")
    for name, t in (rows or {}).items():
        if t.shape != (bh, s_q) or t.dtype != torch.float32:
            raise ValueError(f"{name} must be ({bh}, {s_q}) fp32, got "
                             f"{tuple(t.shape)} {t.dtype}")
    tensors = [q, *(t for _, t, _ in like), *tables,
               *(rows or {}).values()]
    mask_rows = 0
    if kmask is not None:
        mask_rows = kmask.shape[0]
        if (kmask.dim() != 2 or kmask.shape[1] != s_k
                or kmask.dtype != torch.float32
                or mask_rows not in (1, bh // num_heads)):
            raise ValueError(f"kmask must be (b | 1, {s_k}) fp32, got "
                             f"{tuple(kmask.shape)} {kmask.dtype}")
        tensors.append(kmask)
    for t in tensors:
        if t.device != q.device or not t.is_contiguous():
            raise ValueError("flash kernel inputs must be contiguous "
                             f"tensors on {q.device}")
    if bh % num_heads:
        raise ValueError(f"BH={bh} is not a multiple of {num_heads} heads")
    return mask_rows


WIDE_SOURCE = "meant_tpu_torch/csrc/flash_wide.cuh"
CHAIN_SOURCE = "meant_tpu_torch/csrc/flash_bwd_chain.cuh"


class _FlashLauncher(KernelLauncher):
    """A flash kernel's wrapper. Each launch runs one of its bodies, as
    `meant_flash_body` in csrc/flash_wide.cuh (over `takes_wide` and
    `takes_chain`) decides for this kernel (`kernel`, 1-5 for K1-K5), its
    dtype, width and head dim: the wgmma or fp32 body of `source`, the
    wide body, or the backwards' chain body at 768. `last_source` names
    the source of the body that the last launch ran, as the library
    reports it. The first argument of every launch is the dtype's code.
    A backward whose body needs a device scratch names the library's entry
    that sizes it (`scratch_symbol`). The library's answers depend on
    their arguments alone and are kept, so a repeated launch asks
    nothing but the launch itself."""

    source = ""
    kernel = 0
    scratch_symbol = ""
    last_source: Optional[str] = None

    def __init__(self):
        super().__init__()
        self._bodies: dict = {}
        self._scratch_sizes: dict = {}

    def body(self, dtype_code: int, d: int, head_dim: int) -> str:
        """The source of the body a launch at (dtype, width d, head_dim)
        runs, as the library reports it."""
        key = (dtype_code, d, head_dim)
        self._function()
        if key not in self._bodies:
            body = load_library(self.library).meant_flash_body(
                self.kernel, *key)
            self._bodies[key] = (self.source, WIDE_SOURCE, CHAIN_SOURCE)[body]
        return self._bodies[key]

    def _launch_flash(self, device, *args, shape, head_dim) -> None:
        self._launch(device, *args, shape=shape)
        self.last_source = self.body(args[0], shape[2], head_dim)

    def _function(self):
        # the scratch size's entry point is looked up with the launch's,
        # once a library is loaded; what the last one answered is dropped
        if self._fn is None:
            self._bodies.clear()
            self._scratch_sizes.clear()
            if self.scratch_symbol:
                fn = getattr(load_library(self.library), self.scratch_symbol)
                fn.argtypes = [ctypes.c_int] * 6
                fn.restype = ctypes.c_longlong
                self._scratch_fn = fn
        return super()._function()

    def scratch_bytes(self, dtype_code: int, d: int, head_dim: int, bh: int,
                      s_q: int, s_k: int) -> int:
        """The device scratch a launch needs beside its statistics, as the
        library reports it (the chain body's; else 0)."""
        key = (dtype_code, d, head_dim, bh, s_q, s_k)
        self._function()
        if key not in self._scratch_sizes:
            self._scratch_sizes[key] = int(self._scratch_fn(*key))
        return self._scratch_sizes[key]

    def _scratch(self, qr, d: int, head_dim: int, s_k: int):
        """The scratch of a launch on qr (BH, s_q, d), or None."""
        bh, s_q = qr.shape[:2]
        nbytes = self.scratch_bytes(_dtype_code(qr), d, head_dim, bh, s_q,
                                    s_k)
        return (torch.empty(nbytes, dtype=torch.uint8, device=qr.device)
                if nbytes else None)


class FlashForward(_FlashLauncher):
    """K1: ctypes wrapper of `meant_flash_fwd` (csrc/flash_fwd.cu)."""

    symbol, library, kernel = "meant_flash_fwd", "flash_fwd", 1
    source = "meant_tpu_torch/csrc/flash_fwd.cu"
    argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])

    def __call__(self, qr, kr, v, kmask, *, scale: float, causal: bool,
                 num_heads: int) -> torch.Tensor:
        """qr (q rotated by R1): (BH, s_q, d); kr (k rotated by R1), v:
        (BH, s_k, d); CUDA, contiguous, fp32 or bf16, d a kernel width
        (`_kernel_width`); kmask (b | 1, s_k) fp32 or None. Returns (BH,
        s_q, d). Launches are keyed (s_q, s_k, d, causal)."""
        bh, s_q, d = qr.shape
        s_k = kr.shape[1]
        mask_rows = _check_launch_inputs(qr, kr, k_like={"v": v},
                                         kmask=kmask, num_heads=num_heads)
        out = torch.empty_like(qr)
        self._launch_flash(
            qr.device, _dtype_code(qr), qr.data_ptr(), kr.data_ptr(),
            v.data_ptr(), out.data_ptr(),
            kmask.data_ptr() if kmask is not None else None, mask_rows, bh,
            s_q, s_k, d, num_heads, float(scale), int(bool(causal)),
            shape=(s_q, s_k, d, bool(causal)), head_dim=d)
        return out


class FlashBackward(_FlashLauncher):
    """K2: ctypes wrapper of `meant_flash_bwd` (csrc/flash_bwd.cu), one
    call = its dq kernel then its dk/dv kernel on the current stream (in
    bf16 at a padded width of 768, the chain body's three launches:
    csrc/flash_bwd_chain.cuh)."""

    symbol, library, kernel = "meant_flash_bwd", "flash_bwd", 2
    source = "meant_tpu_torch/csrc/flash_bwd.cu"
    scratch_symbol = "meant_flash_bwd_scratch_bytes"
    argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 14 + [ctypes.c_int] * 7
                + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])

    def __call__(self, qr, kr, v, do, kmask, qcos, qsin, kcos, ksin, *,
                 scale: float, causal: bool, num_heads: int,
                 head_dim: Optional[int] = None) -> tuple:
        """qr (q rotated by R1), do: (BH, s_q, d); kr (k rotated by R1),
        v: (BH, s_k, d); CUDA, contiguous, fp32 or bf16; tables (s_q | s_k,
        d) fp32, read only by the rotation's adjoint; kmask as for the
        forward; head_dim the caller's d before padding (d when None; an
        odd one wraps the adjoint). Returns (dq, dk, dv) shaped as q, k,
        v."""
        bh, s_q, d = qr.shape
        s_k = kr.shape[1]
        head_dim = _head_dim(head_dim, d)
        mask_rows = _check_launch_inputs(
            qr, kr, q_like={"do": do}, k_like={"v": v},
            tables=(qcos, qsin, kcos, ksin), kmask=kmask,
            num_heads=num_heads)
        dq = torch.empty_like(qr)
        dk, dv = torch.empty_like(kr), torch.empty_like(kr)
        # per row: max, 1/denominator, delta (written by the statistics
        # pass, read by the dk/dv kernel)
        stats = torch.empty((3, bh, s_q), dtype=torch.float32,
                            device=qr.device)
        scratch = self._scratch(qr, d, head_dim, s_k)
        self._launch_flash(
            qr.device, _dtype_code(qr), qr.data_ptr(), kr.data_ptr(),
            v.data_ptr(), do.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), stats.data_ptr(),
            scratch.data_ptr() if scratch is not None else None,
            qcos.data_ptr(),
            qsin.data_ptr(), kcos.data_ptr(), ksin.data_ptr(),
            kmask.data_ptr() if kmask is not None else None, mask_rows, bh,
            s_q, s_k, d, head_dim, num_heads, float(scale),
            int(bool(causal)), shape=(s_q, s_k, d, bool(causal)),
            head_dim=head_dim)
        return dq, dk, dv


class FlashForwardOnline(_FlashLauncher):
    """K3: ctypes wrapper of `meant_flash_fwd_lse` (csrc/flash_fwd.cu)."""

    symbol, library, kernel = "meant_flash_fwd_lse", "flash_fwd", 3
    source = "meant_tpu_torch/csrc/flash_fwd.cu"
    argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])

    def __call__(self, qr, kr, v, kmask, *, scale: float, causal: bool,
                 num_heads: int) -> tuple:
        """Inputs as K1's. Returns (out (BH, s_q, d), lse (BH, s_q)
        fp32)."""
        bh, s_q, d = qr.shape
        s_k = kr.shape[1]
        mask_rows = _check_launch_inputs(qr, kr, k_like={"v": v},
                                         kmask=kmask, num_heads=num_heads)
        out = torch.empty_like(qr)
        lse = torch.empty((bh, s_q), dtype=torch.float32, device=qr.device)
        self._launch_flash(
            qr.device, _dtype_code(qr), qr.data_ptr(), kr.data_ptr(),
            v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            kmask.data_ptr() if kmask is not None else None, mask_rows, bh,
            s_q, s_k, d, num_heads, float(scale), int(bool(causal)),
            shape=(s_q, s_k, d, bool(causal)), head_dim=d)
        return out, lse


class RotateQK(KernelLauncher):
    """R1, the rotation pass in front of K1 (whose Qr and Kr K2 takes), K3
    and K4 + K5: ctypes wrapper of `meant_rotate_qk`
    (csrc/flash_bwd_online.cu). Its plain version is `_rotate` on each of q
    and k."""

    symbol, library = "meant_rotate_qk", "flash_bwd_online"
    argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
                + [ctypes.c_void_p])

    def __call__(self, q, k, qcos, qsin, kcos, ksin,
                 head_dim: Optional[int] = None) -> tuple:
        """q: (BH, s_q, d), k: (BH, s_k, d) CUDA, contiguous, fp32 or
        bf16; tables (s_q | s_k, d) fp32; head_dim the caller's d before
        padding (d when None): at an odd one, column head_dim - 1 pairs
        with column 0. Returns (qr, kr): q and k rotated in fp32 and
        rounded to their dtype, bit for bit `_rotate`'s on the first
        head_dim columns (zero past them, where q and k are zero and the
        tables the identity). Launches are keyed (s_q, s_k, d)."""
        bh, s_q, d = q.shape
        s_k = k.shape[1]
        _check_launch_inputs(q, k, tables=(qcos, qsin, kcos, ksin))
        head_dim = _head_dim(head_dim, d)
        qr, kr = torch.empty_like(q), torch.empty_like(k)
        self._launch(
            q.device, _dtype_code(q), q.data_ptr(), k.data_ptr(),
            qr.data_ptr(), kr.data_ptr(), qcos.data_ptr(), qsin.data_ptr(),
            kcos.data_ptr(), ksin.data_ptr(), bh, s_q, s_k, d, head_dim,
            shape=(s_q, s_k, d))
        return qr, kr


class _FlashBackwardOnline(_FlashLauncher):
    """K4 and K5 take the same inputs: qr (q rotated by R1) and do, (BH,
    s_q, d), kr (k rotated by R1) and v, (BH, s_k, d), CUDA, contiguous,
    fp32 or bf16; lse and delta (BH, s_q) fp32; tables and kmask as for
    the forward (the tables serve the rotation's adjoint); head_dim as
    K2's. Past d = 256 in bf16 at an even head dim they replace
    `_bwd_dq_kernel` and `_bwd_dkdv_kernel` (meant_tpu/ops/flash/
    kernel.py:456, :527) on the sliced kernels of
    csrc/flash_bwd_wgmma.cuh at 384 (bound by operations at src4096's
    (20, 4096, 384): K4 0.39 ms, K5 0.52 ms) and on the chain body of
    csrc/flash_bwd_chain.cuh at 768, which takes a device scratch the
    wrapper allocates (bound by bytes at --num_heads 1's (80, 512, 768):
    0.096 + 0.115 ms; the chains' fp32 floor 0.54 ms, PERF.md)."""

    library = "flash_bwd_online"
    source = "meant_tpu_torch/csrc/flash_bwd_online.cu"
    scratch_symbol = "meant_flash_bwd_online_scratch_bytes"
    outputs = ()     # which of q and k each gradient is shaped as

    def __call__(self, qr, kr, v, do, lse, delta, kmask, qcos, qsin, kcos,
                 ksin, *, scale: float, causal: bool, num_heads: int,
                 head_dim: Optional[int] = None):
        bh, s_q, d = qr.shape
        s_k = kr.shape[1]
        head_dim = _head_dim(head_dim, d)
        mask_rows = _check_launch_inputs(
            qr, kr, q_like={"do": do}, k_like={"v": v},
            tables=(qcos, qsin, kcos, ksin), kmask=kmask,
            num_heads=num_heads, rows={"lse": lse, "delta": delta})
        grads = [torch.empty_like(qr if o == "q" else kr)
                 for o in self.outputs]
        scratch = self._scratch(qr, d, head_dim, s_k)
        self._launch_flash(
            qr.device, _dtype_code(qr), qr.data_ptr(), kr.data_ptr(),
            v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            *(g.data_ptr() for g in grads),
            scratch.data_ptr() if scratch is not None else None,
            qcos.data_ptr(),
            qsin.data_ptr(), kcos.data_ptr(), ksin.data_ptr(),
            kmask.data_ptr() if kmask is not None else None, mask_rows, bh,
            s_q, s_k, d, head_dim, num_heads, float(scale),
            int(bool(causal)), shape=(s_q, s_k, d, bool(causal)),
            head_dim=head_dim)
        return grads


class FlashBackwardDQ(_FlashBackwardOnline):
    """K4: ctypes wrapper of `meant_flash_bwd_dq`
    (csrc/flash_bwd_online.cu). Returns [dq]."""

    symbol, outputs, kernel = "meant_flash_bwd_dq", ("q",), 4
    argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 13 + [ctypes.c_int] * 7
                + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


class FlashBackwardDKDV(_FlashBackwardOnline):
    """K5: ctypes wrapper of `meant_flash_bwd_dkdv`
    (csrc/flash_bwd_online.cu). Returns [dk, dv]."""

    symbol, outputs, kernel = "meant_flash_bwd_dkdv", ("k", "k"), 5
    argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 14 + [ctypes.c_int] * 7
                + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


class FlashBackwardDQDKDV(_FlashBackwardOnline):
    """K4 + K5 in one call, the streaming backward on the main path: ctypes
    wrapper of `meant_flash_bwd_online` (csrc/flash_bwd_online.cu), which
    replaces `_bwd_dq_kernel` and `_bwd_dkdv_kernel` together. Where the
    chain body takes them (bf16 at a padded width of 768, an even head
    dim) S and dP are formed once for dq, dk and dv, then the three
    products (bound by bytes at --num_heads 1's (80, 512, 768): 447 MB,
    0.133 ms; the chains' fp32 floor, formed once, 0.54 ms); at every
    other width the library launches K4, then K5. A call counts as one
    launch of K4 (`flash_bwd_dq`) and one of K5 (`flash_bwd_dkdv`), and
    names each one's body as theirs. Returns [dq, dk, dv]."""

    symbol, outputs, kernel = "meant_flash_bwd_online", ("q", "k", "k"), 4
    argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 15 + [ctypes.c_int] * 7
                + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])

    def _launch_flash(self, device, *args, shape, head_dim) -> None:
        super()._launch_flash(device, *args, shape=shape, head_dim=head_dim)
        for launcher in (flash_bwd_dq, flash_bwd_dkdv):
            launcher.launches += 1
            launcher.launches_by_shape[shape] += 1
            launcher.last_source = launcher.body(args[0], shape[2],
                                                 head_dim)


flash_fwd = FlashForward()
flash_bwd = FlashBackward()
flash_fwd_online = FlashForwardOnline()
flash_bwd_dq = FlashBackwardDQ()
flash_bwd_dkdv = FlashBackwardDKDV()
flash_bwd_dq_dkdv = FlashBackwardDQDKDV()
rotate_qk = RotateQK()


def identity_tables(s: int, d: int, device) -> tuple:
    """(cos, sin) = (1, 0) tables: no rotation."""
    return (torch.ones((s, d), dtype=torch.float32, device=device),
            torch.zeros((s, d), dtype=torch.float32, device=device))


def rotate_half_lanes(x):
    """The JAX kernels' lane rotate-half (`_rotate_half_lanes`,
    meant_tpu/ops/flash/kernel.py:63-71) on the last axis of d lanes:
    out[2i] = -x[(2i+1) mod d], out[2i+1] = x[2i]. At an even d this is the
    interleaved pairwise rotate_half, bit for bit; at an odd d lane d-1
    pairs with lane 0 (out[d-1] = -x[0]), as the two wrapping rolls give."""
    d = x.shape[-1]
    left = torch.roll(x, -1, dims=-1)    # left[j] = x[(j + 1) % d]
    right = torch.roll(x, 1, dims=-1)    # right[j] = x[(j - 1) % d]
    even = torch.arange(d, device=x.device) % 2 == 0
    return torch.where(even, -left, right)


def _rotate(t, cos, sin):
    """x*cos + rotate_half_lanes(x)*sin in fp32, rounded to t's dtype."""
    tf = t.to(torch.float32)
    return (tf * cos + rotate_half_lanes(tf) * sin).to(t.dtype)


def flash_mha_reference(q, k, v, kmask, qcos, qsin, kcos, ksin, *,
                        scale: float, causal: bool) -> torch.Tensor:
    """Plain PyTorch version of R1 + K1: rotate in fp32 with the tables,
    round to the input dtype, then `attend`'s arithmetic (the softmax
    normalised, then rounded to the input dtype, as `_fwd_kernel` rounds
    it) with the kernels' causal fill (col <= row from 0, for any q and k
    lengths). q: (b, h, s_q, d), k/v: (b, h, s_k, d); kmask (b | 1, s_k)
    float or None."""
    return _attend_scores(_scores(_rotate(q, qcos, qsin),
                                  _rotate(k, kcos, ksin), kmask, scale,
                                  causal), v).to(q.dtype)


def _attend_scores(scores, v):
    """softmax(scores) rounded to v's dtype, times v, in fp32 sums."""
    p = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.matmul(p.to(torch.float32), v.to(torch.float32))


def _scores(qr, kr, kmask, scale, causal):
    """fp32 scores of rotated q, k: times scale, the causal -inf fill
    (col > row, both from 0), then + (1 - kmask) * -1e9, in the reference's
    order."""
    f32 = torch.float32
    scores = torch.matmul(qr.to(f32), kr.to(f32).transpose(-1, -2)) * scale
    if causal:
        s_q, s_k = scores.shape[-2], scores.shape[-1]
        row = torch.arange(s_q, device=qr.device)[:, None]
        col = torch.arange(s_k, device=qr.device)[None, :]
        scores = scores.masked_fill(col > row, float("-inf"))
    if kmask is not None:
        scores = scores + ((1.0 - kmask.to(f32)) * -1e9)[:, None, None, :]
    return scores


def _adjoint(g, cos, sin):
    """The rotation's adjoint as the JAX kernels write it, cos*g -
    rotate_half_lanes(sin*g) (kernel.py:378-379, :523, :609). At an odd d
    the lanes wrap: column d-1 takes cos*g + sin[0]*g[0], a term the
    forward's rotation has no counterpart of where sin is 0 in column d-1
    (every table the models build), so there this is not the forward's
    adjoint: the reference's behaviour, kept."""
    return cos * g - rotate_half_lanes(sin * g)


def flash_mha_bwd_reference(q, k, v, do, kmask, qcos, qsin, kcos, ksin, *,
                            scale: float, causal: bool) -> tuple:
    """Plain PyTorch version of K2, step by step as the JAX package's
    `_bwd_kernel` (meant_tpu/ops/flash/kernel.py:321-390): P recomputed in
    fp32; dV from P rounded to the input dtype; delta = rowsum(P * dP); dS
    rounded to the input dtype before the dQ/dK products; the rotation's
    adjoint cos*g - rotate_half_lanes(sin*g) applied after them. q/do: (b, h,
    s_q, d), k/v: (b, h, s_k, d); kmask (b | 1, s_k) or None. Returns (dq,
    dk, dv) in q's dtype."""
    f32 = torch.float32
    dt = q.dtype
    qr, kr = _rotate(q, qcos, qsin), _rotate(k, kcos, ksin)
    p = torch.softmax(_scores(qr, kr, kmask, scale, causal), dim=-1)
    dof = do.to(f32)
    dv = torch.matmul(p.to(dt).to(f32).transpose(-1, -2), dof)
    dp = torch.matmul(dof, v.to(f32).transpose(-1, -2))
    delta = torch.sum(p * dp, dim=-1, keepdim=True)
    ds = (p * (dp - delta) * scale).to(dt).to(f32)
    dqr = torch.matmul(ds, kr.to(f32))
    dkr = torch.matmul(ds.transpose(-1, -2), qr.to(f32))
    dq = _adjoint(dqr, qcos, qsin)
    dk = _adjoint(dkr, kcos, ksin)
    return dq.to(dt), dk.to(dt), dv.to(dt)


def flash_mha_online_reference(q, k, v, kmask, qcos, qsin, kcos, ksin, *,
                               scale: float, causal: bool) -> tuple:
    """Plain PyTorch version of K3: (out, lse). out is as
    `flash_mha_reference`; lse (b, h, s) fp32 is each row's log-sum-exp in
    the JAX package's form (`_fwd_online_kernel`, kernel.py:198-206), (b,
    h, s_q):
    m_safe + log(max(l, 1e-30)), with m the row's max score, m_safe = 0
    where m = -inf, and l the sum of exp(score - m_safe). (torch.logsumexp
    gives -inf on a row with no finite score, where this gives
    log(1e-30).)"""
    qr, kr = _rotate(q, qcos, qsin), _rotate(k, kcos, ksin)
    scores = _scores(qr, kr, kmask, scale, causal)
    m = scores.amax(dim=-1, keepdim=True)
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    l = torch.exp(scores - m_safe).sum(dim=-1, keepdim=True)
    lse = (m_safe + torch.log(l.clamp_min(1e-30))).squeeze(-1)
    return _attend_scores(scores, v).to(q.dtype), lse


def flash_mha_online_tiled_reference(q, k, v, kmask, qcos, qsin, kcos,
                                     ksin, *, scale: float, causal: bool,
                                     block_k: int = 64) -> tuple:
    """Plain PyTorch version of R1 + K3 in the kernel's order: (out, lse) as
    `_fwd_online_kernel` (kernel.py:127-206) computes them at
    block_k = 64, K3's tile. It walks the keys in tiles with the running
    max m and denominator l, rounds the unnormalised P = exp(S - m) to the
    input dtype before P V, rescales by exp(m_old - m_new) and divides by
    max(l, 1e-30) at the end; lse = m_safe + log(max(l, 1e-30)).
    `flash_mha_online_reference` rounds the normalised P instead."""
    f32, dt = torch.float32, v.dtype
    qr, kr = _rotate(q, qcos, qsin), _rotate(k, kcos, ksin)
    scores = _scores(qr, kr, kmask, scale, causal)
    shape = scores.shape[:-1] + (1,)
    m = torch.full(shape, float("-inf"), device=q.device)
    l = torch.zeros(shape, device=q.device)
    acc = torch.zeros(q.shape, dtype=f32, device=q.device)
    vf = v.to(f32)
    for k0 in range(0, scores.shape[-1], block_k):
        sc = scores[..., k0:k0 + block_k]
        m_new = torch.maximum(m, sc.amax(dim=-1, keepdim=True))
        m_safe = torch.where(torch.isfinite(m_new), m_new,
                             torch.zeros_like(m_new))
        p = torch.where(torch.isfinite(sc), torch.exp(sc - m_safe),
                        torch.zeros_like(sc))
        corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe),
                           torch.zeros_like(m))
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + torch.matmul(p.to(dt).to(f32),
                                        vf[..., k0:k0 + block_k, :])
        m = m_new
    denom = l.clamp_min(1e-30)
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    lse = (m_safe + torch.log(denom)).squeeze(-1)
    return (acc / denom).to(q.dtype), lse


def _online_p(qr, kr, lse, kmask, scale, causal):
    """P = exp(S - lse), fp32, 0 where S = -inf (K4's and K5's P)."""
    scores = _scores(qr, kr, kmask, scale, causal)
    return torch.exp(scores - lse.to(torch.float32)[..., None])


def flash_mha_bwd_online_dq_reference(q, k, v, do, lse, delta, kmask, qcos,
                                      qsin, kcos, ksin, *, scale: float,
                                      causal: bool) -> torch.Tensor:
    """Plain PyTorch version of K4, step by step as the JAX package's
    `_bwd_dq_kernel` (kernel.py:456-524): P = exp(S - lse); dP = dO V^T;
    dS = P * (dP - delta) * scale rounded to the input dtype; dQ =
    rot^T(dS Kr). q/k/v/do: (b, h, s, d); lse, delta: (b, h, s) fp32."""
    f32, dt = torch.float32, q.dtype
    qr, kr = _rotate(q, qcos, qsin), _rotate(k, kcos, ksin)
    p = _online_p(qr, kr, lse, kmask, scale, causal)
    dp = torch.matmul(do.to(f32), v.to(f32).transpose(-1, -2))
    ds = (p * (dp - delta.to(f32)[..., None]) * scale).to(dt).to(f32)
    del p, dp
    return _adjoint(torch.matmul(ds, kr.to(f32)), qcos, qsin).to(dt)


def flash_mha_bwd_online_dkdv_reference(q, k, v, do, lse, delta, kmask,
                                        qcos, qsin, kcos, ksin, *,
                                        scale: float, causal: bool) -> tuple:
    """Plain PyTorch version of K5, step by step as the JAX package's
    `_bwd_dkdv_kernel` (kernel.py:527-611): P = exp(S - lse); dV = T(P)^T
    dO; dS as in K4; dK = rot^T(dS^T Qr). Returns (dk, dv)."""
    f32, dt = torch.float32, q.dtype
    qr, kr = _rotate(q, qcos, qsin), _rotate(k, kcos, ksin)
    p = _online_p(qr, kr, lse, kmask, scale, causal)
    dof = do.to(f32)
    dv = torch.matmul(p.to(dt).to(f32).transpose(-1, -2), dof)
    dp = torch.matmul(dof, v.to(f32).transpose(-1, -2))
    ds = (p * (dp - delta.to(f32)[..., None]) * scale).to(dt).to(f32)
    del p, dp
    dkr = torch.matmul(ds.transpose(-1, -2), qr.to(f32))
    return _adjoint(dkr, kcos, ksin).to(dt), dv.to(dt)


def flash_mha_bwd_online_reference(q, k, v, do, lse, delta, kmask, qcos,
                                   qsin, kcos, ksin, *, scale: float,
                                   causal: bool) -> tuple:
    """Plain PyTorch version of K4 + K5: (dq, dk, dv) in q's dtype, from
    the forward's lse and delta = rowsum(dO * out) - g_lse, both (b, h, s)
    fp32."""
    args = (q, k, v, do, lse, delta, kmask, qcos, qsin, kcos, ksin)
    dq = flash_mha_bwd_online_dq_reference(*args, scale=scale, causal=causal)
    dk, dv = flash_mha_bwd_online_dkdv_reference(*args, scale=scale,
                                                 causal=causal)
    return dq, dk, dv


def _flat(dk, *tensors):
    """(b, h, s, d) tensors as contiguous (b*h, s, dk), as the kernels take
    them: zero columns appended up to the kernel's head dim dk."""
    out = []
    for t in tensors:
        b, h, s, d = t.shape
        t = t.reshape(b * h, s, d)
        out.append(torch.nn.functional.pad(t, (0, dk - d)) if dk > d
                   else t.contiguous())
    return out


def _kernel_tables(dk, kmask, qcos, qsin, kcos, ksin):
    """The mask and the four tables, contiguous; the tables padded to dk
    columns with the identity rotation (cos = 1, sin = 0)."""
    pad = torch.nn.functional.pad
    d = qcos.shape[-1]
    tables = [pad(t, (0, dk - d), value=value) if dk > d else t.contiguous()
              for t, value in ((qcos, 1.0), (qsin, 0.0), (kcos, 1.0),
                               (ksin, 0.0))]
    return (None if kmask is None else kmask.contiguous(), *tables)


def _unpad(d, t):
    """The first d columns of a kernel's (.., dk) output, contiguous."""
    return t if t.shape[-1] == d else t[..., :d].contiguous()


# The forwards as PyTorch operators, so that autograd, checkpointing and
# torch.export see one operator each: `meant_tpu_torch::flash_fwd` (R1 +
# K1) and `meant_tpu_torch::flash_fwd_lse` (R1 + K3). The dispatcher picks
# the implementation by the tensors' device: the kernels for CUDA tensors,
# the plain versions for CPU tensors, shapes and dtypes alone for the fake
# tensors of a trace. A CUDA tensor never reaches a plain version. They are
# registered with `torch.library.Library`: `torch.library.custom_op` wraps
# each call in Python layers that cost a `meant` training step 12-19 ms of
# host time on the H100 (tools/dispatch_cost.py, PERF.md).
_LIB = torch.library.Library("meant_tpu_torch", "DEF")
_ARGS = ("Tensor q, Tensor k, Tensor v, Tensor? kmask, Tensor qcos, "
         "Tensor qsin, Tensor kcos, Tensor ksin, float scale, bool causal")
_LIB.define(f"flash_fwd({_ARGS}) -> (Tensor, Tensor, Tensor)")
_LIB.define(f"flash_fwd_lse({_ARGS}) -> (Tensor, Tensor)")


def _flash_fwd_cuda(q, k, v, kmask, qcos, qsin, kcos, ksin, scale, causal):
    """R1 (q and k rotated once), then K1: out (b, h, s_q, d) and the
    (b*h, s_q | s_k, d) Qr and Kr that K2 takes, of (b, h, s_q, d) q and
    (b, h, s_k, d) k, v; kmask (b | 1, s_k) fp32 or None; tables (s_q |
    s_k, d) fp32. Any d runs padded to `kernel_head_dim(d)`."""
    b, h, s_q, d = q.shape
    dk = kernel_head_dim(d)
    q, k, v = _flat(dk, q, k, v)
    kmask, *tables = _kernel_tables(dk, kmask, qcos, qsin, kcos, ksin)
    qr, kr = rotate_qk(q, k, *tables, head_dim=d)
    out = flash_fwd(qr, kr, v, kmask, scale=scale, causal=causal,
                    num_heads=h)
    return (_unpad(d, out).reshape(b, h, s_q, d), _unpad(d, qr),
            _unpad(d, kr))


def _flash_fwd_plain(q, k, v, kmask, qcos, qsin, kcos, ksin, scale, causal):
    b, h, s_q, d = q.shape
    qr, kr = _rotate(q, qcos, qsin), _rotate(k, kcos, ksin)
    out = _attend_scores(_scores(qr, kr, kmask, scale, causal), v)
    return (out.to(q.dtype), qr.reshape(b * h, s_q, d),
            kr.reshape(b * h, k.shape[2], d))


def _flash_fwd_fake(q, k, v, kmask, qcos, qsin, kcos, ksin, scale, causal):
    b, h, s_q, d = q.shape
    return (q.new_empty(q.shape), q.new_empty((b * h, s_q, d)),
            q.new_empty((b * h, k.shape[2], d)))


def _flash_fwd_lse_cuda(q, k, v, kmask, qcos, qsin, kcos, ksin, scale,
                        causal):
    """R1 + K3: (out (b, h, s_q, d), lse (b, h, s_q) fp32), inputs as
    `_flash_fwd_cuda`'s."""
    b, h, s_q, d = q.shape
    dk = kernel_head_dim(d)
    q, k, v = _flat(dk, q, k, v)
    kmask, *tables = _kernel_tables(dk, kmask, qcos, qsin, kcos, ksin)
    out, lse = flash_fwd_online(*rotate_qk(q, k, *tables, head_dim=d), v,
                                kmask, scale=scale, causal=causal,
                                num_heads=h)
    return _unpad(d, out).reshape(b, h, s_q, d), lse.reshape(b, h, s_q)


def _flash_fwd_lse_plain(q, k, v, kmask, qcos, qsin, kcos, ksin, scale,
                         causal):
    return flash_mha_online_reference(q, k, v, kmask, qcos, qsin, kcos,
                                      ksin, scale=scale, causal=causal)


def _flash_fwd_lse_fake(q, k, v, kmask, qcos, qsin, kcos, ksin, scale,
                        causal):
    b, h, s_q, d = q.shape
    return q.new_empty(q.shape), q.new_empty((b, h, s_q),
                                             dtype=torch.float32)


for _name, _cuda, _plain, _fake in (
        ("flash_fwd", _flash_fwd_cuda, _flash_fwd_plain, _flash_fwd_fake),
        ("flash_fwd_lse", _flash_fwd_lse_cuda, _flash_fwd_lse_plain,
         _flash_fwd_lse_fake)):
    _LIB.impl(_name, _cuda, "CUDA")
    _LIB.impl(_name, _plain, "CPU")
    torch.library.register_fake(f"meant_tpu_torch::{_name}", _fake, lib=_LIB)
flash_fwd_op = torch.ops.meant_tpu_torch.flash_fwd.default
flash_fwd_lse_op = torch.ops.meant_tpu_torch.flash_fwd_lse.default


def _backward_online(q, k, v, do, lse, delta, kmask, qcos, qsin, kcos, ksin,
                     scale, causal):
    """R1 (q and k rotated once), then K4 and K5 on the card in one call
    (`flash_bwd_dq_dkdv`); their plain versions on the CPU. q, do (b, h,
    s_q, d), k, v (b, h, s_k, d) in and gradients of their shapes out;
    lse, delta (b, h, s_q) fp32."""
    if q.device.type == "cpu":
        return flash_mha_bwd_online_reference(
            q, k, v, do, lse, delta, kmask, qcos, qsin, kcos, ksin,
            scale=scale, causal=causal)
    b, h, s_q, d = q.shape
    dk = kernel_head_dim(d)
    q_shape, k_shape = q.shape, k.shape
    q, k, v, do = _flat(dk, q, k, v, do)
    kmask, *tables = _kernel_tables(dk, kmask, qcos, qsin, kcos, ksin)
    args = (*rotate_qk(q, k, *tables, head_dim=d), v, do,
            lse.reshape(b * h, s_q).contiguous(),
            delta.reshape(b * h, s_q).contiguous(), kmask, *tables)
    kw = dict(scale=scale, causal=causal, num_heads=h, head_dim=d)
    dq, dk_, dv = flash_bwd_dq_dkdv(*args, **kw)
    return (_unpad(d, dq).reshape(q_shape), _unpad(d, dk_).reshape(k_shape),
            _unpad(d, dv).reshape(k_shape))


class _FlashAttentionOnline(torch.autograd.Function):
    """R1 + K3 forward, R1 + K4 + K5 backward: the JAX package's joint (out,
    lse) custom VJP (`_make_flash` kernel.py:800-806, 831-849, 905-934).
    Saves what JAX saves: q, k, v, the mask, the tables, out and lse (not
    the forward's Qr and Kr: the backward rotates again). The lse
    cotangent folds into delta = rowsum(dO * out) - g_lse, computed here in
    plain PyTorch as JAX computes it in XLA (:837-841); it is zero when the
    caller takes only out. The tables and the mask get no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, kmask, qcos, qsin, kcos, ksin, scale, causal):
        out, lse = flash_fwd_lse_op(q, k, v, kmask, qcos, qsin, kcos, ksin,
                                    scale, causal)
        ctx.save_for_backward(q, k, v, kmask, qcos, qsin, kcos, ksin, out,
                              lse)
        ctx.scale, ctx.causal = scale, causal
        return out, lse

    @staticmethod
    def backward(ctx, g, g_lse):
        q, k, v, kmask, qcos, qsin, kcos, ksin, out, lse = ctx.saved_tensors
        f32 = torch.float32
        delta = (g.to(f32) * out.to(f32)).sum(dim=-1) - g_lse.to(f32)
        dq, dk, dv = _backward_online(q, k, v, g, lse, delta, kmask, qcos,
                                      qsin, kcos, ksin, ctx.scale,
                                      ctx.causal)
        return dq, dk, dv, None, None, None, None, None, None, None


class _FlashAttention(torch.autograd.Function):
    """R1 + K1 forward, K2 backward (the JAX package's custom VJP,
    `_make_flash` kernel.py:851-862, 916-934). Saves what JAX saves, with
    one change on the card: v, the mask, the tables, and in place of q and
    k the Qr and Kr that R1 made for K1 (as many bytes), which K2 takes, so
    a resident call rotates once. On the CPU it saves q and k and runs the
    plain versions. The tables and the mask get no gradient (JAX returns
    zeros for them)."""

    @staticmethod
    def forward(ctx, q, k, v, kmask, qcos, qsin, kcos, ksin, scale, causal):
        out, qr, kr = flash_fwd_op(q, k, v, kmask, qcos, qsin, kcos, ksin,
                                   scale, causal)
        saved = (q, k) if q.device.type == "cpu" else (qr, kr)
        ctx.save_for_backward(*saved, v, kmask, qcos, qsin, kcos, ksin)
        ctx.scale, ctx.causal = scale, causal
        return out

    @staticmethod
    def backward(ctx, do):
        a, b_, v, kmask, qcos, qsin, kcos, ksin = ctx.saved_tensors
        kw = dict(scale=ctx.scale, causal=ctx.causal)
        if do.device.type == "cpu":     # a, b_ are q and k
            grads = flash_mha_bwd_reference(a, b_, v, do, kmask, qcos, qsin,
                                            kcos, ksin, **kw)
        else:                           # a, b_ are R1's Qr and Kr
            b, h, s_q, d = do.shape
            dk = kernel_head_dim(d)
            shapes = (do.shape, v.shape, v.shape)
            v, do = _flat(dk, v, do)
            qr, kr = (torch.nn.functional.pad(t, (0, dk - d)) if dk > d
                      else t for t in (a, b_))
            grads = flash_bwd(qr, kr, v, do,
                              *_kernel_tables(dk, kmask, qcos, qsin, kcos,
                                              ksin),
                              num_heads=h, head_dim=d, **kw)
            grads = [_unpad(d, g).reshape(shape)
                     for g, shape in zip(grads, shapes)]
        return (*grads, None, None, None, None, None, None, None)


def flash_mha(q, k, v, *, scale: float, causal: bool = False,
              attention_mask: Optional[torch.Tensor] = None,
              qcos=None, qsin=None, kcos=None, ksin=None,
              force_online: Optional[bool] = None, return_lse: bool = False):
    """Fused rotary + attention. q: (b, h, s_q, d), k/v: (b, h, s_k, d);
    the tables are (s_q, d) (qcos, qsin) and (s_k, d) (kcos, ksin) fp32
    (identity rotation when None); attention_mask: (b | 1, s_k) of {0, 1};
    causal keeps col <= row, both counted from 0, as the JAX package does.
    On the card d is any head dim >= 1, padded to `kernel_head_dim(d)`.
    `uses_online(s_k, d, force_online, return_lse)` picks the path as the
    JAX package picks it: resident (R1 + K1 forward, K2 backward on the
    forward's Qr and Kr) or streaming (R1 + K3 forward, R1 + K4 + K5
    backward). When autograd needs gradients of q, k or v the call goes
    through the path's autograd Function; otherwise (inference) it is the
    bare forward. With return_lse, returns (out, lse (b, h, s_q, 1) fp32),
    and gradients flow through both."""
    b, h, s_q, d = q.shape
    s_k = k.shape[2]
    if v.shape[2] != s_k:
        raise ValueError("flash_mha takes k and v of one sequence length")
    if q.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"flash_mha runs on CUDA or CPU, not {q.device}")
    if qcos is None:
        qcos, qsin = identity_tables(s_q, d, q.device)
    if kcos is None:
        kcos, ksin = identity_tables(s_k, d, q.device)
    kmask = None
    if attention_mask is not None:
        kmask = attention_mask.to(torch.float32)
    args = (q, k, v, kmask, qcos, qsin, kcos, ksin, scale, causal)
    grad = torch.is_grad_enabled() and any(t.requires_grad
                                           for t in (q, k, v))
    if not uses_online(s_k, d, force_online, return_lse):
        return (_FlashAttention.apply(*args) if grad
                else flash_fwd_op(*args)[0])
    out, lse = (_FlashAttentionOnline.apply(*args) if grad
                else flash_fwd_lse_op(*args))
    return (out, lse[..., None]) if return_lse else out
