"""The streaming backward's rotation pass (R1) on the CPU.

R1 rotates q and k once per backward call and hands Qr and Kr to K4 and
K5, where the JAX package's `_bwd_dq_kernel` and `_bwd_dkdv_kernel` rotate
every tile they load with `(x*cos + _rotate_half_lanes(x)*sin)
.astype(dtype)` (meant_tpu/ops/flash/kernel.py:63-71, 477-480, 548-551).
R1's plain version, `_rotate`, must give the same bits: R1 on the card is
held to `_rotate` bit for bit (tests/test_torch_cuda.py, chip_smoke.py).

Under jit, XLA's CPU backend contracts x*cos + H(x)*sin into one fused
multiply-add in fp32, which rounds once where the kernels round each
product. So the JAX side evaluates its in-kernel
rotation in interpret mode with the two products as the kernel's outputs
and their sum taken outside, each operation rounded on its own, as R1
(`__fmul_rn`, `__fadd_rn`) rounds it; and the whole jitted kernel is held
to `_rotate` bit for bit in bf16 and within two fp32 roundings in fp32.
Then the new wrapper arguments are checked before anything is launched.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from meant_tpu import ops as jops
from meant_tpu.ops.flash import kernel as jkernel
from meant_tpu.ops.flash.flash_attention import _tables as j_tables
from meant_tpu_torch.ops.flash import (flash_bwd, flash_bwd_dkdv, flash_bwd_dq,
                                       flash_fwd_online, rotate_qk)
from meant_tpu_torch.ops.flash.kernel import _rotate, identity_tables

import torch_threads

torch_threads.share_cores()

D = 96
BH = 3
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(s: int, kind: str):
    """x (BH, s, D) fp32 numpy, and the q-side tables the JAX package
    builds (xPos for the text tower, the pixel rotary for the charts)."""
    rng = np.random.RandomState(s)
    x = (rng.randn(BH, s, D) * 2.0).astype(np.float32)
    freqs = jops.lang_freqs(D // 2) if kind == "xpos" else jops.pixel_freqs(
        D // 2)
    cos, sin = (np.asarray(t) for t in j_tables(s, D, freqs, kind == "xpos",
                                                 512.0)[:2])
    return x, cos, sin


def _jax_rotation(x, cos, sin, jdt, split: bool):
    """The JAX package's in-kernel rotation of the streaming backward, run
    as a Pallas kernel in interpret mode. split: the kernel writes its two
    products x*cos and H(x)*sin (fp32) and their sum is taken outside, one
    rounding per operation; else it writes the rotation rounded to jdt."""
    s = x.shape[1]
    tab = pl.BlockSpec((s, D), lambda i: (0, 0))
    row = pl.BlockSpec((1, s, D), lambda i: (i, 0, 0))

    def body(c_ref, s_ref, x_ref, *o_refs):
        xx = x_ref[0].astype(jnp.float32)
        if split:
            o_refs[0][0] = xx * c_ref[:]
            o_refs[1][0] = jkernel._rotate_half_lanes(xx) * s_ref[:]
        else:
            o_refs[0][0] = (xx * c_ref[:] + jkernel._rotate_half_lanes(xx)
                            * s_ref[:]).astype(o_refs[0].dtype)

    out_dtypes = (jnp.float32, jnp.float32) if split else (jdt,)
    outs = jax.jit(pl.pallas_call(
        body, grid=(BH,), in_specs=[tab, tab, row],
        out_specs=[row] * len(out_dtypes),
        out_shape=[jax.ShapeDtypeStruct(x.shape, t) for t in out_dtypes],
        interpret=True))(jnp.asarray(cos), jnp.asarray(sin),
                         jnp.asarray(x).astype(jdt))
    if split:
        rotated = (outs[0] + outs[1]).astype(jdt)
        return np.asarray(rotated.astype(jnp.float32))
    return np.asarray(outs[0].astype(jnp.float32))


def _port_rotation(x, cos, sin, tdt):
    return _rotate(torch.tensor(x).to(tdt), torch.tensor(cos),
                   torch.tensor(sin)).float().numpy()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("kind", ["xpos", "pixel"])
@pytest.mark.parametrize("s", [196, 200])
def test_rotation_plain_is_jax_in_kernel_rotation(s, kind, dtype):
    """`_rotate` against the JAX kernels' rotation, one rounding per
    operation: bit for bit."""
    jdt, tdt = DTYPES[dtype]
    x, cos, sin = _inputs(s, kind)
    want = _jax_rotation(x, cos, sin, jdt, split=True)
    got = _port_rotation(x, cos, sin, tdt)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("s", [196, 200])
def test_rotation_plain_against_jitted_kernel(s, dtype):
    """`_rotate` against the interpret-mode kernel as it stands, where XLA
    fuses the products into one FMA: bf16 bit for bit, fp32 within the two
    roundings the fused form skips (2^-22 of the products' magnitudes)."""
    jdt, tdt = DTYPES[dtype]
    x, cos, sin = _inputs(s, "xpos")
    want = _jax_rotation(x, cos, sin, jdt, split=False)
    got = _port_rotation(x, cos, sin, tdt)
    if dtype == "bfloat16":
        np.testing.assert_array_equal(got, want)
    else:
        xq = torch.tensor(x).numpy()
        r = np.empty_like(xq)
        r[..., 0::2], r[..., 1::2] = -xq[..., 1::2], xq[..., 0::2]
        bound = (np.abs(xq * cos) + np.abs(r * sin)) * 2.0 ** -22
        assert np.all(np.abs(got - want) <= bound)
        assert not np.array_equal(got, want)   # the FMA is there


def _bad_inputs(bad: str):
    """q, k (or their rotations) with one wrong: kr's shape, its dtype or
    its device."""
    q = torch.zeros(4, 8, D)
    k = {"shape": torch.zeros(4, 9, D),
         "dtype": torch.zeros(4, 8, D, dtype=torch.bfloat16),
         "device": torch.zeros(4, 8, D, device="meta")}[bad]
    return q, k


@pytest.mark.parametrize("wrapper", ["rotate", "fwd_online", "bwd", "dq",
                                     "dkdv"])
@pytest.mark.parametrize("bad", ["shape", "dtype", "device"])
def test_rotated_inputs_are_checked(wrapper, bad):
    """R1's q and k, and the pre-rotated qr and kr of K3, K2, K4 and K5,
    are refused when one's shape, dtype or device differs from the
    other's, before anything is built or launched."""
    q, k = _bad_inputs(bad)
    cos, sin = identity_tables(8, D, "cpu")
    lse = torch.zeros(4, 8)
    kw = dict(scale=1.0, causal=True, num_heads=2)
    with pytest.raises(ValueError):
        if wrapper == "rotate":
            rotate_qk(q, k, cos, sin, cos, sin)
        elif wrapper == "fwd_online":
            flash_fwd_online(q, k, q, None, **kw)
        elif wrapper == "bwd":
            flash_bwd(q, k, q, q, None, cos, sin, cos, sin, **kw)
        else:
            fn = flash_bwd_dq if wrapper == "dq" else flash_bwd_dkdv
            fn(q, k, q, q, lse, lse, None, cos, sin, cos, sin, **kw)
