"""The premise of the port's flash kernels, on the CPU: the rotation
factors out of the JAX package's kernels.

The port rotates q and k once per call (R1, whose plain version is
`_rotate`) and hands Qr and Kr to K1 (resident forward), K3 (streaming
forward) and K2 (resident backward, on K1's Qr and Kr), which rotate
nothing; the rotation's adjoint stays in K2's epilogue. Here the JAX
package's `_flash_fwd`, `_flash_fwd_online` and `_flash_bwd`
(meant_tpu/ops/flash/kernel.py, interpret mode, jitted) run once with the
rotation tables and once on pre-rotated inputs with identity tables
(cos = 1, sin = 0, an exact no-op), the backward's dq and dk then taken
through `_adjoint`.

Which rotation. Under jit, XLA's CPU backend fuses the in-kernel
x*cos + H(x)*sin into one multiply-add in fp32 (tests/
test_torch_flash_rotate.py), so the bits the kernels feed their products
are those of that fused form. Pre-rotated by the same in-kernel
arithmetic (`_jax_rotate`, a Pallas kernel in interpret mode), the
factored form gives out (both forwards), lse and dv bit for bit in fp32
and bf16. Against
`_rotate`, which rounds each product as R1 and the TPU kernels do, fp32
moves by the fused form's rounding only (rtol 1e-5 / atol 1e-5 on out, 1e-5
on lse; read: 4.4e-6 and 1.9e-6 at s=200). bf16 is not compared with
`_rotate` here: where the fused fp32 value sits on a bf16 rounding
boundary the two round a rotated element one bf16 step apart (read: 0.0156
on one k element at s=200), a difference of the CPU's fusion, not of the
factoring.
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
from meant_tpu_torch.ops.flash.kernel import _adjoint, _rotate

import torch_threads

torch_threads.share_cores()

D = 96
S = 200
B, H = 2, 2                      # kmask rows, heads: BH = 4
SCALE = 1.0 / np.sqrt(D * 8)     # 1/sqrt(dim), as both towers take it
BLOCK_Q, BLOCK_K = 50, 40        # several blocks of each, both divide S
DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
CASES = ["xpos_causal", "xpos_causal_masked", "pixel"]


def _case(case: str, seed: int):
    """numpy q, k, v, dO (BH, S, D) fp32, the four tables, the (B, S) key
    mask (row 1 fully masked) or None, and causal."""
    rng = np.random.RandomState(seed)
    q, k, v, do = [(rng.randn(B * H, S, D) * 2.0).astype(np.float32)
                   for _ in range(4)]
    xpos = case.startswith("xpos")
    freqs = jops.lang_freqs(D // 2) if xpos else jops.pixel_freqs(D // 2)
    tables = [np.asarray(t) for t in j_tables(S, D, freqs, xpos, 512.0)]
    mask = None
    if case.endswith("masked"):
        mask = (rng.rand(B, S) > 0.3).astype(np.float32)
        mask[0, 0] = 1.0
        mask[1] = 0.0
    return (q, k, v, do), tables, mask, xpos


def _identity():
    return [jnp.ones((S, D), jnp.float32), jnp.zeros((S, D), jnp.float32)]


def _jax_rotate(x, cos, sin):
    """The JAX kernels' in-kernel rotation, (x*cos + H(x)*sin).astype(dtype)
    (meant_tpu/ops/flash/kernel.py:152-155, 340-341), as a Pallas kernel in
    interpret mode, jitted as the attention kernels are."""
    tab = pl.BlockSpec((S, D), lambda i: (0, 0))
    row = pl.BlockSpec((1, S, D), lambda i: (i, 0, 0))

    def body(c_ref, s_ref, x_ref, o_ref):
        xx = x_ref[0].astype(jnp.float32)
        o_ref[0] = (xx * c_ref[:] + jkernel._rotate_half_lanes(xx)
                    * s_ref[:]).astype(o_ref.dtype)

    return jax.jit(pl.pallas_call(
        body, grid=(x.shape[0],), in_specs=[tab, tab, row], out_specs=row,
        out_shape=jax.ShapeDtypeStruct(x.shape, x.dtype),
        interpret=True))(jnp.asarray(cos), jnp.asarray(sin), x)


def _port_rotate(x, cos, sin, jdt):
    """`_rotate` (R1's plain version) on a JAX array, back as one."""
    t = torch.tensor(np.asarray(x.astype(jnp.float32)))
    if jdt == jnp.bfloat16:
        t = t.to(torch.bfloat16)
    return jnp.asarray(_rotate(t, torch.tensor(cos), torch.tensor(sin))
                       .float().numpy()).astype(jdt)


def _forward(q, k, v, tables, mask, causal):
    """JAX's streaming forward: (out, lse) as fp32 numpy."""
    fn = jax.jit(lambda *a: jkernel._flash_fwd_online(
        *a[:3], None if mask is None else jnp.asarray(mask), *a[3:],
        scale=SCALE, causal=causal, num_heads=H, block_q=BLOCK_Q,
        block_k=BLOCK_K, interpret=True))
    out, lse = fn(q, k, v, *map(jnp.asarray, tables))
    return np.asarray(out.astype(jnp.float32)), np.asarray(lse)


def _resident_forward(q, k, v, tables, mask, causal):
    """JAX's resident forward (`_fwd_kernel`): out as fp32 numpy."""
    fn = jax.jit(lambda *a: jkernel._flash_fwd(
        *a[:3], None if mask is None else jnp.asarray(mask), *a[3:],
        scale=SCALE, causal=causal, num_heads=H, block_q=BLOCK_Q,
        interpret=True))
    return np.asarray(fn(q, k, v, *map(jnp.asarray, tables))
                      .astype(jnp.float32))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", CASES)
def test_resident_forward_on_prerotated_inputs_is_bitwise(case, dtype):
    """K1's premise (R1, then a resident forward that rotates nothing):
    `_fwd_kernel` with the tables, and the same kernel on q and k
    pre-rotated by its own rotation with identity tables, give out bit for
    bit (a fully masked batch row included)."""
    jdt = DTYPES[dtype]
    (q, k, v, _), tables, mask, causal = _case(case, seed=len(case) + 3)
    q, k, v = (jnp.asarray(a).astype(jdt) for a in (q, k, v))
    want = _resident_forward(q, k, v, tables, mask, causal)
    qr, kr = _jax_rotate(q, *tables[:2]), _jax_rotate(k, *tables[2:])
    got = _resident_forward(qr, kr, v, _identity() * 2, mask, causal)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", CASES)
def test_resident_forward_on_rotate_matches_in_fp32(case):
    """The same with q and k pre-rotated by `_rotate` (R1's bits) in fp32:
    the fused form's rounding only, rtol 1e-5 / atol 1e-5."""
    (q, k, v, _), tables, mask, causal = _case(case, seed=len(case) + 3)
    q, k, v = (jnp.asarray(a) for a in (q, k, v))
    want = _resident_forward(q, k, v, tables, mask, causal)
    qr = _port_rotate(q, *tables[:2], jnp.float32)
    kr = _port_rotate(k, *tables[2:], jnp.float32)
    got = _resident_forward(qr, kr, v, _identity() * 2, mask, causal)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", CASES)
def test_streaming_forward_on_prerotated_inputs_is_bitwise(case, dtype):
    """K3's premise: `_fwd_online_kernel` with the tables, and the same
    kernel on q and k pre-rotated by its own rotation with identity
    tables, give out and lse bit for bit (a fully masked batch row
    included)."""
    jdt = DTYPES[dtype]
    (q, k, v, _), tables, mask, causal = _case(case, seed=len(case))
    q, k, v = (jnp.asarray(a).astype(jdt) for a in (q, k, v))
    want = _forward(q, k, v, tables, mask, causal)
    qr, kr = _jax_rotate(q, *tables[:2]), _jax_rotate(k, *tables[2:])
    got = _forward(qr, kr, v, _identity() * 2, mask, causal)
    for name, a, b in zip(("out", "lse"), got, want):
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("case", CASES)
def test_streaming_forward_on_rotate_matches_in_fp32(case):
    """The same with q and k pre-rotated by `_rotate` (R1's bits) in fp32:
    the fused form's rounding only, rtol 1e-5 / atol 1e-5 on out, 1e-5 on
    lse."""
    (q, k, v, _), tables, mask, causal = _case(case, seed=len(case))
    q, k, v = (jnp.asarray(a) for a in (q, k, v))
    want = _forward(q, k, v, tables, mask, causal)
    qr = _port_rotate(q, *tables[:2], jnp.float32)
    kr = _port_rotate(k, *tables[2:], jnp.float32)
    out, lse = _forward(qr, kr, v, _identity() * 2, mask, causal)
    np.testing.assert_allclose(out, want[0], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(lse, want[1], rtol=0, atol=1e-5)


@pytest.mark.parametrize("case", CASES)
def test_resident_backward_on_prerotated_inputs_then_adjoint(case):
    """K2's premise, fp32: `_bwd_kernel` with the tables, against the same
    kernel on pre-rotated q and k with identity tables, dq and dk then
    through `_adjoint`. dv bit for bit; dq and dk within 4 ulps of each
    gradient's largest element (the adjoint applied to the summed dKr in
    torch, per q block inside the kernel, in another rounding order; read:
    1 to 2 ulps)."""
    (q, k, v, do), tables, mask, causal = _case(case, seed=len(case) + 7)
    q, k, v, do = (jnp.asarray(a) for a in (q, k, v, do))
    km = None if mask is None else jnp.asarray(mask)
    fn = jax.jit(lambda *a: jkernel._flash_bwd(
        *a[:4], km, *a[4:], scale=SCALE, causal=causal, num_heads=H,
        block_q=BLOCK_Q, interpret=True))
    want = [np.asarray(g) for g in fn(q, k, v, do, *map(jnp.asarray, tables))]
    qr, kr = _jax_rotate(q, *tables[:2]), _jax_rotate(k, *tables[2:])
    dqr, dkr, dv = (torch.tensor(np.asarray(g))
                    for g in fn(qr, kr, v, do, *_identity() * 2))
    cos = [torch.tensor(t) for t in tables]
    got = [_adjoint(dqr, cos[0], cos[1]).numpy(),
           _adjoint(dkr, cos[2], cos[3]).numpy(), dv.numpy()]
    np.testing.assert_array_equal(got[2], want[2], err_msg="dv")
    for name, a, b in zip(("dq", "dk"), got, want):
        ulp = np.spacing(np.abs(b).max())
        assert np.abs(a - b).max() <= 4 * ulp, (name, np.abs(a - b).max())
