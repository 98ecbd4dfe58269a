"""Flash attention at head dims other than 96 and with more keys than
queries, on the CPU against the JAX package.

* `flash_mha` forward and `jax.grad` through JAX's Pallas kernels
  (interpret mode, as tests/test_flash.py runs them) at head dims 48, 64
  and 128 and at (s_q, s_k) = (20, 21) and (70, 71): plain, and causal with
  xPos tables of each length and a key mask. The bars of
  test_torch_flash.py: rtol 1e-4 / atol 1e-5.
* The padding the card's wrapper applies (`kernel_head_dim`: a d up to
  128, odd or even, goes to the next of 64, 96, 128, one past 128 to the
  next multiple of 64, with zero columns and identity table entries)
  changes nothing at an even d: the plain versions on padded inputs,
  sliced back, against the same on the caller's d (fp32 sums of extra
  zero terms: rtol 1e-6 / atol 1e-7).
* R1's premise at d = 64 and 128 (tests/test_torch_flash_prerotated.py's
  check at 96): JAX's resident forward on q and k pre-rotated by its own
  rotation with identity tables gives out bit for bit, and its backward dv
  bit for bit and dq, dk through `_adjoint` within 4 ulps.
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
from meant_tpu_torch.ops.flash import flash_mha
from meant_tpu_torch.ops.flash import kernel as tkernel
from meant_tpu_torch.ops.flash.kernel import (_adjoint, _flat,
                                              _kernel_tables, _unpad,
                                              flash_mha_bwd_reference,
                                              flash_mha_reference,
                                              kernel_head_dim)

import torch_threads

torch_threads.share_cores()

RTOL, ATOL = 1e-4, 1e-5
B, H = 2, 2


def _case(d, s_q, s_k, variant, seed):
    """numpy q (B, H, s_q, d), k, v (B, H, s_k, d), dO, the kwargs of both
    flash_mha's (tables as numpy), and the (B, s_k) mask or None."""
    rng = np.random.RandomState(seed)
    q = (rng.randn(B, H, s_q, d) * 0.7).astype(np.float32)
    k, v = ((rng.randn(B, H, s_k, d) * 0.7).astype(np.float32)
            for _ in range(2))
    do = rng.randn(B, H, s_q, d).astype(np.float32)
    kw = dict(scale=1.0 / np.sqrt(d * 4), causal=variant == "causal_xpos")
    mask = None
    if variant == "causal_xpos":
        freqs = jops.lang_freqs(d // 2)
        qt = [np.asarray(t) for t in j_tables(s_q, d, freqs, True, 512.0)]
        kt = [np.asarray(t) for t in j_tables(s_k, d, freqs, True, 512.0)]
        kw.update(qcos=qt[0], qsin=qt[1], kcos=kt[2], ksin=kt[3])
        mask = np.ones((B, s_k), np.float32)
        mask[1, s_k // 2:] = 0.0
    return (q, k, v, do), kw, mask


def _jax_side(q, k, v, do, kw, mask):
    jkw = {n: (jnp.asarray(x) if isinstance(x, np.ndarray) else x)
           for n, x in kw.items()}
    jm = None if mask is None else jnp.asarray(mask)

    def f(q, k, v):
        return jkernel.flash_mha(q, k, v, attention_mask=jm, **jkw)

    qkv = [jnp.asarray(a) for a in (q, k, v)]
    out, vjp = jax.vjp(f, *qkv)
    return [np.asarray(out)] + [np.asarray(g) for g in vjp(jnp.asarray(do))]


def _port_side(q, k, v, do, kw, mask):
    tkw = {n: (torch.tensor(x) if isinstance(x, np.ndarray) else x)
           for n, x in kw.items()}
    leaves = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    out = flash_mha(*leaves, attention_mask=None if mask is None
                    else torch.tensor(mask), **tkw)
    grads = torch.autograd.grad(out, leaves, torch.tensor(do))
    return [out.detach().numpy()] + [g.numpy() for g in grads]


@pytest.mark.parametrize("variant", ["plain", "causal_xpos"])
@pytest.mark.parametrize("lengths", [(20, 21), (70, 71)])
@pytest.mark.parametrize("d", [48, 64, 128])
def test_flash_mha_matches_pallas_at_head_dims_and_lengths(d, lengths,
                                                           variant):
    s_q, s_k = lengths
    (q, k, v, do), kw, mask = _case(d, s_q, s_k, variant, seed=d + s_q)
    want = _jax_side(q, k, v, do, kw, mask)
    got = _port_side(q, k, v, do, kw, mask)
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("d,padded", [(48, 64), (64, 64), (80, 96),
                                      (100, 128), (128, 128)])
def test_kernel_head_dim_pads_to_the_next_instantiation_exactly(d, padded):
    """The card's padding, run through the plain versions on the CPU: the
    forward and backward of the padded call, sliced back, equal the call at
    d."""
    assert kernel_head_dim(d) == padded
    (q, k, v, do), kw, mask = _case(d, 33, 40, "causal_xpos", seed=d)
    q, k, v, do = (torch.tensor(a) for a in (q, k, v, do))
    tables = [torch.tensor(kw[n]) for n in ("qcos", "qsin", "kcos", "ksin")]
    km = torch.tensor(mask)
    args = dict(scale=kw["scale"], causal=True)
    want = [flash_mha_reference(q, k, v, km, *tables, **args),
            *flash_mha_bwd_reference(q, k, v, do, km, *tables, **args)]
    pq, pk, pv, pdo = (t.reshape(B, H, *t.shape[1:])
                       for t in _flat(padded, q, k, v, do))
    pm, *ptables = _kernel_tables(padded, km, *tables)
    got = [flash_mha_reference(pq, pk, pv, pm, *ptables, **args),
           *flash_mha_bwd_reference(pq, pk, pv, pdo, pm, *ptables, **args)]
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        assert a.shape[-1] == padded
        torch.testing.assert_close(_unpad(d, a), b, rtol=1e-6, atol=1e-7,
                                   msg=name)


@pytest.mark.parametrize("d,width", [(0, None), (-3, None), (7, 64),
                                     (95, 96), (63, 64), (127, 128),
                                     (129, 192), (255, 256), (130, 192),
                                     (192, 192), (768, 768), (48, 64),
                                     (96, 96), (128, 128)])
def test_kernel_head_dim_routes_every_positive_d(d, width):
    """Every d >= 1 reaches a kernel on the card: a d up to 128, odd or
    even, pads to the next of HEAD_DIMS (an odd d's backwards wrap in the
    epilogues of those bodies), one past 128 to the next multiple of 64;
    only d <= 0 raises."""
    if width is None:
        with pytest.raises(ValueError, match="positive"):
            kernel_head_dim(d)
    else:
        assert kernel_head_dim(d) == width


def test_flash_mha_cpu_path_launches_nothing_at_other_shapes():
    (q, k, v, _), kw, _ = _case(48, 20, 21, "plain", seed=3)
    before = {n: w.launches for n, w in (("K1", tkernel.flash_fwd),
                                         ("R1", tkernel.rotate_qk))}
    out = flash_mha(*(torch.tensor(a) for a in (q, k, v)), **kw)
    assert out.shape == (B, H, 20, 48)
    assert tkernel.flash_fwd.launches == before["K1"]
    assert tkernel.rotate_qk.launches == before["R1"]


# ---- R1's premise at head dims 64 and 128 ---------------------------------

S = 150
BLOCK_Q = 50


def _jax_rotate(x, cos, sin):
    """The JAX kernels' in-kernel rotation as a Pallas kernel in interpret
    mode, jitted (test_torch_flash_prerotated.py's, at any head dim)."""
    s, d = cos.shape
    tab = pl.BlockSpec((s, d), lambda i: (0, 0))
    row = pl.BlockSpec((1, s, d), lambda i: (i, 0, 0))

    def body(c_ref, s_ref, x_ref, o_ref):
        xx = x_ref[0].astype(jnp.float32)
        o_ref[0] = (xx * c_ref[:] + jkernel._rotate_half_lanes(xx)
                    * s_ref[:]).astype(o_ref.dtype)

    return jax.jit(pl.pallas_call(
        body, grid=(x.shape[0],), in_specs=[tab, tab, row], out_specs=row,
        out_shape=jax.ShapeDtypeStruct(x.shape, x.dtype),
        interpret=True))(jnp.asarray(cos), jnp.asarray(sin), x)


def _prerotated_case(d, seed):
    rng = np.random.RandomState(seed)
    q, k, v, do = [(rng.randn(B * H, S, d) * 2.0).astype(np.float32)
                   for _ in range(4)]
    tables = [np.asarray(t) for t in j_tables(S, d, jops.lang_freqs(d // 2),
                                              True, 512.0)]
    mask = (rng.rand(B, S) > 0.3).astype(np.float32)
    mask[:, 0] = 1.0
    identity = [jnp.ones((S, d), jnp.float32), jnp.zeros((S, d), jnp.float32)]
    return (q, k, v, do), tables, jnp.asarray(mask), identity


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [64, 128])
def test_resident_forward_on_prerotated_inputs_is_bitwise_at(d, dtype):
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    (q, k, v, _), tables, mask, identity = _prerotated_case(d, seed=d)
    q, k, v = (jnp.asarray(a).astype(jdt) for a in (q, k, v))
    fn = jax.jit(lambda *a: jkernel._flash_fwd(
        *a[:3], mask, *a[3:], scale=1.0 / np.sqrt(d * 8), causal=True,
        num_heads=H, block_q=BLOCK_Q, interpret=True))
    want = np.asarray(fn(q, k, v, *map(jnp.asarray, tables))
                      .astype(jnp.float32))
    qr, kr = _jax_rotate(q, *tables[:2]), _jax_rotate(k, *tables[2:])
    got = np.asarray(fn(qr, kr, v, *identity * 2).astype(jnp.float32))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("d", [64, 128])
def test_resident_backward_on_prerotated_inputs_then_adjoint_at(d):
    (q, k, v, do), tables, mask, identity = _prerotated_case(d, seed=d + 1)
    q, k, v, do = (jnp.asarray(a) for a in (q, k, v, do))
    fn = jax.jit(lambda *a: jkernel._flash_bwd(
        *a[:4], mask, *a[4:], scale=1.0 / np.sqrt(d * 8), causal=True,
        num_heads=H, block_q=BLOCK_Q, interpret=True))
    want = [np.asarray(g) for g in fn(q, k, v, do, *map(jnp.asarray, tables))]
    qr, kr = _jax_rotate(q, *tables[:2]), _jax_rotate(k, *tables[2:])
    dqr, dkr, dv = (torch.tensor(np.asarray(g))
                    for g in fn(qr, kr, v, do, *identity * 2))
    tab = [torch.tensor(t) for t in tables]
    got = [_adjoint(dqr, tab[0], tab[1]).numpy(),
           _adjoint(dkr, tab[2], tab[3]).numpy(), dv.numpy()]
    np.testing.assert_array_equal(got[2], want[2], err_msg="dv")
    for name, a, b in zip(("dq", "dk"), got, want):
        ulp = np.spacing(np.abs(b).max())
        assert np.abs(a - b).max() <= 4 * ulp, (name, np.abs(a - b).max())
