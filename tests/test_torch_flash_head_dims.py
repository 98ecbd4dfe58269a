"""Flash attention at every head dim, on the CPU against the JAX package:
odd head dims and head dims past 128.

* `flash_mha` forward and `jax.grad` through JAX's Pallas kernels
  (interpret mode, as tests/test_torch_flash_shapes.py runs them) at head
  dims 7, 95, 130, 192, 256, 384 and 768: plain, and causal with xPos
  tables and a key mask; on the resident path and forced onto the
  streaming one; and at 160 on the streaming one (160, 192 and 256 are
  the widths whose K4 and K5 run the wgmma bodies on the card, and 192,
  256, 384 and 768 those whose K1 and K3 do, held there to these plain
  versions). The bars of test_torch_flash.py: rtol 1e-4 / atol 1e-5.
* `XPosAttention` and `RotaryAttention` with flash=True at width 190 in 2
  heads and 760 in 8 (d = 95): output and the gradients of the input and
  every projection against JAX's modules at shared weights, 1e-4.
* The reference behaviour at an odd head dim, pinned in both packages: the
  lane rotate-half wraps lane d-1 onto lane 0, so the flash backward's
  adjoint adds sin[0] g[0] to column d-1 of dq and dk, which the forward
  has no counterpart of (sin is 0 there). At d = 7 the port's flash
  gradient equals JAX's, and each package's flash gradient differs from its
  plain path's (rotation + `attend`) only in that column.
* `rotate_half_lanes` equals the pairwise `rotate_half` bit for bit at
  even head dims.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from meant_tpu import ops as jops
from meant_tpu.nn.attention_modules import RotaryAttention as JRotary
from meant_tpu.nn.attention_modules import XPosAttention as JXPos
from meant_tpu.ops.flash import flash_attention as j_flash_attention
from meant_tpu.ops.flash import kernel as jkernel
from meant_tpu.ops.flash.flash_attention import _tables as j_tables
from meant_tpu_torch import ops as tops
from meant_tpu_torch.nn.attention_modules import (RotaryAttention,
                                                  XPosAttention)
from meant_tpu_torch.ops.flash import flash_attention, flash_mha
from meant_tpu_torch.ops.flash.kernel import rotate_half_lanes
from meant_tpu_torch.ops.rotary import rotate_half
from meant_tpu_torch.weights import state_dict_from_jax

import torch_threads

torch_threads.share_cores()

RTOL, ATOL = 1e-4, 1e-5
B, H, S = 1, 2, 16


def _case(d, variant, seed):
    """numpy q, k, v, dO (B, H, S, d), the kwargs of both flash_mha's
    (tables as numpy) and the (B, S) mask or None."""
    rng = np.random.RandomState(seed)
    q, k, v = ((rng.randn(B, H, S, d) * 0.7).astype(np.float32)
               for _ in range(3))
    do = rng.randn(B, H, S, d).astype(np.float32)
    kw = dict(scale=1.0 / np.sqrt(d * 2), causal=variant == "causal_xpos")
    mask = None
    if variant == "causal_xpos":
        t = [np.asarray(x) for x in j_tables(S, d, jops.lang_freqs(d // 2),
                                             True, 512.0)]
        kw.update(qcos=t[0], qsin=t[1], kcos=t[2], ksin=t[3])
        mask = np.ones((B, S), np.float32)
        mask[0, S - 5:] = 0.0
    return (q, k, v, do), kw, mask


def _jax_grads(q, k, v, do, kw, mask, **extra):
    jkw = {n: (jnp.asarray(x) if isinstance(x, np.ndarray) else x)
           for n, x in kw.items()}
    jm = None if mask is None else jnp.asarray(mask)

    @jax.jit
    def grads(q, k, v, do):
        out, vjp = jax.vjp(lambda *a: jkernel.flash_mha(
            *a, attention_mask=jm, **jkw, **extra), q, k, v)
        return (out, *vjp(do))

    return [np.asarray(x) for x in grads(*(jnp.asarray(a)
                                          for a in (q, k, v, do)))]


def _port_grads(q, k, v, do, kw, mask, **extra):
    tkw = {n: (torch.tensor(x) if isinstance(x, np.ndarray) else x)
           for n, x in kw.items()}
    leaves = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    out = flash_mha(*leaves, attention_mask=None if mask is None
                    else torch.tensor(mask), **tkw, **extra)
    grads = torch.autograd.grad(out, leaves, torch.tensor(do))
    return [out.detach().numpy()] + [g.numpy() for g in grads]


@pytest.mark.parametrize("path", ["resident", "streaming"])
@pytest.mark.parametrize("variant", ["plain", "causal_xpos"])
@pytest.mark.parametrize("d", [7, 95, 130, 192, 256, 384, 768])
def test_flash_mha_matches_pallas_at_every_head_dim(d, variant, path):
    (q, k, v, do), kw, mask = _case(d, variant, seed=d)
    extra = {"force_online": path == "streaming"}
    want = _jax_grads(q, k, v, do, kw, mask, **extra)
    got = _port_grads(q, k, v, do, kw, mask, **extra)
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("variant", ["plain", "causal_xpos"])
def test_flash_mha_matches_pallas_streaming_at_d160(variant):
    """d = 160, padded to 192 on the card, where K4 and K5 take the wgmma
    bodies: the streaming path against JAX's."""
    test_flash_mha_matches_pallas_at_every_head_dim(160, variant,
                                                    "streaming")


@pytest.mark.parametrize("width,heads", [(190, 2), (760, 8)])
@pytest.mark.parametrize("module", ["xpos", "rotary"])
def test_attention_modules_with_flash_at_odd_head_dims(module, width, heads):
    """The flash-on modules at d = 95, which raised on the CPU before the
    plain versions took JAX's lane rotate-half."""
    rng = np.random.RandomState(width + heads)
    x = (rng.randn(1, 12, width) * 0.5).astype(np.float32)
    dy = rng.randn(1, 12, width).astype(np.float32)
    jcls, tcls = (JXPos, XPosAttention) if module == "xpos" else (
        JRotary, RotaryAttention)
    jm = jcls(num_heads=heads, dim=width, flash=True)
    params = jax.tree.map(np.asarray, jax.jit(
        jcls(num_heads=heads, dim=width).init)(
        jax.random.PRNGKey(1), jnp.asarray(x))["params"])

    def loss(p, x_):
        y = jm.apply({"params": p}, x_)
        return jnp.sum(y * dy), y

    (_, y), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))
    tm = tcls(num_heads=heads, dim=width, flash=True, device="cpu")
    tm.load_state_dict(state_dict_from_jax(params))
    xt = torch.tensor(x, requires_grad=True)
    out = tm(xt)
    out.backward(torch.as_tensor(dy))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(y),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), rtol=1e-4,
                               atol=1e-4)
    want = state_dict_from_jax(jax.tree.map(np.asarray, gp))
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   rtol=1e-4, atol=1e-4, err_msg=name)


def test_odd_head_dim_flash_gradient_wraps_as_the_reference_does():
    """d = 7 with rotary on 4 features, s = 16, causal: the flash forward
    equals the plain path's in both packages; dv too; dq and dk differ
    from the plain path's only in column 6, by sin[0] g[0] of the lanes'
    wrap (ROADMAP §3); the port's flash gradient is JAX's."""
    d, s = 7, 16
    rng = np.random.RandomState(7)
    q, k, v = ((rng.randn(1, 2, s, d) * 0.7).astype(np.float32)
               for _ in range(3))
    do = rng.randn(1, 2, s, d).astype(np.float32)
    jf = jops.lang_freqs(4)
    kw = dict(scale=0.4, causal=True)

    def j_flash(q, k, v):
        return j_flash_attention(q, k, v, rope_freqs=jf, **kw)

    def j_plain(q, k, v):
        return jops.attend(jops.rotate_queries_or_keys(q, jf),
                           jops.rotate_queries_or_keys(k, jf), v, **kw)

    def jax_side(f):
        @jax.jit
        def grads(q, k, v, do):
            out, vjp = jax.vjp(f, q, k, v)
            return (out, *vjp(do))

        return [np.asarray(x) for x in grads(*(jnp.asarray(a)
                                              for a in (q, k, v, do)))]

    tf = torch.tensor(np.asarray(jf))

    def port_side(f):
        leaves = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
        out = f(*leaves)
        return [out.detach().numpy()] + [
            g.numpy() for g in torch.autograd.grad(out, leaves,
                                                   torch.tensor(do))]

    jflash, jplain = jax_side(j_flash), jax_side(j_plain)
    tflash = port_side(lambda q, k, v: flash_attention(q, k, v,
                                                       rope_freqs=tf, **kw))
    tplain = port_side(lambda q, k, v: tops.attend(
        tops.rotate_queries_or_keys(q, tf),
        tops.rotate_queries_or_keys(k, tf), v, **kw))
    for name, a, b in zip(("out", "dq", "dk", "dv"), tflash, jflash):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL, err_msg=name)
    for flash, plain in ((jflash, jplain), (tflash, tplain)):
        np.testing.assert_allclose(flash[0], plain[0], rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(flash[3], plain[3], rtol=RTOL, atol=ATOL)
        for g in (1, 2):
            np.testing.assert_allclose(flash[g][..., :d - 1],
                                       plain[g][..., :d - 1], rtol=RTOL,
                                       atol=ATOL)
            gap = np.abs(flash[g][..., d - 1] - plain[g][..., d - 1]).max()
            assert gap > 0.1, gap


@pytest.mark.parametrize("d", [2, 48, 96, 128])
def test_rotate_half_lanes_is_the_pairwise_form_at_even_d(d):
    x = torch.tensor(np.random.RandomState(d).randn(3, 5, d)
                     .astype(np.float32))
    assert torch.equal(rotate_half_lanes(x), rotate_half(x))
    assert torch.equal(rotate_half_lanes(x.to(torch.bfloat16)),
                       rotate_half(x.to(torch.bfloat16)))
