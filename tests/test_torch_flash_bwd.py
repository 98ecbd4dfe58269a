"""The port's flash backward on the CPU against the JAX package.

* Gradients of q, k, v through the port's `flash_attention` (on the CPU:
  K1's and K2's plain versions behind the autograd Function) against
  `jax.grad` through `meant_tpu.ops.flash.flash_attention`, whose custom
  VJP runs the Pallas backward `_bwd_kernel` in interpret mode on the CPU,
  as tests/test_flash.py runs it. fp32 bars of test_flash.py: rtol 1e-4 /
  atol 1e-5. b*h is small: interpret mode is slow.
* `flash_mha_bwd_reference` (K2's plain version, step by step as
  `_bwd_kernel`) against torch autograd of `flash_mha_reference`: the same
  math in another order, rtol 1e-5 / atol 1e-6.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from meant_tpu import ops as jops
from meant_tpu.ops.flash import flash_attention as j_flash
from meant_tpu_torch.ops import lang_freqs, pixel_freqs
from meant_tpu_torch.ops.flash import (flash_attention, flash_bwd,
                                       flash_fwd, flash_mha,
                                       flash_mha_bwd_reference,
                                       flash_mha_reference)
from meant_tpu_torch.ops.flash.flash_attention import _tables
from meant_tpu_torch.ops.flash.kernel import identity_tables

import torch_threads

torch_threads.share_cores()

D = 96


def _case(case: str, seed: int):
    """(q, k, v, do) numpy, the flash_attention keywords, and the mask."""
    b, h = 2, 1
    s = 196 if case == "pixel_s196" else 64
    rng = np.random.RandomState(seed)
    q, k, v, do = [(rng.randn(b, h, s, D) * 0.5).astype(np.float32)
                   for _ in range(4)]
    if case == "pixel_s196":
        kw = dict(scale=1.0 / np.sqrt(D), causal=False,
                  rope_freqs=jops.pixel_freqs(48), xpos=False)
    else:
        kw = dict(scale=1.0 / np.sqrt(D * 8), causal=True,
                  rope_freqs=jops.lang_freqs(48), xpos=True)
    mask = None
    if case == "xpos_causal_masked_s64":
        mask = np.ones((b, s), np.float32)
        mask[0, 40:] = 0
        mask[1, 9:] = 0
    return (q, k, v, do), kw, mask


@pytest.mark.parametrize("case", ["xpos_causal_masked_s64", "pixel_s196"])
def test_flash_attention_grads_match_pallas_backward(case):
    (q, k, v, do), kw, mask = _case(case, seed=len(case))
    freqs = kw.pop("rope_freqs")

    def j_loss(q_, k_, v_):
        out = j_flash(q_, k_, v_, rope_freqs=freqs,
                      attention_mask=None if mask is None
                      else jnp.asarray(mask), **kw)
        return jnp.sum(out * jnp.asarray(do))

    j_grads = jax.grad(j_loss, argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in (q, k, v)))

    leaves = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    before = (flash_fwd.launches, flash_bwd.launches)
    out = flash_attention(
        *leaves, rope_freqs=torch.tensor(np.asarray(freqs)),
        attention_mask=None if mask is None else torch.as_tensor(mask), **kw)
    assert out.grad_fn is not None
    out.backward(torch.as_tensor(do))
    assert (flash_fwd.launches, flash_bwd.launches) == before  # CPU path
    for name, t, j in zip(("dq", "dk", "dv"), leaves, j_grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j), rtol=1e-4,
                                   atol=1e-5, err_msg=name)


@pytest.mark.parametrize("case", ["xpos_causal_masked", "pixel",
                                  "identity_broadcast_mask", "bf16"])
def test_bwd_reference_matches_autograd_of_forward(case):
    s = 37 if case == "pixel" else 24
    rng = np.random.RandomState(11)
    dtype = torch.bfloat16 if case == "bf16" else torch.float32
    q, k, v, do = (torch.as_tensor(rng.randn(2, 3, s, D).astype(np.float32))
                   .to(dtype) for _ in range(4))
    causal = case != "pixel"
    mask = None
    if case == "pixel":
        tables = _tables(s, D, pixel_freqs(48), False, 512.0)
    elif case == "identity_broadcast_mask":
        tables = identity_tables(s, D, "cpu") * 2
        mask = torch.ones(1, s)
        mask[0, 17:] = 0
    else:
        tables = _tables(s, D, lang_freqs(48), True, 512.0)
        mask = torch.as_tensor((rng.rand(2, s) > 0.3).astype(np.float32))
        mask[:, 0] = 1
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    flash_mha_reference(*leaves, mask, *tables, scale=0.2,
                        causal=causal).backward(do)
    got = flash_mha_bwd_reference(q, k, v, do, mask, *tables, scale=0.2,
                                  causal=causal)
    for name, g, t in zip(("dq", "dk", "dv"), got, leaves):
        assert g.dtype == dtype
        if dtype == torch.float32:
            np.testing.assert_allclose(g.numpy(), t.grad.numpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=name)
        else:
            # autograd of the bf16 forward rounds the softmax output and
            # dP at other places than the kernel: one bf16 step (2^-8)
            np.testing.assert_allclose(g.float().numpy(),
                                       t.grad.float().numpy(), rtol=2e-2,
                                       atol=2e-2, err_msg=name)


def test_flash_mha_without_grad_is_the_bare_forward():
    q = torch.zeros(1, 1, 8, D, requires_grad=True)
    with torch.no_grad():
        assert flash_mha(q, q, q, scale=1.0).grad_fn is None
    assert flash_mha(q, q, q, scale=1.0).grad_fn is not None
    assert flash_mha(q.detach(), q.detach(), q.detach(),
                     scale=1.0).grad_fn is None


@pytest.mark.parametrize("bad", ["dtype", "head_dim", "do_shape", "mask"])
def test_backward_wrapper_rejects_bad_inputs(bad):
    """K2's wrapper checks what the kernel cannot take before it loads or
    launches anything."""
    d = 80 if bad == "head_dim" else D
    dt = torch.float16 if bad == "dtype" else torch.float32
    q = torch.zeros(4, 8, d, dtype=dt)
    do = torch.zeros(4, 9, d) if bad == "do_shape" else q
    cos, sin = identity_tables(8, d, "cpu")
    kmask = torch.ones(3, 8) if bad == "mask" else None
    with pytest.raises((TypeError, ValueError)):
        flash_bwd(q, q, q, do, kmask, cos, sin, cos, sin, scale=1.0,
                  causal=False, num_heads=2)
