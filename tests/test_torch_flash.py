"""The port's flash attention on the CPU (its plain path) against the JAX
Pallas kernel run as tests/test_flash.py runs it (interpret mode on the
CPU), at head dim 96 and the bars of test_flash.py: rtol 1e-4 / atol 1e-5.
b*h is kept small: interpret mode is slow."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from meant_tpu import ops as jops
from meant_tpu.ops.flash import flash_attention as j_flash
from meant_tpu_torch.ops.flash import (flash_attention, flash_fwd,
                                       flash_mha, flash_mha_reference)
from meant_tpu_torch.ops.flash.kernel import identity_tables

import torch_threads

torch_threads.share_cores()

RTOL, ATOL = 1e-4, 1e-5


def _qkv(b, h, s, d, seed):
    rng = np.random.RandomState(seed)
    return [(rng.randn(b, h, s, d) * 0.5).astype(np.float32)
            for _ in range(3)]


def _both(q, k, v, **kw):
    freqs = kw.pop("rope_freqs", None)
    mask = kw.pop("attention_mask", None)
    t = flash_attention(
        *(torch.as_tensor(a) for a in (q, k, v)),
        rope_freqs=None if freqs is None else torch.tensor(np.asarray(freqs)),
        attention_mask=None if mask is None else torch.as_tensor(mask), **kw)
    j = j_flash(*(jnp.asarray(a) for a in (q, k, v)), rope_freqs=freqs,
                attention_mask=None if mask is None else jnp.asarray(mask),
                **kw)
    return t.numpy(), np.asarray(j)


@pytest.mark.parametrize("case", ["xpos_causal_s64", "pixel_s196",
                                  "xpos_causal_masked_s64"])
def test_flash_attention_matches_pallas(case):
    b, h, d = 2, 1, 96
    s = 196 if case == "pixel_s196" else 64
    q, k, v = _qkv(b, h, s, d, seed=len(case))
    if case == "pixel_s196":
        kw = dict(scale=1.0 / np.sqrt(d), causal=False,
                  rope_freqs=jops.pixel_freqs(48), xpos=False)
    else:
        kw = dict(scale=1.0 / np.sqrt(d * 8), causal=True,
                  rope_freqs=jops.lang_freqs(48), xpos=True)
    if case.endswith("masked_s64"):
        mask = np.ones((b, s), np.float32)
        mask[0, 40:] = 0
        mask[1, 9:] = 0
        kw["attention_mask"] = mask
    before = flash_fwd.launches
    t, j = _both(q, k, v, **kw)
    assert t.shape == (b, h, s, d)
    np.testing.assert_allclose(t, j, rtol=RTOL, atol=ATOL)
    assert flash_fwd.launches == before   # the CPU path launches nothing


def test_flash_mha_identity_tables_and_broadcast_mask():
    q, k, v = _qkv(2, 3, 20, 32, seed=7)
    mask = np.ones((1, 20), np.float32)
    mask[0, 15:] = 0
    t = flash_mha(*(torch.as_tensor(a) for a in (q, k, v)), scale=0.3,
                  causal=True, attention_mask=torch.as_tensor(mask))
    j = jops.attend(*(jnp.asarray(a) for a in (q, k, v)), scale=0.3,
                    causal=True, attention_mask=jnp.asarray(mask))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5,
                               atol=1e-6)


def test_reference_rounds_rotated_qk_to_input_dtype():
    q, k, v = (torch.as_tensor(a).to(torch.bfloat16)
               for a in _qkv(1, 2, 16, 32, seed=8))
    cos, sin = identity_tables(16, 32, "cpu")
    out = flash_mha_reference(q, k, v, None, cos, sin, cos, sin, scale=0.25,
                              causal=False)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape


@pytest.mark.parametrize("bad", ["dtype", "head_dim", "shape", "mask"])
def test_kernel_wrapper_rejects_bad_inputs(bad):
    """The wrapper checks what the kernel cannot take before it loads or
    launches anything."""
    d = 80 if bad == "head_dim" else 96
    dt = torch.float16 if bad == "dtype" else torch.float32
    qr = torch.zeros(4, 8, d, dtype=dt)
    kr = torch.zeros(4, 9, d) if bad == "shape" else qr
    kmask = torch.ones(3, 8) if bad == "mask" else None
    with pytest.raises((TypeError, ValueError)):
        flash_fwd(qr, kr, qr, kmask, scale=1.0, causal=False, num_heads=2)


def test_flash_mha_refuses_other_devices():
    q = torch.zeros(1, 1, 8, 32, device="meta")
    with pytest.raises(RuntimeError):
        flash_mha(q, q, q, scale=1.0)


@pytest.mark.parametrize("module", ["xpos", "rotary"])
def test_rotation_tables_cached_and_emptied_on_load(module):
    """A flash attention module builds its fused tables once per sequence
    length, and builds them anew from the loaded `freqs` after
    load_state_dict."""
    from meant_tpu_torch.nn.attention_modules import (RotaryAttention,
                                                      XPosAttention)
    from meant_tpu_torch.ops.flash.flash_attention import _tables
    cls = XPosAttention if module == "xpos" else RotaryAttention
    m = cls(2, 192, flash=True, device="cpu")
    x = torch.as_tensor(np.random.RandomState(9).randn(2, 24, 192)
                        .astype(np.float32))
    with torch.no_grad():
        m(x)
        first = m.rotation_tables[(24, 96, torch.device("cpu"))]
        m(x)
        assert m.rotation_tables[(24, 96, torch.device("cpu"))] is first
        assert len(m.rotation_tables) == 1
        for got, want in zip(first, _tables(24, 96, m.freqs, module == "xpos",
                                            512.0)):
            torch.testing.assert_close(got, want, rtol=0, atol=0)

        state = dict(m.state_dict(), freqs=m.freqs * 0.5)
        m.load_state_dict(state)
        assert m.rotation_tables == {}
        plain = cls(2, 192, flash=False, device="cpu")
        plain.load_state_dict(state)
        np.testing.assert_allclose(m(x).numpy(), plain(x).numpy(),
                                   rtol=1e-5, atol=1e-6)
