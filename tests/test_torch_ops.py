"""meant_tpu_torch.ops against the JAX ops they port, on the CPU in fp32 at
rtol 1e-5 / atol 1e-6. Inputs come from a numpy seed and go to both."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from meant_tpu import ops as jops
from meant_tpu.ops.flash.flash_attention import _tables as j_tables
from meant_tpu_torch import ops as tops
from meant_tpu_torch.ops.flash.flash_attention import _tables as t_tables

import torch_threads

torch_threads.share_cores()

RTOL, ATOL = 1e-5, 1e-6


def _rand(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _close(t, j, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("dim", [32, 48, 96])
def test_freq_tables(dim):
    _close(tops.lang_freqs(dim), jops.lang_freqs(dim))
    _close(tops.pixel_freqs(dim), jops.pixel_freqs(dim))


def test_rope_angles_and_rotate_half():
    pos = np.arange(37)
    freqs = jops.lang_freqs(48)
    _close(tops.rope_angles(torch.as_tensor(pos), torch.tensor(
        np.asarray(freqs))), jops.rope_angles(jnp.asarray(pos), freqs))
    x = _rand(3, 5, 48, seed=1)
    _close(tops.rotate_half(torch.as_tensor(x)),
           jops.rotate_half(jnp.asarray(x)))


@pytest.mark.parametrize("s", [1, 16, 512])
def test_xpos_scale_block_layout_centred(s):
    pos = np.arange(s)
    _close(tops.xpos_scale(48, torch.as_tensor(pos)),
           jops.xpos_scale(48, jnp.asarray(pos)))


def test_rotate_queries_and_keys_xpos():
    q, k = _rand(2, 2, 24, 96, seed=2), _rand(2, 2, 24, 96, seed=3)
    freqs = np.array(jops.lang_freqs(48))
    tq, tk = tops.rotate_queries_and_keys(torch.as_tensor(q),
                                          torch.as_tensor(k),
                                          torch.as_tensor(freqs), rot_dim=48)
    jq, jk = jops.rotate_queries_and_keys(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(freqs), rot_dim=48)
    _close(tq, jq)
    _close(tk, jk)


def test_rotate_queries_or_keys_pixel():
    x = _rand(2, 2, 196, 96, seed=4)
    freqs = np.array(jops.pixel_freqs(48))
    _close(tops.rotate_queries_or_keys(torch.as_tensor(x),
                                       torch.as_tensor(freqs)),
           jops.rotate_queries_or_keys(jnp.asarray(x), jnp.asarray(freqs)))


@pytest.mark.parametrize("p,offset", [(-1.0, False), (0.5, False),
                                      (-1.0, True)])
def test_rms_norm(p, offset):
    x, scale = _rand(4, 7, 64, seed=5), _rand(64, seed=6)
    off = _rand(64, seed=7) if offset else None
    _close(tops.rms_norm(torch.as_tensor(x), torch.as_tensor(scale),
                         None if off is None else torch.as_tensor(off), p=p),
           jops.rms_norm(jnp.asarray(x), jnp.asarray(scale),
                         None if off is None else jnp.asarray(off), p=p))


def test_layer_norm():
    x = _rand(4, 7, 64, seed=8, scale=3.0) + 2.0
    scale, off = _rand(64, seed=9), _rand(64, seed=10)
    _close(tops.layer_norm(torch.as_tensor(x), torch.as_tensor(scale),
                           torch.as_tensor(off)),
           jops.layer_norm(jnp.asarray(x), jnp.asarray(scale),
                           jnp.asarray(off)))


def test_norms_cast_back_to_input_dtype():
    x = torch.as_tensor(_rand(3, 16, seed=11)).to(torch.bfloat16)
    w = torch.ones(16)
    assert tops.rms_norm(x, w).dtype == torch.bfloat16
    assert tops.layer_norm(x, w, torch.zeros(16)).dtype == torch.bfloat16


@pytest.mark.parametrize("causal,masked", [(False, False), (True, False),
                                           (True, True), (False, True)])
def test_attend(causal, masked):
    q, k, v = (_rand(2, 3, 20, 32, seed=s, scale=0.5) for s in (12, 13, 14))
    mask = None
    if masked:
        mask = np.ones((2, 20), np.float32)
        mask[0, 13:] = 0
        mask[1, 4:] = 0
    t = tops.attend(*(torch.as_tensor(a) for a in (q, k, v)), scale=0.2,
                    causal=causal,
                    attention_mask=None if mask is None
                    else torch.as_tensor(mask))
    j = jops.attend(*(jnp.asarray(a) for a in (q, k, v)), scale=0.2,
                    causal=causal,
                    attention_mask=None if mask is None else jnp.asarray(mask))
    _close(t, j)


def test_split_merge_heads():
    x = _rand(2, 9, 12, seed=15)
    t = tops.split_heads(torch.as_tensor(x), 3)
    _close(t, jops.split_heads(jnp.asarray(x), 3))
    _close(tops.merge_heads(t), x)


def test_patchify_channel_fastest():
    img = _rand(2, 3, 32, 48, seed=16)
    _close(tops.patchify(torch.as_tensor(img), 16),
           jops.patchify(jnp.asarray(img), 16))


def test_lag_attend():
    q = _rand(3, 8, 1, 24, seed=17)
    k, v = _rand(3, 8, 5, 24, seed=18), _rand(3, 8, 5, 24, seed=19)
    _close(tops.lag_attend(*(torch.as_tensor(a) for a in (q, k, v)),
                           scale=1 / np.sqrt(24)),
           jops.lag_attend(*(jnp.asarray(a) for a in (q, k, v)),
                           scale=1 / np.sqrt(24)))


@pytest.mark.parametrize("kind,s", [("xpos", 512), ("xpos", 48),
                                    ("pixel", 196)])
def test_fused_rotation_tables(kind, s):
    freqs = np.array(jops.lang_freqs(48) if kind == "xpos"
                       else jops.pixel_freqs(48))
    xpos = kind == "xpos"
    t = t_tables(s, 96, torch.as_tensor(freqs), xpos, 512.0)
    j = j_tables(s, 96, jnp.asarray(freqs), xpos, 512.0)
    for a, b in zip(t, j):
        _close(a, b)
    # identity on the pass-through tail
    assert torch.all(t[0][:, 48:] == 1) and torch.all(t[1][:, 48:] == 0)


@pytest.mark.parametrize("variant,dim", [("src", 1541), ("paper", 64)])
def test_temporal_attention_module(variant, dim):
    """The lag attention module at shared weights, including the uneven
    src geometry (1541 = 8 * 192 + 5)."""
    import jax
    from meant_tpu.nn.attention_modules import TemporalAttention as JTA
    from meant_tpu_torch.nn.attention_modules import TemporalAttention
    from meant_tpu_torch.weights import state_dict_from_jax

    x = _rand(3, 5, dim, seed=20)
    jm = JTA(8, dim, variant=variant, init_style="xavier")
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    tm = TemporalAttention(8, dim, variant=variant, init_style="xavier")
    tm.load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray,
                                                        params)))
    with torch.no_grad():
        t = tm(torch.as_tensor(x))
    j = jax.jit(lambda p, x_: jm.apply({"params": p}, x_))(params,
                                                          jnp.asarray(x))
    assert t.shape == j.shape
    _close(t, j, rtol=1e-5, atol=1e-5)
