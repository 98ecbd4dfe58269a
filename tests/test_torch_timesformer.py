"""The TimeSformer family in the port against the JAX package on the CPU:
the (sin, cos) rotary helpers, token_shift, TSAttention (with 257-key
groups through JAX's interpret-mode flash kernel, forward and gradients),
TimeSformer unrolled,
scanned, rematerialised, with the token shift and with the learned
positions, `stack_timesformer_params`, a scanned JAX checkpoint loaded into
the port, meant_timesformer, meant_mean_pooling, meant_mosi, MOSI's audio
encoder, and one training step's gradients of meant_timesformer against
jax.grad.

Numpy inputs and JAX's params (through `weights.load_jax_params`) go
through both packages in fp32. Bars: ops 1e-6 (the frame tables) and 1e-5,
module outputs and probabilities 1e-4, gradients 1e-4 relative L2 per
parameter (plus 1e-8 absolute for an exactly zero gradient).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from meant_tpu import models as J
from meant_tpu import ops as jops
from meant_tpu.models.meant_timesformer import AudioEncoder as JAudio
from meant_tpu.models.meant_timesformer import _permute1d_pe
from meant_tpu.nn import stack as jstack
from meant_tpu.nn import timesformer as jts
from meant_tpu.train.classify import sigmoid_ce_loss as j_loss
from meant_tpu_torch import models as P
from meant_tpu_torch import ops
from meant_tpu_torch.models.meant_timesformer import (AudioEncoder,
                                                      permute1d_pe)
from meant_tpu_torch.nn import stack
from meant_tpu_torch.nn import timesformer as pts
from meant_tpu_torch.train.classify import sigmoid_ce_loss
from meant_tpu_torch.weights import load_jax_params, state_dict_from_jax

import torch_threads

torch_threads.share_cores()

B, LAG = 2, 5


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax(module, *args, method_kwargs=None, **kwargs):
    a = [jnp.asarray(x) for x in args]
    kw = {k: jnp.asarray(v) for k, v in kwargs.items()}
    extra = method_kwargs or {}
    params = jax.jit(lambda key, *t, **k: module.init(key, *t, **k, **extra))(
        jax.random.PRNGKey(5), *a, **kw)["params"]
    out = jax.jit(lambda p: module.apply({"params": p}, *a, **kw,
                                         **extra))(params)
    return _np(params), np.asarray(out, np.float32)


def _port(module, params, *args, method_kwargs=None, **kwargs):
    load_jax_params(module, params)
    module.eval()
    with torch.no_grad():
        out = module(*(torch.as_tensor(x) for x in args),
                     **{k: torch.as_tensor(v) for k, v in kwargs.items()},
                     **(method_kwargs or {}))
    return out.float().numpy()


@pytest.mark.parametrize("dim,h,w", [(64, 2, 2), (16, 3, 5), (64, 1, 20)])
def test_rotary_sincos_tables_match_jax(dim, h, w):
    # the axial angles reach 5 pi, where one fp32 step is 9.5e-7: the two
    # packages space the scales one or two steps apart
    for got, want in zip(ops.axial_rotary_sincos(dim, h, w),
                         jops.axial_rotary_sincos(dim, h, w)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    for got, want in zip(ops.frame_rotary_sincos(dim, w),
                         jops.frame_rotary_sincos(dim, w)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_apply_rot_emb_sincos_matches_jax():
    rng = np.random.RandomState(0)
    q, k = (rng.randn(6, 5, 64).astype(np.float32) for _ in range(2))
    sin, cos = (np.array(t) for t in jops.frame_rotary_sincos(48, 5))
    want = jops.apply_rot_emb_sincos(jnp.asarray(q), jnp.asarray(k), sin,
                                     cos)
    got = ops.apply_rot_emb_sincos(torch.as_tensor(q), torch.as_tensor(k),
                                   torch.as_tensor(sin), torch.as_tensor(cos))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)


def test_token_shift_matches_jax():
    x = np.random.RandomState(1).randn(2, 1 + 3 * 4, 14).astype(np.float32)
    np.testing.assert_array_equal(
        pts.token_shift(torch.as_tensor(x), 3).numpy(),
        np.asarray(jts.token_shift(jnp.asarray(x), 3)))


@pytest.mark.parametrize("space", [True, False], ids=["space", "time"])
def test_ts_attention_matches_jax(space):
    rng = np.random.RandomState(2)
    f, n = 3, 4
    x = rng.randn(B, 1 + f * n, 32).astype(np.float32)
    rot = (jops.axial_rotary_sincos(16, 2, 2) if space
           else jops.frame_rotary_sincos(16, f))
    call = dict(group_size=n if space else f, num_groups=f if space else n,
                group_axis_first=space)
    params, want = _jax(jts.TSAttention(32, dim_head=16, heads=2), x,
                        method_kwargs=dict(call, rot_sincos=rot))
    got = _port(pts.TSAttention(32, dim_head=16, heads=2, device="cpu"),
                params, x, method_kwargs=dict(call, rot_sincos=tuple(
                    torch.as_tensor(np.asarray(t)) for t in rot)))
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_ts_attention_flash_group_of_257_keys_matches_jax():
    """A space group of 256 patches and the cls key (257 keys) with
    flash=True: JAX's interpret-mode flash_mha against the port's plain
    version on the CPU."""
    x = np.random.RandomState(3).randn(1, 1 + 256, 64).astype(np.float32)
    call = dict(group_size=256, num_groups=1, group_axis_first=True,
                rot_sincos=None)
    params, want = _jax(jts.TSAttention(64, dim_head=64, heads=1,
                                        flash=True), x, method_kwargs=call)
    got = _port(pts.TSAttention(64, dim_head=64, heads=1, flash=True,
                                device="cpu"), params, x,
                method_kwargs=call)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_ts_attention_flash_groups_of_257_keys_gradients_match_jax():
    """Space attention over two frames of 256 patches (groups of 256
    queries and 257 keys) with flash=True and the axial rotary, at narrow
    widths: the output and the gradients of x and of every parameter
    through JAX's interpret-mode flash_mha (jax.vjp) against the port's
    flash_mha on the CPU, 1e-4 (output: rtol 1e-4 / atol 1e-5; gradients:
    relative L2 per tensor)."""
    rng = np.random.RandomState(12)
    x = rng.randn(1, 1 + 2 * 256, 32).astype(np.float32)
    dout = rng.randn(*x.shape).astype(np.float32)
    rot = jops.axial_rotary_sincos(16, 16, 16)
    call = dict(group_size=256, num_groups=2, group_axis_first=True)
    jm = jts.TSAttention(32, dim_head=16, heads=2, flash=True)
    params = jax.jit(lambda key, xx: jm.init(key, xx, rot_sincos=rot,
                                             **call))(
        jax.random.PRNGKey(7), jnp.asarray(x))["params"]

    @jax.jit
    def forward_and_vjp(p, xx, g):
        out, vjp = jax.vjp(lambda p_, x_: jm.apply({"params": p_}, x_,
                                                   rot_sincos=rot, **call),
                           p, xx)
        return (out, *vjp(g))

    out, g_params, g_x = forward_and_vjp(params, jnp.asarray(x),
                                         jnp.asarray(dout))
    module = pts.TSAttention(32, dim_head=16, heads=2, flash=True,
                             device="cpu")
    load_jax_params(module, _np(params))
    xt = torch.tensor(x, requires_grad=True)
    got = module(xt, rot_sincos=tuple(torch.as_tensor(np.asarray(t))
                                      for t in rot), **call)
    got.backward(torch.as_tensor(dout))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out),
                               rtol=1e-4, atol=1e-5)
    want = state_dict_from_jax(_np(g_params))
    pairs = [("x", xt.grad.numpy(), np.asarray(g_x))]
    pairs += [(n, p.grad.numpy(), want[n].numpy())
              for n, p in module.named_parameters()]
    for name, a, b in pairs:
        assert np.linalg.norm(a - b) <= 1e-4 * np.linalg.norm(b), name


TS = dict(dim=64, num_frames=LAG, num_classes=3, image_size=32,
          patch_size=16, channels=3, depth=2, heads=4, dim_head=16)


def _video(seed=4, size=32):
    return np.random.RandomState(seed).randn(B, LAG, 3, size, size).astype(
        np.float32)


@pytest.mark.parametrize("kw", [
    {}, {"scan_layers": True}, {"scan_layers": True, "remat": "full"},
    {"shift_tokens": True}, {"rotary_emb": False}],
    ids=["unrolled", "scan", "scan_remat", "shift_tokens", "pos_emb"])
@pytest.mark.parametrize("tokens", [False, True], ids=["logits", "tokens"])
def test_timesformer_matches_jax(kw, tokens):
    video = _video()
    call = {"return_tokens": tokens}
    params, want = _jax(jts.TimeSformer(**TS, **kw), video,
                        method_kwargs=call)
    assert ("layers_scan" in params) == bool(kw.get("scan_layers"))
    # a JAX model asked only for tokens builds no classifier head
    model = pts.TimeSformer(**TS, **kw, head=not tokens, device="cpu")
    got = _port(model, params, video, method_kwargs=call)
    np.testing.assert_allclose(got, want, atol=1e-4)
    assert model.remat == ((kw.get("remat") or "dots")
                           if kw.get("scan_layers") else None)


def test_timesformer_remat_step_matches_plain_step():
    """A scanned TimeSformer rematerialises its layers in training: the
    loss and gradients equal those of the same weights without remat."""
    torch.manual_seed(0)
    video = torch.as_tensor(_video(5))
    grads = []
    for kw in ({}, {"scan_layers": True, "remat": "full"}):
        model = pts.TimeSformer(**TS, **kw, device="cpu", seed=1).train()
        model(video).sum().backward()
        grads.append({n: p.grad for n, p in model.named_parameters()})
    for name, g in grads[0].items():
        torch.testing.assert_close(grads[1][name], g, rtol=1e-5, atol=1e-7)


def test_stack_timesformer_params_match_jax():
    params, _ = _jax(jts.TimeSformer(**TS), _video())
    got = stack.stack_timesformer_params(params, TS["depth"])
    want = _np(jstack.stack_timesformer_params(params, TS["depth"]))
    flat_got = state_dict_from_jax({"t": got})
    flat_want = state_dict_from_jax({"t": want})
    assert set(flat_got) == set(flat_want)
    for k in flat_want:
        assert torch.equal(flat_got[k], flat_want[k]), k
    back = stack.unstack_timesformer_params(got)
    assert set(back) == set(params)


GEOM = dict(text_dim=192, image_dim=64, price_dim=5, height=32, width=32,
            patch_res=16, lag=LAG, num_classes=2, num_heads=2,
            num_encoders=2, channels=3, seq_len=24)
JEMB = J.EmbeddingConfig(vocab_size=100, hidden_size=192,
                         max_position_embeddings=40, dropout=0.0)
PEMB = P.EmbeddingConfig(vocab_size=100, hidden_size=192,
                         max_position_embeddings=40, dropout=0.0)
S = 20


def _src_batch(seed=6):
    rng = np.random.RandomState(seed)
    ids = rng.randint(2, 100, (B, LAG, S)).astype(np.int32)
    ids[1, 2, 11:] = 1
    return {"input_ids": ids, "pixels": _video(seed + 1),
            "prices": rng.randn(B, LAG, 5).astype(np.float32),
            "attention_mask": (ids != 1).astype(np.float32)}


@pytest.mark.parametrize("name,kw", [
    ("meant_timesformer", {}), ("meant_timesformer", {"flash": True}),
    ("meant_mean_pooling", {}), ("meant_mean_pooling", {"fixed_proj": True})],
    ids=["timesformer", "timesformer_flash", "mean_pooling",
         "mean_pooling_fixed_proj"])
def test_timesformer_family_matches_jax(name, kw):
    batch = _src_batch()
    params, want = _jax(getattr(J, name)(embedding=JEMB, **GEOM, **kw),
                        **batch)
    got = _port(getattr(P, name)(embedding=PEMB, device="cpu", **GEOM, **kw),
                params, **batch)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_scanned_jax_checkpoint_loads_into_the_port():
    """JAX's meant_timesformer with scan_layers (languageEncoders_scan and
    the TimeSformer's layers_scan) loads into the port's one module per
    block, scanned or not, with the same probabilities."""
    batch = _src_batch(8)
    params, want = _jax(J.meant_timesformer(embedding=JEMB, scan_layers=True,
                                            **GEOM), **batch)
    assert "languageEncoders_scan" in params
    assert "layers_scan" in params["timesformer"]
    for scan in (True, False):
        got = _port(P.meant_timesformer(embedding=PEMB, scan_layers=scan,
                                        device="cpu", **GEOM), params,
                    **batch)
        np.testing.assert_allclose(got, want, atol=1e-4)


def _mosi_batch(seed=9, frames=10, mask_tail=True):
    rng = np.random.RandomState(seed)
    audio_mask = np.ones((B, frames), np.float32)
    if mask_tail:
        audio_mask[0, 6:] = 0
    return {"input_ids": rng.randn(B, frames, 192).astype(np.float32),
            "pixels": rng.randn(B, frames, 20).astype(np.float32),
            "audio": rng.randn(B, frames, 130).astype(np.float32),
            "audio_mask": audio_mask}


@pytest.mark.parametrize("fusion", [False, True],
                         ids=["audio_discarded", "audio_fused"])
@pytest.mark.parametrize("flash", [False, True], ids=["plain", "flash"])
def test_meant_mosi_matches_jax(fusion, flash):
    """meant_mosi on pre-embedded text (xPos on 30 of 96 features), with
    the flash path on or off and the audio in the fusion or not."""
    batch = _mosi_batch()
    kw = dict(text_dim=192, image_dim=64, lag=10, num_heads=2,
              num_encoders=2, use_audio_in_fusion=fusion,
              flash=flash)
    params, want = _jax(J.meant_mosi(**kw), **batch)
    model = P.meant_mosi(device="cpu", **kw)
    assert model.languageEncoders[0].attn.rot_dim == 30
    got = _port(model, params, **batch)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("quirk", [True, False],
                         ids=["torch_mask_quirk", "mask_attends_valid"])
def test_audio_encoder_matches_jax(quirk):
    batch = _mosi_batch(10)
    audio, mask = batch["audio"], batch["audio_mask"]
    params, want = _jax(JAudio(torch_mask_quirk=quirk), audio, mask)
    got = _port(AudioEncoder(torch_mask_quirk=quirk, device="cpu"), params,
                audio, mask)
    np.testing.assert_allclose(got, want, atol=1e-4)
    # angles up to 129 rad: one fp32 step of the angle is 7.6e-6
    np.testing.assert_allclose(permute1d_pe(11, 130).numpy(),
                               np.asarray(_permute1d_pe(11, 130)), atol=1e-5)


def test_meant_timesformer_step_gradients_match_jax_grad():
    """One step's loss and gradients (dropout off in both: JAX's
    deterministic apply, the port in eval mode; flash on) against
    jax.grad, relative L2 1e-4 per parameter."""
    batch = _src_batch(11)
    y = np.array([1, 0], np.int32)
    jm = J.meant_timesformer(embedding=JEMB, flash=True, **GEOM)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    params = jax.jit(jm.init)(jax.random.PRNGKey(6), **jb)["params"]

    def loss_fn(p):
        return j_loss(jm.apply({"params": p}, **jb), jnp.asarray(y))

    j_value, j_grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    want = state_dict_from_jax(_np(j_grads))
    model = P.meant_timesformer(embedding=PEMB, flash=True, device="cpu",
                                **GEOM)
    load_jax_params(model, _np(params))
    model.eval()
    loss = sigmoid_ce_loss(model(**{k: torch.as_tensor(v)
                                    for k, v in batch.items()}),
                           torch.as_tensor(y))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(j_value), rtol=1e-6)
    named = dict(model.named_parameters())
    assert set(named) == {k for k in want if "freqs" not in k}
    for name, p in named.items():
        got, ref = p.grad.numpy(), want[name].numpy()
        assert (np.linalg.norm(got - ref)
                <= 1e-4 * np.linalg.norm(ref) + 1e-8), name
