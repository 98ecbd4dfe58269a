"""The port's streaming flash path on the CPU against the JAX package.

The port's `flash_mha(force_online=True, return_lse=True)` (on the CPU: the
plain versions of K3, K4 and K5 behind the joint (out, lse) autograd
Function) against the JAX package's, whose streaming Pallas kernels
`_fwd_online_kernel`, `_bwd_dq_kernel` and `_bwd_dkdv_kernel` run in
interpret mode on the CPU, as tests/test_flash.py runs them. fp32 bars of
test_flash.py: rtol 1e-4 / atol 1e-5. Lengths: a ragged s=200 and s=3200,
where JAX's own rule already takes the streaming path at head dim 96;
b*h is kept small, since interpret mode is slow. Then the routing rule,
the fully masked batch row (where the two paths differ), the XPos module
at s=3200 and a narrow meant_src at s=4100 against `jax.grad` at shared
weights.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from meant_tpu import ops as jops
from meant_tpu.models import EmbeddingConfig as JEmb
from meant_tpu.models.meant_src import meant_src as JMeantSrc
from meant_tpu.nn.attention_modules import XPosAttention as JXPos
from meant_tpu.ops.flash import kernel as jkernel
from meant_tpu.ops.flash.flash_attention import _tables as j_tables
from meant_tpu.train.classify import sigmoid_ce_loss as j_loss
from meant_tpu_torch.data.loader import host_tensor
from meant_tpu_torch.models import EmbeddingConfig, meant_src
from meant_tpu_torch.nn.attention_modules import XPosAttention
from meant_tpu_torch.ops import pixel_freqs
from meant_tpu_torch.ops.flash import (flash_bwd_dkdv, flash_bwd_dq,
                                       flash_fwd, flash_fwd_online,
                                       flash_mha,
                                       flash_mha_bwd_online_reference,
                                       flash_mha_online_reference,
                                       uses_online)
from meant_tpu_torch.ops.flash.flash_attention import _tables
from meant_tpu_torch.ops.flash.kernel import (
    _rotate, flash_mha_online_tiled_reference, identity_tables)
from meant_tpu_torch.train.classify import sigmoid_ce_loss
from meant_tpu_torch.weights import load_jax_params, state_dict_from_jax

import torch_threads

torch_threads.share_cores()

D = 96
RTOL, ATOL = 1e-4, 1e-5
COUNTERS = (flash_fwd, flash_fwd_online, flash_bwd_dq, flash_bwd_dkdv)


def _tables_both(kind: str, s: int, d: int = D):
    """The rotation tables as numpy, built by the JAX package."""
    if kind == "identity":
        return None
    freqs = (jops.pixel_freqs if kind == "pixel" else jops.lang_freqs)(
        d // 2)
    return [np.array(t) for t in j_tables(s, d, freqs, kind == "xpos",
                                           512.0)]


def _case(case: str, seed: int):
    """numpy inputs of one streaming call: q, k, v, dO, dlse, the tables,
    the mask and the keywords."""
    kind, masked, s = case.split("_")
    s = int(s[1:])
    b = 1 if s > 1000 else 2
    rng = np.random.RandomState(seed)
    q, k, v, do = [(rng.randn(b, 1, s, D) * 0.5).astype(np.float32)
                   for _ in range(4)]
    dlse = rng.randn(b, 1, s, 1).astype(np.float32)
    mask = None
    if masked == "masked":
        mask = (rng.rand(b, s) > 0.3).astype(np.float32)
        mask[:, 0] = 1.0
    causal = kind == "xpos"
    scale = 1.0 / np.sqrt(D * 8) if causal else 1.0 / np.sqrt(D)
    return (q, k, v, do, dlse), _tables_both(kind, s), mask, dict(
        scale=scale, causal=causal)


def _jax_online(q, k, v, do, dlse, tables, mask, kw, force_online=True,
                return_lse=True):
    """JAX out, lse and the gradients of sum(out * dO) + sum(lse * dlse)."""
    tab = {} if tables is None else dict(zip(("qcos", "qsin", "kcos",
                                              "ksin"), tables))

    def loss(q_, k_, v_):
        res = jkernel.flash_mha(
            q_, k_, v_, attention_mask=None if mask is None
            else jnp.asarray(mask), force_online=force_online,
            return_lse=return_lse, **tab, **kw)
        out, lse = res if return_lse else (res, jnp.zeros_like(dlse))
        return jnp.sum(out * do) + jnp.sum(lse * dlse), (out, lse)

    (_, (out, lse)), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(q, k, v)
    return [np.asarray(a) for a in (out, lse, *grads)]


def _port_online(q, k, v, do, dlse, tables, mask, kw, force_online=True,
                 return_lse=True):
    tab = {} if tables is None else dict(zip(
        ("qcos", "qsin", "kcos", "ksin"), map(torch.as_tensor, tables)))
    leaves = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    res = flash_mha(*leaves, attention_mask=None if mask is None
                    else torch.as_tensor(mask), force_online=force_online,
                    return_lse=return_lse, **tab, **kw)
    out, lse = res if return_lse else (res, torch.zeros(dlse.shape))
    assert out.grad_fn is not None
    torch.autograd.backward((out, lse) if return_lse else (out,),
                            (torch.as_tensor(do), torch.as_tensor(dlse))
                            if return_lse else (torch.as_tensor(do),))
    return [out.detach().numpy(), lse.detach().numpy(),
            *(t.grad.numpy() for t in leaves)]


@pytest.mark.parametrize("case", ["xpos_plain_s200", "xpos_masked_s200",
                                  "pixel_plain_s200", "pixel_masked_s200",
                                  "xpos_plain_s3200", "pixel_masked_s3200"])
def test_online_out_lse_and_grads_match_pallas(case):
    """out, lse and dq, dk, dv through a loss on both out and lse (a
    non-zero lse cotangent), causal xPos and pixel rotary, with and without
    a key mask."""
    inputs, tables, mask, kw = _case(case, seed=len(case))
    want = _jax_online(*inputs, tables, mask, kw)
    before = [c.launches for c in COUNTERS]
    got = _port_online(*inputs, tables, mask, kw)
    assert [c.launches for c in COUNTERS] == before   # the CPU path
    assert got[1].shape == inputs[0].shape[:3] + (1,)
    for name, a, b in zip(("out", "lse", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL,
                                   err_msg=name)


@pytest.mark.parametrize("s,d", [(2048, 96), (3185, 96), (3186, 96),
                                 (4096, 96), (4097, 96), (4096, 32),
                                 (4097, 32)])
def test_uses_online_routes_as_jax(monkeypatch, s, d):
    """The port's rule against the path the JAX package's flash_mha takes
    (the `online` it builds its kernel with), with no force_online, with
    force_online False and True, and with return_lse."""
    taken = []

    def spy(*args, online=False, **kwargs):
        taken.append(bool(online))
        raise StopIteration

    monkeypatch.setattr(jkernel, "_make_flash", spy)
    x = jnp.zeros((1, 1, s, d), jnp.float32)
    for force, lse in ((None, False), (False, False), (True, False),
                       (None, True)):
        with pytest.raises(StopIteration):
            jkernel.flash_mha(x, x, x, scale=1.0, causal=True,
                              force_online=force, return_lse=lse)
        assert uses_online(s, d, force, lse) == taken[-1], (force, lse)
    assert taken[0] == (s >= 3186 if d == 96 else s > 4096)


def test_fully_masked_row_gets_the_streaming_dv():
    """A batch row whose keys are all masked: every score rounds to -1e9,
    and so does the streaming path's lse, so its backward takes P = 1 for
    every key where the resident one takes 1/s. The port follows each path
    of the JAX package: online dv is s times the resident dv on that row,
    the same on the other row."""
    s = 64
    rng = np.random.RandomState(5)
    q, k, v, do = [(rng.randn(2, 1, s, D) * 0.5).astype(np.float32)
                   for _ in range(4)]
    dlse = np.zeros((2, 1, s, 1), np.float32)
    mask = np.ones((2, s), np.float32)
    mask[1] = 0.0
    kw = dict(scale=1.0 / np.sqrt(D), causal=False)
    tables = _tables_both("pixel", s)
    dv = {}
    for online in (True, False):
        want = _jax_online(q, k, v, do, dlse, tables, mask, kw,
                           force_online=online, return_lse=False)
        got = _port_online(q, k, v, do, dlse, tables, mask, kw,
                           force_online=online, return_lse=False)
        for name, a, b in zip(("out", "dq", "dk", "dv"),
                              got[:1] + got[2:], want[:1] + want[2:]):
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL,
                                       err_msg=f"{name} online={online}")
        dv[online] = got[4]
    np.testing.assert_allclose(dv[True][1], s * dv[False][1], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(dv[True][0], dv[False][0], rtol=1e-4,
                               atol=1e-6)


@pytest.mark.parametrize("case", ["xpos_causal_masked", "pixel",
                                  "identity_broadcast_mask"])
def test_bwd_online_reference_matches_autograd_of_forward(case):
    """K4 + K5's plain version against torch autograd of K3's plain version
    through both out and lse (delta = rowsum(dO * out) - g_lse): the same
    math in another order, rtol 1e-5 / atol 1e-5 (gradients up to 7 in size
    read 4e-6 apart: fp32 rounding of the lse term's own sums)."""
    s = 37 if case == "pixel" else 24
    rng = np.random.RandomState(13)
    q, k, v, do = (torch.as_tensor(rng.randn(2, 3, s, D).astype(np.float32))
                   for _ in range(4))
    g_lse = torch.as_tensor(rng.randn(2, 3, s).astype(np.float32))
    causal = case != "pixel"
    mask = None
    if case == "pixel":
        tables = _tables(s, D, pixel_freqs(48), False, 512.0)
    elif case == "identity_broadcast_mask":
        tables = identity_tables(s, D, "cpu") * 2
        mask = torch.ones(1, s)
        mask[0, 17:] = 0
    else:
        tables = [torch.as_tensor(t) for t in _tables_both("xpos", s)]
        mask = torch.as_tensor((rng.rand(2, s) > 0.3).astype(np.float32))
        mask[:, 0] = 1
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out, lse = flash_mha_online_reference(*leaves, mask, *tables, scale=0.2,
                                          causal=causal)
    torch.autograd.backward((out, lse), (do, g_lse))
    delta = (do * out.detach()).sum(-1) - g_lse
    got = flash_mha_bwd_online_reference(q, k, v, do, lse.detach(), delta,
                                         mask, *tables, scale=0.2,
                                         causal=causal)
    for name, g, t in zip(("dq", "dk", "dv"), got, leaves):
        np.testing.assert_allclose(g.numpy(), t.grad.numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=name)


def test_online_lse_is_the_row_log_sum_exp():
    """Zero q and k, causal: row i has i + 1 zero scores, so lse = log(i+1)
    and out is the mean of v's first i + 1 rows."""
    q = torch.zeros(1, 1, 4, 8)
    v = torch.arange(32.0).reshape(1, 1, 4, 8)
    cos, sin = identity_tables(4, 8, "cpu")
    out, lse = flash_mha_online_reference(q, q, v, None, cos, sin, cos, sin,
                                          scale=1.0, causal=True)
    np.testing.assert_allclose(lse.numpy()[0, 0], np.log(np.arange(1, 5)),
                               rtol=1e-6)
    want = np.cumsum(v.numpy()[0, 0], 0) / np.arange(1, 5)[:, None]
    np.testing.assert_allclose(out.numpy()[0, 0], want, rtol=1e-6)


def _rel_l2(a, b) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["xpos_masked_s200", "pixel_plain_s200"])
def test_online_tiled_reference_rounds_as_the_streaming_kernel(case, dtype):
    """K3's plain version in the kernel's order
    (`flash_mha_online_tiled_reference`) against `_fwd_online_kernel` in
    interpret mode at block_k = 64, K3's tile (s=200: three full tiles and a
    ragged one), on the same pre-rotated q and k with identity tables. fp32:
    out at rtol 1e-4 / atol 1e-5, lse at 1e-5. bf16: both round the
    unnormalised P at the running max, out within 1e-3 relative L2 of JAX's
    (read: 9.1e-5 and 3.3e-5, the CPU's exp and sums);
    `flash_mha_online_reference` rounds the normalised P and reads 2.9e-3
    and 2.7e-3, past the bar."""
    inputs, tables, mask, kw = _case(case, seed=len(case) + 21)
    b, _, s, _ = inputs[0].shape
    tdt = getattr(torch, dtype)
    cos, sin = identity_tables(s, D, "cpu")
    q, k, v = (torch.as_tensor(a * 4.0).to(tdt) for a in inputs[:3])
    if tables is not None:
        tabs = [torch.as_tensor(t) for t in tables]
        q, k = _rotate(q, *tabs[:2]), _rotate(k, *tabs[2:])
    tmask = None if mask is None else torch.as_tensor(mask)
    got, got_lse = flash_mha_online_tiled_reference(
        q, k, v, tmask, cos, sin, cos, sin, **kw)
    untiled, _ = flash_mha_online_reference(q, k, v, tmask, cos, sin, cos,
                                            sin, **kw)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    j = [jnp.asarray(t.float().numpy()).astype(jdt).reshape(b, s, D)
         for t in (q, k, v)]
    eye = [jnp.asarray(t.numpy()) for t in (cos, sin)] * 2
    out, lse = jax.jit(lambda *a: jkernel._flash_fwd_online(
        *a, None if mask is None else jnp.asarray(mask), *eye,
        num_heads=1, block_q=40, block_k=64, interpret=True, **kw))(*j)
    want = np.asarray(out.astype(jnp.float32)).reshape(b, 1, s, D)
    got, untiled = (t.float().numpy() for t in (got, untiled))
    np.testing.assert_allclose(got_lse.numpy(),
                               np.asarray(lse).reshape(b, 1, s), rtol=0,
                               atol=1e-5)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    else:
        assert _rel_l2(got, want) <= 1e-3
        assert _rel_l2(untiled, want) > 2e-3


def test_online_without_grad_is_the_bare_forward():
    q = torch.zeros(1, 2, 8, D, requires_grad=True)
    with torch.no_grad():
        out, lse = flash_mha(q, q, q, scale=1.0, force_online=True,
                             return_lse=True)
    assert out.grad_fn is None and lse.shape == (1, 2, 8, 1)
    out = flash_mha(q, q, q, scale=1.0, force_online=True)
    assert type(out.grad_fn).__name__ == "_FlashAttentionOnlineBackward"
    out = flash_mha(q, q, q, scale=1.0)
    assert type(out.grad_fn).__name__ == "_FlashAttentionBackward"


@pytest.mark.parametrize("wrapper", ["fwd", "dq", "dkdv"])
@pytest.mark.parametrize("bad", ["dtype", "head_dim", "lse_shape",
                                 "lse_dtype"])
def test_online_wrappers_reject_bad_inputs(wrapper, bad):
    """K3's, K4's and K5's wrappers check what the kernels cannot take
    before they load or launch anything."""
    if wrapper == "fwd" and bad.startswith("lse"):
        bad = "mask"
    d = 80 if bad == "head_dim" else D
    dt = torch.float16 if bad == "dtype" else torch.float32
    q = torch.zeros(4, 8, d, dtype=dt)
    cos, sin = identity_tables(8, d, "cpu")
    lse = torch.zeros(4, 9) if bad == "lse_shape" else torch.zeros(
        4, 8, dtype=torch.float64 if bad == "lse_dtype" else torch.float32)
    kw = dict(scale=1.0, causal=False, num_heads=2)
    with pytest.raises((TypeError, ValueError)):
        if wrapper == "fwd":
            kmask = torch.ones(3, 8) if bad == "mask" else None
            flash_fwd_online(q, q, q, kmask, **kw)
        else:
            fn = flash_bwd_dq if wrapper == "dq" else flash_bwd_dkdv
            fn(q, q, q, q, lse, lse, None, cos, sin, cos, sin, **kw)


def test_xpos_attention_s3200_matches_jax():
    """XPosAttention at dim 96, one head, s=3200 with flash: JAX's rule and
    the port's take the streaming path; output, and the gradients of the
    input and every projection, against jax.grad at shared weights."""
    s, dim = 3200, 96
    rng = np.random.RandomState(21)
    x = (rng.randn(1, s, dim) * 0.5).astype(np.float32)
    dy = rng.randn(1, s, dim).astype(np.float32)
    jm = JXPos(num_heads=1, dim=dim, flash=True)
    params = jax.tree.map(np.asarray, jax.jit(
        JXPos(num_heads=1, dim=dim).init)(
        jax.random.PRNGKey(3), jnp.asarray(x[:, :8]))["params"])

    def loss(p, x_):
        y = jm.apply({"params": p}, x_)
        return jnp.sum(y * dy), y

    (_, y), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))
    assert uses_online(s, dim)
    tm = XPosAttention(num_heads=1, dim=dim, flash=True, device="cpu")
    tm.load_state_dict(state_dict_from_jax(params))
    xt = torch.tensor(x, requires_grad=True)
    out = tm(xt)
    out.backward(torch.as_tensor(dy))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(y),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), rtol=RTOL,
                               atol=ATOL)
    want = state_dict_from_jax(jax.tree.map(np.asarray, gp))
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   rtol=RTOL, atol=1e-4, err_msg=name)


SRC_GEOM = dict(text_dim=32, image_dim=32, price_dim=5, height=32, width=32,
                patch_res=16, lag=2, num_classes=2, num_heads=1,
                num_encoders=1, channels=3, seq_len=4100)
SRC_EMB = dict(vocab_size=100, hidden_size=32, max_position_embeddings=12,
               dropout=0.0)


def test_narrow_meant_src_s4100_matches_jax_grad():
    """meant_src at s=4100 (past the resident limit: the text tower streams
    in both packages), d=32, 1 + 1 encoders, b=1, lag 2, 32x32 charts,
    fixed_proj=True, flash on: probabilities and every parameter's
    gradient against jax.grad at shared weights, relative L2 1e-4 per
    parameter (1e-8 absolute for gradients that are zero in exact
    arithmetic, as tests/test_torch_train.py holds them)."""
    s = SRC_GEOM["seq_len"]
    rng = np.random.RandomState(4)
    batch = {"input_ids": rng.randint(2, 100, (1, 2, s)).astype(np.int32),
             "pixels": rng.randn(1, 2, 3, 32, 32).astype(np.float32),
             "prices": rng.randn(1, 2, 5).astype(np.float32),
             "attention_mask": np.ones((1, 2, s), np.float32)}
    y = np.array([1], np.int32)

    def jmodel(flash):
        return JMeantSrc(embedding=JEmb(**SRC_EMB), fixed_proj=True,
                         flash=flash, **SRC_GEOM)

    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    # the parameters do not depend on the input length (the sequence
    # projection pads to seq_len): drawn from a short input, plain attention
    short = {k: v[:, :, :16] if k in ("input_ids", "attention_mask") else v
             for k, v in jb.items()}
    params = jax.tree.map(np.asarray, jax.jit(jmodel(False).init)(
        jax.random.PRNGKey(2), **short)["params"])
    jm = jmodel(True)

    def loss_fn(p):
        out = jm.apply({"params": p}, **jb)
        return j_loss(out, jnp.asarray(y)), out

    (j_value, j_probs), j_grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params)
    want = state_dict_from_jax(jax.tree.map(np.asarray, j_grads))

    model = meant_src(embedding=EmbeddingConfig(**SRC_EMB), fixed_proj=True,
                      flash=True, device="cpu", **SRC_GEOM).eval()
    load_jax_params(model, params)
    before = [c.launches for c in COUNTERS]
    probs = model(**{k: host_tensor(v) for k, v in batch.items()})
    loss = sigmoid_ce_loss(probs, host_tensor(y))
    loss.backward()
    assert [c.launches for c in COUNTERS] == before
    np.testing.assert_allclose(probs.detach().numpy(), np.asarray(j_probs),
                               rtol=RTOL, atol=RTOL)
    np.testing.assert_allclose(loss.item(), float(j_value), rtol=1e-5)
    for name, p in model.named_parameters():
        g, w = p.grad.numpy(), want[name].numpy()
        err = np.linalg.norm(g - w)
        assert err <= 1e-4 * np.linalg.norm(w) + 1e-8, (name, err)
