"""The paper generation in the port against the JAX package at shared
weights, on the CPU: `meant`, its siblings and every TemporalEncoder style.

Narrow geometry with the main path's head shape: dim 192 in 2 heads (head
dim 96, xPos rotating 48), two encoders, s=48 tokens against a 40-row
position table (so the position-id clamp runs), 4-channel 32x32 charts (4
patches). JAX params go through `state_dict_from_jax` into the port; the
JAX side runs jitted, its flash path through the Pallas kernels in
interpret mode, the port's through the kernels' plain versions. fp32 bar:
1e-4 on the probabilities and on both tower outputs.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from meant_tpu.models import EmbeddingConfig as JEmb
from meant_tpu.models import meant as j_meant
from meant_tpu.models import meantPrice as j_meantPrice
from meant_tpu.models import meant_tweet as j_meant_tweet
from meant_tpu.models import meant_tweet_no_lag as j_meant_tweet_no_lag
from meant_tpu.models import meant_vision as j_meant_vision
from meant_tpu.models import meant_vqa as j_meant_vqa
from meant_tpu.nn.encoders import TemporalEncoder as JTemporalEncoder
from meant_tpu.train.classify import sigmoid_ce_loss as j_loss
from meant_tpu_torch import models
from meant_tpu_torch.data.loader import host_tensor
from meant_tpu_torch.nn.encoders import TemporalEncoder
from meant_tpu_torch.train.classify import sigmoid_ce_loss
from meant_tpu_torch.weights import load_jax_params, state_dict_from_jax

import torch_threads

torch_threads.share_cores()

D, HEADS, ENC, B, S, LAG = 192, 2, 2, 2, 48, 5
CHART = dict(height=32, width=32, patch_res=16)
EMB = dict(vocab_size=100, hidden_size=D, max_position_embeddings=40,
           dropout=0.0)
MEANT = dict(text_dim=D, image_dim=D, price_dim=4, lag=LAG, num_classes=2,
             num_heads=HEADS, num_encoders=ENC, channels=4, **CHART)


def _inputs(seed=0):
    """tweets (B, lag, S) with pad id 1 trailing in one day, its mask,
    4-channel charts and 4 prices a day."""
    rng = np.random.RandomState(seed)
    tweets = rng.randint(2, 100, (B, LAG, S)).astype(np.int32)
    tweets[0, 1, 30:] = 1
    return {"tweets": tweets,
            "graphs": rng.randn(B, LAG, 4, 32, 32).astype(np.float32),
            "attention_masks": (tweets != 1).astype(np.float32),
            "prices": rng.randn(B, LAG, 4).astype(np.float32),
            "y": np.array([0, 1], np.int32)}


def _meant_args(b):
    return (b["tweets"], b["graphs"]), {"attention_mask":
                                        b["attention_masks"]}


# name -> (JAX class, port class, constructor kwargs, inputs from a batch)
SIBLINGS = {
    "meant_vision": (j_meant_vision, models.meant_vision,
                     dict(image_dim=D, price_dim=4, lag=LAG, num_classes=2,
                          num_heads=HEADS, num_encoders=ENC, channels=4,
                          **CHART),
                     lambda b: ((b["graphs"],), {})),
    "meant_tweet": (j_meant_tweet, models.meant_tweet,
                    dict(text_dim=D, price_dim=4, lag=LAG, num_classes=2,
                         num_heads=HEADS, num_encoders=ENC, embedding=EMB),
                    lambda b: ((b["tweets"],),
                               {"attention_mask": b["attention_masks"]})),
    "meant_tweet_no_lag": (j_meant_tweet_no_lag, models.meant_tweet_no_lag,
                           dict(text_dim=D, price_dim=4, num_classes=2,
                                num_heads=HEADS, num_encoders=ENC,
                                channels=4, embedding=EMB, **CHART),
                           lambda b: ((b["tweets"][:, -1],), {})),
    "meantPrice": (j_meantPrice, models.meantPrice,
                   dict(MEANT, embedding=EMB),
                   lambda b: ((b["tweets"], b["graphs"], b["prices"]), {})),
    "meant_vqa": (j_meant_vqa, models.meant_vqa,
                  dict(MEANT, lag=1, embedding=EMB),
                  lambda b: ((b["tweets"][:, -1], b["graphs"][:, -1]),
                             {"attention_mask": b["attention_masks"][:, -1]})),
}


def _jax_kwargs(kw):
    """Constructor kwargs with the embedding as JAX's EmbeddingConfig."""
    kw = dict(kw)
    if "embedding" in kw:
        kw["embedding"] = JEmb(**kw["embedding"])
    return kw


def _port_kwargs(kw):
    kw = dict(kw)
    if "embedding" in kw:
        kw["embedding"] = models.EmbeddingConfig(**kw["embedding"])
    return kw


def _jax_forward(model, params, args, kwargs, towers=False):
    """Outputs (and the last encoder of each tower) as fp32 numpy."""
    to_j = lambda v: None if v is None else jnp.asarray(v)
    a = tuple(to_j(v) for v in args)
    kw = {k: to_j(v) for k, v in kwargs.items()}
    out, state = jax.jit(lambda p: model.apply(
        {"params": p}, *a, **kw, capture_intermediates=True))(params)
    to_np = lambda t: np.asarray(t, np.float32)
    if not towers:
        return to_np(out)
    inter = state["intermediates"]
    return to_np(out), {
        "text": to_np(inter[f"languageEncoders_{ENC - 1}"]["__call__"][0]),
        "vision": to_np(inter[f"visionEncoders_{ENC - 1}"]["__call__"][0])}


def _port_forward(model, args, kwargs, towers=False):
    to_t = lambda v: None if v is None else host_tensor(v)
    got = {}
    hooks = [] if not towers else [
        model.languageEncoders.register_forward_hook(
            lambda m, i, o: got.__setitem__("text", o.float().numpy())),
        model.visionEncoders.register_forward_hook(
            lambda m, i, o: got.__setitem__("vision", o.float().numpy()))]
    with torch.no_grad():
        out = model(*(to_t(v) for v in args),
                    **{k: to_t(v) for k, v in kwargs.items()})
    for h in hooks:
        h.remove()
    out = out.float().numpy()
    return (out, got) if towers else out


def _jax_params(model_cls, kw, args, kwargs):
    """Params drawn by the flash=False twin (the same tree; its init does
    not trace the interpret-mode kernels), as numpy."""
    init_kw = dict(kw, flash=False) if "flash" in kw else kw
    model = model_cls(**_jax_kwargs(init_kw))
    to_j = lambda v: None if v is None else jnp.asarray(v)
    params = jax.jit(model.init)(jax.random.PRNGKey(1),
                                 *(to_j(v) for v in args),
                                 **{k: to_j(v) for k, v in kwargs.items()})
    return jax.tree.map(np.asarray, params["params"])


def _port_model(port_cls, kw, params, dtype=None):
    model = port_cls(**_port_kwargs(kw), dtype=dtype, device="cpu").eval()
    load_jax_params(model, params)
    return model


@pytest.fixture(scope="module")
def meant_params():
    args, kwargs = _meant_args(_inputs())
    return _jax_params(j_meant, dict(MEANT, embedding=EMB), args, kwargs)


@pytest.fixture(scope="module", params=[False, True],
                ids=["plain", "flash"])
def meant_fp32(request, meant_params):
    """JAX meant's probabilities and towers, flash off and on."""
    kw = dict(MEANT, embedding=EMB, flash=request.param)
    args, kwargs = _meant_args(_inputs())
    probs, towers = _jax_forward(j_meant(**_jax_kwargs(kw)), meant_params,
                                 args, kwargs, towers=True)
    return kw, probs, towers


def test_meant_probs_and_towers_match_jax_fp32(meant_fp32, meant_params):
    kw, probs, towers = meant_fp32
    model = _port_model(models.meant, kw, meant_params)
    p_probs, p_towers = _port_forward(model, *_meant_args(_inputs()),
                                      towers=True)
    assert p_probs.shape == (B, 2)
    np.testing.assert_allclose(p_probs, probs, rtol=1e-4, atol=1e-4)
    for name in ("text", "vision"):
        np.testing.assert_allclose(p_towers[name], towers[name], rtol=1e-4,
                                   atol=1e-4, err_msg=name)


def test_meant_flash_with_mask_equals_plain_without(meant_params):
    """The language encoders drop the padding mask on the flash path, as
    the reference does: flash with the mask is plain without it."""
    args, kwargs = _meant_args(_inputs())
    assert kwargs["attention_mask"].min() == 0
    kw = dict(MEANT, embedding=EMB)
    f_probs, f_towers = _port_forward(
        _port_model(models.meant, dict(kw, flash=True), meant_params),
        args, kwargs, towers=True)
    n_probs, n_towers = _port_forward(
        _port_model(models.meant, kw, meant_params), args,
        {"attention_mask": None}, towers=True)
    for name in ("text", "vision"):
        np.testing.assert_allclose(f_towers[name], n_towers[name],
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    np.testing.assert_allclose(f_probs, n_probs, rtol=1e-5, atol=1e-6)


def test_meant_bf16_matches_jax_within_bf16_bar(meant_params):
    """bf16 activations, fp32 params, flash on: meant_src's bf16 bars, 1e-2
    absolute on the probabilities (a bf16 step near 0.5 is 3.9e-3) and 3%
    of the tower's largest value on the tower outputs."""
    kw = dict(MEANT, embedding=EMB, flash=True)
    args, kwargs = _meant_args(_inputs())
    probs, towers = _jax_forward(
        j_meant(**_jax_kwargs(kw), dtype=jnp.bfloat16), meant_params, args,
        kwargs, towers=True)
    p_probs, p_towers = _port_forward(
        _port_model(models.meant, kw, meant_params, dtype=torch.bfloat16),
        args, kwargs, towers=True)
    np.testing.assert_allclose(p_probs, probs, atol=1e-2)
    for name in ("text", "vision"):
        scale = np.abs(towers[name]).max()
        np.testing.assert_allclose(p_towers[name], towers[name],
                                   atol=0.03 * scale, err_msg=name)


def _group(name: str) -> str:
    if name.startswith(("embedding", "languageEncoders")):
        return "text"
    if name.startswith(("patchEmbed", "visionEncoders")):
        return "vision"
    return "temporal_and_head"


def test_meant_step_gradients_match_jax_grad(meant_params):
    """One step's loss and parameter gradients at ff_dropout=0, flash on,
    against jax.grad of the JAX loss (its backward through the Pallas
    kernel in interpret mode): relative L2 1e-4 per parameter group and per
    parameter, plus 1e-8 absolute for a gradient that is zero in exact
    arithmetic (the temporal key bias: a shift of every key moves no
    softmax)."""
    kw = dict(MEANT, embedding=EMB, flash=True, ff_dropout=0.0)
    batch = _inputs(seed=3)
    args, kwargs = _meant_args(batch)
    jm = j_meant(**_jax_kwargs(kw))
    ja = tuple(jnp.asarray(v) for v in args)
    jmask = jnp.asarray(kwargs["attention_mask"])

    def loss_fn(p):
        return j_loss(jm.apply({"params": p}, *ja, attention_mask=jmask),
                      jnp.asarray(batch["y"]))

    j_value, j_grads = jax.jit(jax.value_and_grad(loss_fn))(meant_params)
    want = state_dict_from_jax(jax.tree.map(np.asarray, j_grads))

    model = _port_model(models.meant, kw, meant_params).train()
    out = model(*(host_tensor(v) for v in args),
                attention_mask=host_tensor(kwargs["attention_mask"]))
    loss = sigmoid_ce_loss(out, host_tensor(batch["y"]))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(j_value), rtol=1e-6)
    named = dict(model.named_parameters())
    assert set(named) == set(want) - {k for k in want if "freqs" in k}
    groups = {}
    for name, p in named.items():
        got, ref = p.grad.numpy(), want[name].numpy()
        assert (np.linalg.norm(got - ref)
                <= 1e-4 * np.linalg.norm(ref) + 1e-8), name
        g = groups.setdefault(_group(name), [[], []])
        g[0].append(got.ravel())
        g[1].append(ref.ravel())
    assert set(groups) == {"text", "vision", "temporal_and_head"}
    for name, (got, ref) in groups.items():
        got, ref = np.concatenate(got), np.concatenate(ref)
        assert np.linalg.norm(ref) > 0, name
        assert np.linalg.norm(got - ref) <= 1e-4 * np.linalg.norm(ref), name


@pytest.fixture(scope="module")
def sibling_params():
    """JAX params of each sibling, drawn once for the module."""
    cache = {}

    def get(name):
        if name not in cache:
            j_cls, _, kw, pick = SIBLINGS[name]
            cache[name] = _jax_params(j_cls, kw, *pick(_inputs()))
        return cache[name]
    return get


@pytest.mark.parametrize("name", list(SIBLINGS))
def test_sibling_matches_jax_fp32(name, sibling_params):
    j_cls, p_cls, kw, pick = SIBLINGS[name]
    args, kwargs = pick(_inputs())
    params = sibling_params(name)
    want = _jax_forward(j_cls(**_jax_kwargs(kw)), params, args, kwargs)
    got = _port_forward(_port_model(p_cls, kw, params), args, kwargs)
    assert got.shape == want.shape == (B, 2)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", ["meant", "meant_tweet_no_lag",
                                  "meantPrice"])
def test_state_dict_from_jax_uses_every_key_once(name, meant_params,
                                                 sibling_params):
    """Every JAX leaf maps to one port key, the positional parameter and
    the cls tokens included, and loading is strict both ways."""
    if name == "meant":
        params, p_cls, kw = meant_params, models.meant, dict(MEANT,
                                                             embedding=EMB)
    else:
        _, p_cls, kw, _ = SIBLINGS[name]
        params = sibling_params(name)
    sd = state_dict_from_jax(params)
    model = p_cls(**_port_kwargs(kw), device="cpu")
    assert len(sd) == len(jax.tree.leaves(params))
    assert set(sd) == set(model.state_dict())
    specials = {"meant": ["temporal_encoding_0.temp_embedding"],
                "meant_tweet_no_lag": ["txt_classtkn"],
                "meantPrice": ["txt_classtkn", "img_classtkn",
                               "temporal_encoding_0.temp_embedding"]}[name]
    for key in specials:
        path = key.split(".")
        leaf = params
        for part in path:
            leaf = leaf[part]
        np.testing.assert_array_equal(sd[key].numpy(), leaf)
    stray = dict(params, stray={"temp_embeddingz": np.zeros(3, np.float32)})
    with pytest.raises(KeyError):
        state_dict_from_jax(stray)


# style -> (dim, heads): the uneven and clamped head splits included
STYLES = {"paper": (192, 2), "slim": (388, 2), "src": (197, 2),
          "src_slim": (5, 8), "tweet_price": (192, 2)}


@pytest.mark.parametrize("style", list(STYLES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_temporal_encoder_styles_match_jax(style, dtype):
    """Each row of _TEMPORAL_STYLES on (b, lag, dim) inputs: fp32 at 1e-5;
    bf16 activations (a bf16 x meets the fp32 temp_embedding and the sum is
    fp32 in both frameworks) with the same output dtype, within 2% of the
    largest output."""
    dim, heads = STYLES[style]
    x = np.random.RandomState(7).randn(3, LAG, dim).astype(np.float32)
    jdt = None if dtype == "float32" else jnp.bfloat16
    tdt = None if dtype == "float32" else torch.bfloat16
    jm = JTemporalEncoder(dim, heads, LAG, style=style, dtype=jdt)
    jx = jnp.asarray(x, jdt or jnp.float32)
    params = jax.tree.map(np.asarray, jax.jit(jm.init)(
        jax.random.PRNGKey(4), jx)["params"])
    want = jax.jit(lambda p: jm.apply({"params": p}, jx))(params)
    tm = TemporalEncoder(dim, heads, LAG, style=style, dtype=tdt,
                         device="cpu").eval()
    load_jax_params(tm, params)
    with torch.no_grad():
        got = tm(torch.as_tensor(x).to(tdt or torch.float32))
    assert tuple(got.shape) == want.shape
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_allclose(got, want,
                                   atol=0.02 * np.abs(want).max())
    has_embed = style in ("paper", "slim", "tweet_price")
    assert ("temp_embedding" in params) == has_embed
    assert (tm.temp_embedding is not None) == has_embed


def test_temp_embedding_draws_normal_from_the_seed():
    """The port draws temp_embedding N(0, 1) from the model's generator:
    one seed, one set of weights; another seed, others."""
    make = lambda seed: models.meant(**_port_kwargs(dict(MEANT,
                                                         embedding=EMB)),
                                     device="cpu", seed=seed)
    a, b, c = make(0), make(0), make(1)
    e = a.temporal_encoding_0.temp_embedding
    assert tuple(e.shape) == (1, LAG, 2 * D)
    assert torch.equal(e, b.temporal_encoding_0.temp_embedding)
    assert not torch.equal(e, c.temporal_encoding_0.temp_embedding)
    e = e.detach()
    assert 0.8 < float(e.std()) < 1.2 and abs(float(e.mean())) < 0.1


@pytest.mark.parametrize("lever", [dict(remat="full"),
                                   dict(scan_layers=True)])
def test_stack_levers_raise(lever, meant_params):
    """The levers are ported (nn/stack.py): meant builds with them and, in
    training mode with dropout on at one seed, computes bit for bit what it
    computes without them, outputs and gradients."""
    b = _inputs()
    args, kwargs = _meant_args(b)
    out = {}
    for key, kw in (("off", {}), ("on", lever)):
        model = models.meant(**_port_kwargs(dict(MEANT, embedding=EMB)),
                             device="cpu", **kw)
        load_jax_params(model, meant_params)
        model.train()
        torch.manual_seed(5)
        y = model(*(host_tensor(v) for v in args),
                  **{k: host_tensor(v) for k, v in kwargs.items()})
        y.sum().backward()
        out[key] = (y.detach(), {n: p.grad for n, p in
                                 model.named_parameters()})
    assert model.languageEncoders.remat in ("full", "dots")
    assert torch.equal(out["on"][0], out["off"][0])
    for name, g in out["off"][1].items():
        assert torch.equal(out["on"][1][name], g), name
