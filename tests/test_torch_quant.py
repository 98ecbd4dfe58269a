"""int8 serving in the port (`nn/quant.py`, `Predictor(quantize="int8")`)
against the JAX package's `nn/quant.py` on the CPU.

The same numpy inputs go through both `int8_dense`s: equal int8 codes
(round half to even after a true division by the scale), an equal int32
accumulator, and outputs within 1 ulp in fp32. The port quantizes exactly
the layers JAX's interceptor catches: one int8 product per `nn.Dense` call
of 32 or more features (its `Linear` and raw `Dense`), none for the
attention's `DenseGeneral` projections, the embeddings and the narrow
heads.

At shared weights (2 encoders, width 64, s=12; meant, meant_src,
meant_timesformer, teanet) the int8 Predictors of both packages give the
same argmax and probabilities within 1e-2, and within SENSITIVITY_FACTOR
times JAX's own sensitivity on average. An activation that lands within an
ulp of a rounding boundary can round to another int8 value in either
package, and one such flip moves a probability by more than 1e-3: a 1e-7
relative perturbation of the charts moves the port's own int8
probabilities by more than 2e-3 at this width, and its fp32 ones by less
than 1e-6 (`test_int8_rounding_amplifies_ulp_noise`); how often it moves
JAX's depends on the host's vector code, so the mean bar is read from JAX
on the host that runs the test.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import flax.linen as fnn

from meant_tpu.models import EmbeddingConfig as JEmb
from meant_tpu.models import meant as j_meant
from meant_tpu.models.meant_src import meant_src as j_meant_src
from meant_tpu.models.meant_timesformer import (
    meant_timesformer as j_meant_timesformer)
from meant_tpu.models.teanet import teanet as j_teanet
from meant_tpu.nn import quant as jquant
from meant_tpu.serve import Predictor as JPredictor
from meant_tpu_torch import models
from meant_tpu_torch.nn import quant
from meant_tpu_torch.nn.layers import Linear
from meant_tpu_torch.serve import Predictor
from meant_tpu_torch.weights import load_jax_params

import torch_threads

torch_threads.share_cores()

D, ENC, S, LAG, B = 64, 2, 12, 3, 6
EMB = dict(vocab_size=100, hidden_size=D, max_position_embeddings=40,
           dropout=0.0)
CHART = dict(height=32, width=32, patch_res=16)


def _x(shape, seed):
    """Normal inputs with values that sit on .5 after the division by
    the scale: the largest |x| is 127, so the scale is 1."""
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32) * 30
    x = np.clip(x, -126, 126)
    flat = x.reshape(-1)
    flat[0], flat[1:6] = 127.0, [0.5, 1.5, 2.5, -0.5, -2.5]
    return x


@pytest.mark.parametrize("m,k,n", [(5, 37, 33), (16, 1541, 40),
                                   (3, 8, 32)])
def test_int8_dense_matches_jax(m, k, n):
    x = _x((m, k), m + k)
    w = (np.random.RandomState(n).randn(k, n) * 0.05).astype(np.float32)
    b = (np.random.RandomState(n + 1).randn(n) * 0.1).astype(np.float32)
    xt, wt, bt = torch.tensor(x), torch.tensor(w.T.copy()), torch.tensor(b)
    jx, jw = jnp.asarray(x), jnp.asarray(w)
    np.testing.assert_array_equal(
        quant._to_int8(xt, quant._amax_scale(xt)).numpy(),
        np.asarray(jquant._to_int8(jx, jquant._amax_scale(jx))))
    np.testing.assert_array_equal(
        quant._to_int8(wt, quant._amax_scale(wt, dim=1)).numpy().T,
        np.asarray(jquant._to_int8(jw, jquant._amax_scale(jw, axis=0))))
    want = np.asarray(jquant.int8_dense(jx, jw, jnp.asarray(b)))
    got = quant.int8_dense(xt, wt, bt).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=1e-6 * np.abs(want).max())
    # the plain int32 product is the exact one
    a8 = quant._to_int8(xt, quant._amax_scale(xt))
    w8 = quant._to_int8(wt, quant._amax_scale(wt, dim=1))
    assert torch.equal(quant.int8_matmul(a8, w8),
                       quant.int8_matmul_reference(a8, w8))


@pytest.mark.parametrize("m,k,n", [(5, 37, 33), (16, 1541, 40),
                                   (3, 8, 32)])
def test_int8_dense_codes_accumulator_and_output_match_jax(m, k, n):
    """The layer alone at the same x and W: the int8 codes of x and W
    equal, the int32 accumulator equal to JAX's `dot_general`, the output
    within 1 ulp of JAX's."""
    x = _x((m, k), m + k + 1)
    w = (np.random.RandomState(n + 2).randn(k, n) * 0.05).astype(np.float32)
    b = (np.random.RandomState(n + 3).randn(n) * 0.1).astype(np.float32)
    xt, wt = torch.tensor(x), torch.tensor(w.T.copy())
    jx, jw = jnp.asarray(x), jnp.asarray(w)
    jx8 = jquant._to_int8(jx, jquant._amax_scale(jx))
    jw8 = jquant._to_int8(jw, jquant._amax_scale(jw, axis=0))
    x8 = quant._to_int8(xt, quant._amax_scale(xt))
    w8 = quant._to_int8(wt, quant._amax_scale(wt, dim=1))
    np.testing.assert_array_equal(x8.numpy(), np.asarray(jx8))
    np.testing.assert_array_equal(w8.numpy().T, np.asarray(jw8))
    want_acc = jax.lax.dot_general(jx8, jw8, (((1,), (0,)), ((), ())),
                                   preferred_element_type=jnp.int32)
    np.testing.assert_array_equal(quant.int8_matmul(x8, w8).numpy(),
                                  np.asarray(want_acc))
    want = np.asarray(jquant.int8_dense(jx, jw, jnp.asarray(b)))
    got = quant.int8_dense(xt, wt, torch.tensor(b)).numpy()
    np.testing.assert_array_max_ulp(got, want, maxulp=1)


def test_quantizes_wide_layers_only_as_jax():
    """JAX's interceptor test with the port at JAX's weights: the wide layer
    quantizes, the 2-feature head does not, and a narrow head alone is bit
    for bit its fp32 forward."""
    class M(fnn.Module):
        @fnn.compact
        def __call__(self, x):
            return fnn.Dense(2, name="head")(fnn.Dense(128, name="wide")(x))

    x = np.random.RandomState(1).randn(8, 64).astype(np.float32)
    params = jax.jit(M().init)(jax.random.PRNGKey(0), jnp.asarray(x))[
        "params"]
    wide, head = Linear(128, 64, device="cpu"), Linear(2, 128, device="cpu")
    with torch.no_grad():
        for mod, name in ((wide, "wide"), (head, "head")):
            mod.weight.copy_(torch.tensor(np.asarray(
                params[name]["kernel"]).T))
            mod.bias.copy_(torch.tensor(np.asarray(params[name]["bias"])))
    port = torch.nn.Sequential(wide, head)
    xt = torch.tensor(x)
    quant.products.clear()
    with torch.no_grad():
        ref = port(xt).numpy()
        out = quant.quantized_apply(port, xt).numpy()
        hidden = wide(xt)
        alone = quant.quantized_apply(head, hidden).numpy()
        alone_ref = head(hidden).numpy()
    assert list(quant.products) == [(8, 64, 128)]
    want = np.asarray(jquant.quantized_apply(M(), {"params": params},
                                             jnp.asarray(x)))
    np.testing.assert_allclose(out, want, rtol=1e-5, atol=1e-6)
    assert not np.allclose(out, ref, atol=1e-7)
    np.testing.assert_allclose(out, ref, atol=0.1)
    np.testing.assert_array_equal(alone, alone_ref)
    assert quant.MIN_FEATURES == jquant.MIN_FEATURES == 32
    assert not quant.int8_active()


def test_int8_reaches_every_wide_linear_of_meant_src():
    """Inside the context each Linear of 32 or more features runs one int8
    product a forward; the heads (2), the sequence projections (1) and the
    embeddings stay exact."""
    model = models.meant_src(
        D, D, 5, 32, 32, 16, LAG, 2, embedding=models.EmbeddingConfig(**EMB),
        num_heads=2, num_encoders=ENC, seq_len=16, device="cpu").eval()
    wide = [m for m in model.modules() if isinstance(m, Linear)
            and m.weight.shape[0] >= quant.MIN_FEATURES]
    narrow = [m for m in model.modules() if isinstance(m, Linear)
              and m.weight.shape[0] < quant.MIN_FEATURES]
    assert len(narrow) == 3 and len(wide) == ENC * 2 * 8 + 1 + 6
    batch = _src_batch()
    quant.products.clear()
    with torch.no_grad():
        quant.quantized_apply(model, **{k: torch.as_tensor(v)
                                        for k, v in batch.items()})
    assert sum(quant.products.values()) == len(wide)


def _src_batch(seed=0):
    rng = np.random.RandomState(seed)
    return {"input_ids": rng.randint(2, 100, (B, LAG, S)).astype(np.int32),
            "pixels": rng.randn(B, LAG, 3, 32, 32).astype(np.float32),
            "prices": rng.randn(B, LAG, 5).astype(np.float32),
            "attention_mask": np.ones((B, LAG, S), np.float32)}


def _meant_batch(seed=0):
    rng = np.random.RandomState(seed)
    return {"tweets": rng.randint(2, 100, (B, LAG, S)).astype(np.int32),
            "graphs": rng.randn(B, LAG, 4, 32, 32).astype(np.float32),
            "attention_masks": np.ones((B, LAG, S), np.float32)}


def _teanet_batch(seed=0):
    rng = np.random.RandomState(seed)
    return {"tweets": rng.randint(2, 100, (B, LAG, S)).astype(np.int32),
            "macds": rng.randn(B, LAG, 4).astype(np.float32)}


MEANT_KW = dict(text_dim=D, image_dim=D, price_dim=4, lag=LAG,
                num_classes=2, num_heads=2, num_encoders=ENC, channels=4,
                **CHART)
SRC_KW = dict(text_dim=D, image_dim=D, price_dim=5, lag=LAG, num_classes=2,
              num_heads=2, num_encoders=ENC, channels=3, seq_len=16,
              **CHART)
TEANET_KW = dict(dim=D, num_heads=4, vocab_size=100, num_layers=2)


def _embedded(cls, emb_cls, kw):
    return lambda **extra: cls(embedding=emb_cls(**EMB), **kw, **extra)


# name: (JAX model, port model (taking device= and seed=), batch, the input
# the sensitivity probe perturbs)
CASES = {
    "meant": (_embedded(j_meant, JEmb, MEANT_KW),
              _embedded(models.meant, models.EmbeddingConfig, MEANT_KW),
              _meant_batch, "graphs"),
    "meant_src": (_embedded(j_meant_src, JEmb, dict(SRC_KW, fixed_proj=True)),
                  _embedded(models.meant_src, models.EmbeddingConfig,
                            dict(SRC_KW, fixed_proj=True)),
                  _src_batch, "pixels"),
    "meant_timesformer": (
        _embedded(j_meant_timesformer, JEmb, SRC_KW),
        _embedded(models.meant_timesformer, models.EmbeddingConfig, SRC_KW),
        _src_batch, "pixels"),
    "teanet": (lambda: j_teanet(**TEANET_KW),
               lambda **extra: models.teanet(**TEANET_KW, **extra),
               _teanet_batch, "macds"),
}
# The model-level bar on the mean |port - JAX| of the int8 probabilities:
# SENSITIVITY_FACTOR times JAX's own sensitivity to ulp noise, the largest
# mean move of JAX's int8 probabilities under four 1e-7 relative
# perturbations (seeds 0-3) of one input (at least FP32_NOISE, the fp32
# Predictors' mean difference being 1e-7). An activation within an ulp of
# an int8 rounding boundary flips its code under such noise and the flip
# spreads: at meant_src's case JAX moves by 0, 0, 2.56e-3 and 0 at the
# four seeds on an x86 CPU, and the port differs from JAX by 1.77e-3 on
# one host and by far less on another, as XLA's vector code differs.
SENSITIVITY_FACTOR = 2.0
FP32_NOISE = 1e-6


def _perturbed(batch, key, seed):
    x = batch[key]
    noise = 1 + 1e-7 * np.random.RandomState(seed).randn(*x.shape)
    return dict(batch, **{key: (x * noise).astype(np.float32)})


def _jax_params(name, jmodel, batch):
    from meant_tpu.train.classify import model_inputs as j_inputs
    args, kwargs = j_inputs(name, {k: jnp.asarray(v)
                                   for k, v in batch.items()})
    return jax.jit(jmodel.init)(jax.random.PRNGKey(2), *args,
                                **kwargs)["params"], args, kwargs


@pytest.fixture(scope="module")
def jax_case():
    """JAX's model, the batch and `_jax_params` of a CASES name, drawn once
    for the file's cases of that name."""
    made = {}

    def get(name):
        if name not in made:
            jfactory, _, make_batch, _ = CASES[name]
            batch, jmodel = make_batch(), jfactory()
            made[name] = (jmodel, batch, *_jax_params(name, jmodel, batch))
        return made[name]

    return get


@pytest.mark.parametrize("name", sorted(CASES))
def test_int8_predictor_matches_jax(name, jax_case):
    _, pfactory, _, key = CASES[name]
    jmodel, batch, params, _, _ = jax_case(name)
    serve_jax = JPredictor(jmodel, name, params=params, batch_size=B,
                           quantize="int8")
    want = serve_jax(batch)
    sensitivity = max(float(np.abs(serve_jax(_perturbed(batch, key, seed))
                                   - want).mean()) for seed in range(4))
    port = pfactory(device="cpu")
    load_jax_params(port, jax.tree.map(np.asarray, params))
    got = Predictor(port, name, batch_size=B, device="cpu",
                    quantize="int8")(batch)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    bar = SENSITIVITY_FACTOR * max(sensitivity, FP32_NOISE)
    assert np.abs(got - want).mean() <= bar, (np.abs(got - want).mean(),
                                              sensitivity)
    np.testing.assert_allclose(got, want, atol=1e-2)
    fp = Predictor(port, name, batch_size=B, device="cpu")(batch)
    assert np.abs(got - fp).max() > 1e-4      # int8 changed the answer


@pytest.mark.parametrize("name", sorted(CASES))
def test_int8_quantizes_the_layers_jax_quantizes(name, jax_case):
    """One int8 forward runs one int8 product for each `nn.Dense` call of
    32 or more features that JAX's interceptor catches: the raw Dense
    layers quantize, the attention's DenseGeneral projections, the
    embeddings and the narrow heads do not."""
    pfactory = CASES[name][1]
    jmodel, batch, params, args, kwargs = jax_case(name)
    caught = []

    def count(next_fun, a, kw, context):
        mod = context.module
        if (type(mod) is fnn.Dense and context.method_name == "__call__"
                and mod.features >= jquant.MIN_FEATURES):
            caught.append(mod.name)
        return next_fun(*a, **kw)

    with fnn.intercept_methods(count):      # caught while jit traces
        jax.jit(lambda p: jmodel.apply({"params": p}, *args, **kwargs))(
            params)
    port = pfactory(device="cpu").eval()
    load_jax_params(port, jax.tree.map(np.asarray, params))
    from meant_tpu_torch.train.classify import model_inputs
    pa, pkw = model_inputs(name, {k: torch.as_tensor(v)
                                  for k, v in batch.items()})
    quant.products.clear()
    with torch.no_grad():
        quant.quantized_apply(port, *pa, **pkw)
    assert caught and sum(quant.products.values()) == len(caught)


@pytest.mark.parametrize("name", ["meant", "meant_src"])
def test_int8_rounding_amplifies_ulp_noise(name):
    """Why the int8 Predictors are compared at 1e-2: four 1e-7 relative
    perturbations of the charts (seeds 0-3) move the int8 probabilities by
    more than 2e-3 at most, the fp32 ones by less than 1e-6."""
    _, pfactory, make_batch, key = CASES[name]
    port = pfactory(device="cpu", seed=5)
    batch = make_batch()
    moved = {}
    for mode in (None, "int8"):
        serve = Predictor(port, name, batch_size=B, device="cpu",
                          quantize=mode)
        base = serve(batch)
        moved[mode] = max(
            np.abs(serve(_perturbed(batch, key, seed)) - base).max()
            for seed in range(4))
    assert moved[None] < 1e-6 and moved["int8"] > 2e-3, moved


def test_unknown_quantize_and_mesh_are_refused():
    """An unknown mode and a mesh that is not a DeviceMesh raise; int8
    composes with tensor-parallel serving, at one rank (a world-1 gloo
    group started here and ended after) equal to the plain int8
    Predictor."""
    model = CASES["meant"][1](device="cpu")
    with pytest.raises(ValueError):
        Predictor(model, "meant", device="cpu", quantize="fp4")
    with pytest.raises(TypeError, match="DeviceMesh"):
        Predictor(model, "meant", device="cpu", mesh=object())
    batch = CASES["meant"][2]()
    want = Predictor(model, "meant", batch_size=B, device="cpu",
                     quantize="int8")(batch)
    try:
        got = Predictor(CASES["meant"][1](device="cpu"), "meant",
                        batch_size=B, device="cpu", tensor_parallel=True,
                        quantize="int8")(batch)
    finally:
        torch.distributed.destroy_process_group()
    np.testing.assert_array_equal(got, want)
