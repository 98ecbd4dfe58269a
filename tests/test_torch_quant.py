"""int8 serving in the port (`nn/quant.py`, `Predictor(quantize="int8")`)
against the JAX package's `nn/quant.py` on the CPU.

The same numpy inputs go through both `int8_dense`s: equal int8 tensors
(round half to even after a true division by the scale) and outputs
within 1e-6 relative in fp32. The port quantizes exactly the layers JAX's
interceptor catches (every Linear of 32 or more features). At shared
weights (2 encoders, width 64, s=12) the int8 Predictors of both packages
give the same argmax and probabilities within 1e-3 on average and 1e-2 at
most. An activation that lands within an ulp of a rounding boundary can
round to another int8 value in either package, and one such flip moves a
probability by more than 1e-3: a 1e-7 relative perturbation of the
charts moves the port's own int8 probabilities by more than 2e-3 at this
width, and its fp32 ones by less than 1e-6
(`test_int8_rounding_amplifies_ulp_noise`). The quantize step itself is
held exactly (equal int8 tensors) by `test_int8_dense_matches_jax`.
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
from meant_tpu.nn import quant as jquant
from meant_tpu.serve import Predictor as JPredictor
from meant_tpu_torch import models
from meant_tpu_torch.nn import quant
from meant_tpu_torch.nn.layers import Linear
from meant_tpu_torch.serve import Predictor
from meant_tpu_torch.weights import load_jax_params

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


def test_quantizes_wide_layers_only_as_jax():
    """JAX's interceptor test with the port at JAX's weights: the wide layer
    quantizes, the 2-feature head does not, and a narrow head alone is bit
    for bit its fp32 forward."""
    class M(fnn.Module):
        @fnn.compact
        def __call__(self, x):
            return fnn.Dense(2, name="head")(fnn.Dense(128, name="wide")(x))

    x = np.random.RandomState(1).randn(8, 64).astype(np.float32)
    params = M().init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
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


CASES = {
    "meant": (j_meant, models.meant,
              dict(text_dim=D, image_dim=D, price_dim=4, lag=LAG,
                   num_classes=2, num_heads=2, num_encoders=ENC, channels=4,
                   **CHART), _meant_batch),
    "meant_src": (j_meant_src, models.meant_src,
                  dict(text_dim=D, image_dim=D, price_dim=5, lag=LAG,
                       num_classes=2, num_heads=2, num_encoders=ENC,
                       channels=3, seq_len=16, fixed_proj=True, **CHART),
                  _src_batch),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_int8_predictor_matches_jax(name):
    jcls, pcls, kw, make_batch = CASES[name]
    batch = make_batch()
    jmodel = jcls(embedding=JEmb(**EMB), **kw)
    from meant_tpu.train.classify import model_inputs as j_inputs
    args, kwargs = j_inputs(name, {k: jnp.asarray(v)
                                   for k, v in batch.items()})
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(2), *args,
                                  **kwargs)["params"]
    want = JPredictor(jmodel, name, params=params, batch_size=B,
                      quantize="int8")(batch)
    port = pcls(embedding=models.EmbeddingConfig(**EMB), device="cpu", **kw)
    load_jax_params(port, jax.tree.map(np.asarray, params))
    got = Predictor(port, name, batch_size=B, device="cpu",
                    quantize="int8")(batch)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    assert np.abs(got - want).mean() <= 1e-3
    np.testing.assert_allclose(got, want, atol=1e-2)
    fp = Predictor(port, name, batch_size=B, device="cpu")(batch)
    assert np.abs(got - fp).max() > 1e-4      # int8 changed the answer


@pytest.mark.parametrize("name", sorted(CASES))
def test_int8_rounding_amplifies_ulp_noise(name):
    """Why the int8 Predictors are compared at 1e-2: four 1e-7 relative
    perturbations of the charts (seeds 0-3) move the int8 probabilities by
    more than 2e-3 at most, the fp32 ones by less than 1e-6."""
    _, pcls, kw, make_batch = CASES[name]
    port = pcls(embedding=models.EmbeddingConfig(**EMB), device="cpu", seed=5,
                **kw)
    batch = make_batch()
    key = "pixels" if name == "meant_src" else "graphs"
    moved = {}
    for mode in (None, "int8"):
        serve = Predictor(port, name, batch_size=B, device="cpu",
                          quantize=mode)
        base = serve(batch)
        moved[mode] = max(
            np.abs(serve(dict(batch, **{key: (batch[key] * (
                1 + 1e-7 * np.random.RandomState(seed).randn(
                    *batch[key].shape))).astype(np.float32)})) - base).max()
            for seed in range(4))
    assert moved[None] < 1e-6 and moved["int8"] > 2e-3, moved


def test_unknown_quantize_and_mesh_are_refused():
    model = models.meant(**{**CASES["meant"][2]},
                         embedding=models.EmbeddingConfig(**EMB),
                         device="cpu")
    with pytest.raises(ValueError):
        Predictor(model, "meant", device="cpu", quantize="fp4")
    with pytest.raises(NotImplementedError, match="item 10"):
        Predictor(model, "meant", device="cpu", mesh=object())
    with pytest.raises(NotImplementedError, match="item 10"):
        Predictor(model, "meant", device="cpu", tensor_parallel=True)
