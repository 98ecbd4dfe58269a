"""The port's RoBERTa encoder and HF-wrapper heads (meant_tpu_torch/nn/
roberta.py) against the JAX package on the CPU: RobertaLayer, RobertaModel
(hidden states and pooled output, padding and position ids past the
table), bertweet_wrapper with pad ids 1 in its input (fp32 and bf16),
roberta_mlm_wrapper and hug_roberta_mlm_wrapper.

The same numpy inputs and JAX's params (carried over by
`weights.load_jax_params`, which must use every leaf) go through both
packages. Bars: fp32 1e-5 absolute; bf16 probabilities 2e-2 absolute (the
products round in bf16 and the norms return fp32 in both packages, so the
two streams agree up to the order of bf16 sums).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from meant_tpu.nn import roberta as J
from meant_tpu_torch.nn import roberta as P
from meant_tpu_torch.weights import load_jax_params

import torch_threads

torch_threads.share_cores()

B, S, D, H, VOCAB = 2, 20, 64, 4, 200
SMALL = dict(input_dim=D, vocab_size=VOCAB, num_layers=2, num_heads=H)
BF16_ATOL = 2e-2


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _ids(seed=0, s=S):
    rng = np.random.RandomState(seed)
    ids = rng.randint(2, VOCAB, (B, s)).astype(np.int32)
    ids[1, s - 6:] = 1                       # trailing pads (id 1)
    ids[0, 3] = 1                            # and one inside a row
    return ids


def _jax(module, *args, **kwargs):
    """JAX params and output, jitted: under jit a gather clamps its ids."""
    a = [jnp.asarray(x) for x in args]
    params = jax.jit(lambda *t: module.init(jax.random.PRNGKey(1), *t,
                                            **kwargs))(*a)["params"]
    out = jax.jit(lambda p, *t: module.apply({"params": p}, *t,
                                             **kwargs))(params, *a)
    return _np(params), jax.tree.map(lambda t: np.asarray(t, np.float32),
                                     out)


def _port(module, params, *args, **kwargs):
    load_jax_params(module, params)
    module.eval()
    with torch.no_grad():
        out = module(*(torch.as_tensor(x) for x in args), **kwargs)
    if isinstance(out, tuple):
        return tuple(o.float().numpy() for o in out)
    return out.float().numpy()


def test_roberta_layer_matches_jax():
    x = np.random.RandomState(2).randn(B, S, D).astype(np.float32)
    mask = (_ids() != 1).astype(np.float32)
    params, want = _jax(J.RobertaLayer(D, H, 4 * D), x, mask)
    got = _port(P.RobertaLayer(D, H, 4 * D, device="cpu"), params, x, mask)
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("s", [S, 140])
def test_roberta_model_hidden_and_pooled_match_jax(s):
    """s=140 puts position ids past the 130-row table: both packages
    clamp them to its last row."""
    ids = _ids(3, s)
    mask = (ids != 1).astype(np.float32)
    jm = J.RobertaModel(vocab_size=VOCAB, hidden_size=D, num_layers=2,
                        num_heads=H, intermediate_size=4 * D)
    params, (hidden, pooled) = _jax(jm, ids, mask)
    pm = P.RobertaModel(vocab_size=VOCAB, hidden_size=D, num_layers=2,
                        num_heads=H, intermediate_size=4 * D, device="cpu")
    got_hidden, got_pooled = _port(pm, params, ids, mask)
    np.testing.assert_allclose(got_hidden, hidden, atol=1e-5)
    np.testing.assert_allclose(got_pooled, pooled, atol=1e-5)
    hidden_only = np.asarray(jax.jit(lambda p, *t: jm.apply(
        {"params": p}, *t, return_pooled=False))(params, ids, mask))
    np.testing.assert_allclose(
        _port(pm, params, ids, mask, return_pooled=False), hidden_only,
        atol=1e-5)


def test_bertweet_wrapper_matches_jax_with_pads():
    ids = _ids(4)
    params, want = _jax(J.bertweet_wrapper(output_dim=3, **SMALL), ids)
    got = _port(P.bertweet_wrapper(output_dim=3, device="cpu", **SMALL),
                params, ids)
    np.testing.assert_allclose(got, want, atol=1e-5)
    # pads change the answer: the mask is read, not ignored
    unpadded = np.where(ids == 1, 5, ids)
    assert np.abs(_port(P.bertweet_wrapper(output_dim=3, device="cpu",
                                           **SMALL), params, unpadded)
                  - got).max() > 1e-4


def test_bertweet_wrapper_bf16_matches_jax():
    """dtype=bf16 with fp32 params: the products in bf16, each Flax
    LayerNorm back to fp32, in both packages; probabilities within
    BF16_ATOL of JAX's and of the port's own fp32 forward."""
    ids = _ids(5)
    params, want = _jax(J.bertweet_wrapper(output_dim=2, dtype=jnp.bfloat16,
                                           **SMALL), ids)
    model = P.bertweet_wrapper(output_dim=2, dtype=torch.bfloat16,
                               device="cpu", **SMALL)
    got = _port(model, params, ids)
    np.testing.assert_allclose(got, want, atol=BF16_ATOL)
    fp32 = _port(P.bertweet_wrapper(output_dim=2, device="cpu", **SMALL),
                 params, ids)
    np.testing.assert_allclose(got, fp32, atol=BF16_ATOL)
    with torch.no_grad():
        out = model(torch.as_tensor(ids))
    assert out.dtype == torch.bfloat16


@pytest.mark.parametrize("hug", [False, True])
def test_mlm_wrappers_match_jax(hug):
    ids = _ids(6)
    mask = (ids != 1).astype(np.float32)
    jm = (J.hug_roberta_mlm_wrapper(**SMALL) if hug
          else J.roberta_mlm_wrapper(**SMALL))
    pm = (P.hug_roberta_mlm_wrapper(device="cpu", **SMALL) if hug
          else P.roberta_mlm_wrapper(device="cpu", **SMALL))
    params, want = _jax(jm, ids, mask)
    got = _port(pm, params, ids, mask)
    assert got.shape == (B, S)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_seeded_init_repeats_and_differs():
    """One seed, one set of weights, whatever builds it."""
    a = P.bertweet_wrapper(device="cpu", seed=3, **SMALL).state_dict()
    b = P.bertweet_wrapper(device="cpu", seed=3, **SMALL).state_dict()
    c = P.bertweet_wrapper(device="cpu", seed=4, **SMALL).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["bertweet.pooler.weight"],
                           c["bertweet.pooler.weight"])
