"""The port's CRF (meant_tpu_torch/nn/crf.py) on the CPU against the JAX
module: the BIO constraint mask, the NLL and its gradients against
jax.grad, viterbi with and without the constraint (a deliberate tie
included: both take the first index), and CRFTokenClassifier end to end.

Sizes: b=4, s=12, 5 tags (15 for tweetner7's mask); the classifier at 2
layers, width 32 in 4 heads, vocab 100. Bars: NLL, gradients and scores
1e-5 relative (1e-6 absolute), paths equal.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from meant_tpu.nn.crf import CRF as JCRF
from meant_tpu.nn.crf import CRFTokenClassifier as JCRFTC
from meant_tpu.nn.crf import bio_constraint_mask as j_mask
from meant_tpu.train.ner import TokenClassifier as JTokenClassifier
from meant_tpu_torch.cli.common import load_config
from meant_tpu_torch.nn.crf import CRF, CRFTokenClassifier, bio_constraint_mask
from meant_tpu_torch.weights import load_jax_params

import torch_threads

torch_threads.share_cores()

B, S, T = 4, 12, 5
ID2LABEL = {0: "B-a", 1: "I-a", 2: "B-b", 3: "I-b", 4: "O"}
TOL = dict(rtol=1e-5, atol=1e-6)


def _inputs(seed=0):
    """Emissions, tags with -100 at interior positions, and a mask with an
    interior hole, a padded tail and one fully masked row."""
    rng = np.random.RandomState(seed)
    emis = rng.randn(B, S, T).astype(np.float32)
    tags = rng.randint(0, T, (B, S)).astype(np.int32)
    tags[0, [3, 4, 8]] = -100
    tags[1, 0] = -100
    mask = np.ones((B, S), np.float32)
    mask[1, 9:] = 0
    mask[2, 5] = 0
    mask[3] = 0
    return emis, tags, mask


@pytest.fixture(scope="module")
def crfs():
    params = jax.tree.map(np.asarray, jax.jit(JCRF(T).init)(
        jax.random.PRNGKey(0), *map(jnp.asarray, _inputs()))["params"])
    # transitions large enough that the constraint and the path matter
    params = jax.tree.map(lambda a: a * 50.0, params)
    port = CRF(T, device="cpu")
    load_jax_params(port, params)
    return params, port


def test_bio_constraint_mask_equal():
    id2label = {int(k): v for k, v in
                load_config("roberta_tweet")["id2label"].items()}
    for labels in (id2label, ID2LABEL):
        np.testing.assert_array_equal(bio_constraint_mask(labels),
                                      j_mask(labels))


def test_nll_and_gradients_match_jax(crfs):
    params, port = crfs
    emis, tags, mask = _inputs(1)

    def nll(p, e):
        return JCRF(T).apply({"params": p}, e, jnp.asarray(tags),
                             jnp.asarray(mask),
                             method=JCRF.neg_log_likelihood)

    want, (g_p, g_e) = jax.jit(jax.value_and_grad(nll, argnums=(0, 1)))(
        params, jnp.asarray(emis))
    e = torch.tensor(emis, requires_grad=True)
    got = port.neg_log_likelihood(e, torch.as_tensor(tags).long(),
                                  torch.as_tensor(mask))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), **TOL)
    np.testing.assert_allclose(e.grad.numpy(), np.asarray(g_e), **TOL)
    for name in ("transitions", "start_transitions", "end_transitions"):
        np.testing.assert_allclose(getattr(port, name).grad.numpy(),
                                   np.asarray(g_p[name]), **TOL)
    # the fully masked row carries no gradient
    assert not e.grad[3].abs().sum()


@pytest.mark.parametrize("constrained", [False, True])
@pytest.mark.parametrize("tie", [False, True])
def test_viterbi_matches_jax(crfs, constrained, tie):
    params, port = crfs
    emis, _, mask = _inputs(2)
    if tie:
        # whole-number emissions and zero transitions: every step ties
        emis = np.random.RandomState(3).randint(0, 2, emis.shape).astype(
            np.float32)
        params = jax.tree.map(np.zeros_like, params)
        port = CRF(T, device="cpu")
        load_jax_params(port, params)
    cm = bio_constraint_mask(ID2LABEL) if constrained else None
    want_path, want_score = jax.jit(lambda p, e, m: JCRF(T).apply(
        {"params": p}, e, m, constraint_mask=cm, method=JCRF.viterbi))(
        params, jnp.asarray(emis), jnp.asarray(mask))
    path, score = port.viterbi(torch.as_tensor(emis), torch.as_tensor(mask),
                               constraint_mask=cm)
    np.testing.assert_array_equal(path.numpy(), np.asarray(want_path))
    np.testing.assert_allclose(score.numpy(), np.asarray(want_score), **TOL)
    if constrained:
        for row, m in zip(path.numpy(), mask):
            tags = row[m > 0]
            if len(tags):
                assert cm[T, tags[0]] and cm[tags[-1], T + 1]
                assert all(cm[a, b] for a, b in zip(tags, tags[1:]))


def test_crf_token_classifier_matches_jax(crfs):
    rng = np.random.RandomState(4)
    ids = rng.randint(2, 100, (B, S)).astype(np.int32)
    _, tags, mask = _inputs(5)
    ids[1, 9:] = 1
    geometry = dict(num_labels=T, vocab_size=100, hidden_size=32,
                    num_layers=2, num_heads=4, dropout=0.0)
    jm = JCRFTC(**geometry)
    # the two halves' params, drawn apart (an init through the whole
    # module compiles the CRF's scans once more)
    params = {"token_classifier": jax.jit(JTokenClassifier(**geometry).init)(
                  jax.random.PRNGKey(1), ids, mask)["params"],
              "crf": crfs[0]}
    params = jax.tree.map(np.asarray, params)
    model = CRFTokenClassifier(**geometry, device="cpu")
    load_jax_params(model, params)
    model.eval()
    cm = bio_constraint_mask(ID2LABEL)

    @jax.jit
    def run(p):
        return (jm.apply({"params": p}, ids, mask, tags),
                jm.apply({"params": p}, ids, mask, constraint_mask=cm,
                         method=JCRFTC.decode))

    (j_logits, j_nll), (j_path, j_score) = run(params)
    t = [torch.as_tensor(a) for a in (ids, mask, tags)]
    with torch.no_grad():
        logits, nll = model(t[0].long(), t[1], t[2].long())
    path, score = model.decode(t[0].long(), t[1], constraint_mask=cm)
    np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(nll.item(), float(j_nll), **TOL)
    np.testing.assert_array_equal(path.numpy(), np.asarray(j_path))
    np.testing.assert_allclose(score.numpy(), np.asarray(j_score), **TOL)
