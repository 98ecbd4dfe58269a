"""meant_src in the port against JAX meant_src at shared weights, on the CPU.

Small geometry with the main path's head shape: dim 192 in 2 heads (head
dim 96, xPos rotating 48), two encoders, s=48 tokens against a 40-row
position table (so the position-id clamp runs), 32x32 charts (4 patches).
JAX params go through `state_dict_from_jax` into the port. fp32 bar: 1e-4
on the probabilities and on both tower outputs (taken with forward hooks,
since at fixed_proj=False the towers do not reach the probabilities).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from meant_tpu.models import EmbeddingConfig as JEmb
from meant_tpu.models.meant_src import meant_src as JMeantSrc
from meant_tpu.nn.embeddings import RobertaEmbeddings as JRoberta
from meant_tpu_torch.models import EmbeddingConfig, meant_src
from meant_tpu_torch.nn.embeddings import RobertaEmbeddings, clamped_lookup
from meant_tpu_torch.weights import load_jax_params, state_dict_from_jax

import torch_threads

torch_threads.share_cores()

GEOM = dict(text_dim=192, image_dim=192, price_dim=5, height=32, width=32,
            patch_res=16, lag=5, num_classes=2, num_heads=2, num_encoders=2,
            channels=3, seq_len=48)
EMB = dict(vocab_size=100, hidden_size=192, max_position_embeddings=40,
           dropout=0.0)
B, S = 2, 48


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(2, 100, (B, 5, S)).astype(np.int32)
    ids[0, 1, 30:] = 1                        # padding: pad id 1
    return {"input_ids": ids,
            "pixels": rng.randn(B, 5, 3, 32, 32).astype(np.float32),
            "prices": rng.randn(B, 5, 5).astype(np.float32),
            "attention_mask": (ids != 1).astype(np.float32)}


def _jax_run(fixed_proj, dtype=None):
    """JAX params (numpy), probabilities and tower outputs."""
    model = JMeantSrc(embedding=JEmb(**EMB), fixed_proj=fixed_proj,
                      dtype=dtype, **GEOM)
    batch = {k: jnp.asarray(v) for k, v in _batch().items()}
    params = jax.jit(model.init)(jax.random.PRNGKey(1), **batch)["params"]
    out, state = jax.jit(lambda p, b: model.apply(
        {"params": p}, **b, capture_intermediates=True))(params, batch)
    inter = state["intermediates"]
    last = GEOM["num_encoders"] - 1
    towers = {
        "text": inter[f"languageEncoders_{last}"]["__call__"][0],
        "vision": inter[f"visionEncoders_{last}"]["__call__"][0]}
    to_np = lambda t: np.asarray(t, np.float32)
    return (jax.tree.map(np.asarray, params), to_np(out),
            {k: to_np(v) for k, v in towers.items()})


def _port_run(params, fixed_proj, dtype=None, flash=False, mask=True):
    model = meant_src(embedding=EmbeddingConfig(**EMB), fixed_proj=fixed_proj,
                      dtype=dtype, flash=flash, device="cpu", **GEOM).eval()
    load_jax_params(model, params)
    towers = {}
    hooks = [model.languageEncoders.register_forward_hook(
                 lambda m, i, o: towers.__setitem__("text", o)),
             model.visionEncoders.register_forward_hook(
                 lambda m, i, o: towers.__setitem__("vision", o))]
    batch = {k: torch.as_tensor(v) for k, v in _batch().items()
             if mask or k != "attention_mask"}
    with torch.no_grad():
        out = model(**batch)
    for h in hooks:
        h.remove()
    return (out.float().numpy(),
            {k: v.float().numpy() for k, v in towers.items()})


@pytest.fixture(scope="module", params=[False, True], ids=["bug_faithful",
                                                           "fixed_proj"])
def jax_fp32(request):
    return request.param, _jax_run(request.param)


def test_probs_and_towers_match_jax_fp32(jax_fp32):
    fixed_proj, (params, probs, towers) = jax_fp32
    p_probs, p_towers = _port_run(params, fixed_proj)
    assert p_probs.shape == (B, 2)
    np.testing.assert_allclose(p_probs, probs, rtol=1e-4, atol=1e-4)
    for name in ("text", "vision"):
        np.testing.assert_allclose(p_towers[name], towers[name], rtol=1e-4,
                                   atol=1e-4, err_msg=name)


def test_flash_path_on_cpu_matches_jax(jax_fp32):
    """flash=True on the CPU runs the kernel's plain version. The vision
    tower matches JAX as it is; the language encoders drop the padding mask
    on the flash path (as the reference does), so the flash model with a
    mask equals the plain model without one."""
    fixed_proj, (params, probs, towers) = jax_fp32
    assert _batch()["attention_mask"].min() == 0
    f_probs, f_towers = _port_run(params, fixed_proj, flash=True)
    np.testing.assert_allclose(f_towers["vision"], towers["vision"],
                               rtol=1e-4, atol=1e-4)
    n_probs, n_towers = _port_run(params, fixed_proj, mask=False)
    np.testing.assert_allclose(f_towers["text"], n_towers["text"],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(f_probs, n_probs, rtol=1e-5, atol=1e-6)


def test_bf16_matches_jax_within_bf16_bar():
    """bf16 activations, fp32 params. bf16 keeps 8 bits of mantissa and the
    two frameworks round at different places (GELU, matmul outputs), so
    the bar is 1e-2 absolute on the probabilities (a bf16 step near 0.5 is
    3.9e-3) and 3% of the tower's largest value on the tower outputs
    (seen: 1%)."""
    params, probs, towers = _jax_run(True, dtype=jnp.bfloat16)
    p_probs, p_towers = _port_run(params, True, dtype=torch.bfloat16)
    np.testing.assert_allclose(p_probs, probs, atol=1e-2)
    for name in ("text", "vision"):
        scale = np.abs(towers[name]).max()
        np.testing.assert_allclose(p_towers[name], towers[name],
                                   atol=0.03 * scale, err_msg=name)


def test_state_dict_from_jax_uses_every_key_once(jax_fp32):
    fixed_proj, (params, _, _) = jax_fp32
    sd = state_dict_from_jax(params)
    n_leaves = len(jax.tree.leaves(params))
    model = meant_src(embedding=EmbeddingConfig(**EMB), fixed_proj=fixed_proj,
                      device="cpu", **GEOM)
    assert len(sd) == n_leaves
    assert set(sd) == set(model.state_dict())
    # Dense kernels are transposed to (out, in)
    k = params["languageEncoders_0"]["attn"]["q"]["dense"]["kernel"]
    np.testing.assert_array_equal(
        sd["languageEncoders.0.attn.q.weight"].numpy(), k.T)


def test_weight_transfer_refuses_unknown_missing_and_misshaped(jax_fp32):
    fixed_proj, (params, _, _) = jax_fp32
    model = meant_src(embedding=EmbeddingConfig(**EMB), fixed_proj=fixed_proj,
                      device="cpu", **GEOM)
    extra = dict(params, stray={"weird_leaf": np.zeros(3, np.float32)})
    with pytest.raises(KeyError):
        state_dict_from_jax(extra)
    missing = {k: v for k, v in params.items() if k != "patchEmbed"}
    with pytest.raises(RuntimeError):
        load_jax_params(model, missing)
    wrong = dict(params, patchEmbed={"dense": {
        "kernel": np.zeros((3, 3), np.float32),
        "bias": params["patchEmbed"]["dense"]["bias"]}})
    with pytest.raises(ValueError):
        load_jax_params(model, wrong)


def test_position_ids_clamp_to_last_row_like_jax():
    """s=48 against a 40-row position table: ids reach 49. JAX's gather
    clamps them to row 39; the port clamps the same way."""
    ids = np.random.RandomState(3).randint(2, 100, (2, S)).astype(np.int32)
    jm = JRoberta(vocab_size=100, hidden_size=192, max_position_embeddings=40)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(2), jnp.asarray(ids))["params"]
    j_out = np.asarray(jax.jit(lambda p, x: jm.apply({"params": p}, x))(
        jp, jnp.asarray(ids)))
    tm = RobertaEmbeddings(vocab_size=100, hidden_size=192,
                           max_position_embeddings=40, device="cpu").eval()
    tm.load_state_dict(state_dict_from_jax(jp))
    with torch.no_grad():
        t_out = tm(torch.as_tensor(ids, dtype=torch.int64)).numpy()
    np.testing.assert_allclose(t_out, j_out, rtol=1e-5, atol=1e-5)
    table = torch.arange(40.0)[:, None]
    got = clamped_lookup(table, torch.tensor([0, 39, 40, 513]))
    assert got.flatten().tolist() == [0.0, 39.0, 39.0, 39.0]
