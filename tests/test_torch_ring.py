"""Ring attention of the port (meant_tpu_torch/ops/ring.py) at world 4 over
gloo against the JAX package's on a 4-device CPU mesh.

One spawn of 4 ranks (tests/torch_ranks.py: free port, 60 s rendezvous,
one 120 s deadline for the joins) runs `ring_attend` at (2, 4, 256, 32)
(tests/test_ring.py's geometry), causal and not and with a padding mask,
through the dense body and through the flash engine (the plain versions
of R1 + K3 and R1 + K4 + K5 on the CPU), and two LanguageEncoders of width
64 in 4 heads with `ring_mesh` (dense and flash engines) on each rank's
chunk of a 256-token sequence. Bars, fp32: the dense ring's output and
the gradients of sum(out^2) at q, k and v within 1e-5 of JAX's dense ring;
the flash engine within 1e-4 relative / 1e-5 absolute of JAX's flash ring
(interpret mode); the encoders' output within 1e-4 / 1e-5 of JAX's dense
encoder and of its ring encoder, each parameter gradient (summed over the
ranks) within 1e-4 relative L2 of theirs. The encoders' xPos tables are
the global sequence's rows, so an offset error shows in the output.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as fnn

from meant_tpu.nn.encoders import LanguageEncoder as JLanguageEncoder
from meant_tpu.ops.ring import ring_attend as j_ring_attend
from meant_tpu.parallel import make_mesh as j_make_mesh
from meant_tpu_torch.weights import state_dict_from_jax

import torch_ranks

import torch_threads

torch_threads.share_cores()

B, H, S, D = 2, 4, 256, 32
SCALE = 1.0 / np.sqrt(D)
WORLD = 4


class JRingEncoders(fnn.Module):
    ring_mesh: object = None
    ring_flash: bool = False

    @fnn.compact
    def __call__(self, x, mask):
        for i in range(2):
            x = JLanguageEncoder(64, 4, ring_mesh=self.ring_mesh,
                                 ring_flash=self.ring_flash,
                                 name=f"languageEncoders_{i}")(x, mask)
        return x


def _inputs():
    rng = np.random.RandomState(0)
    q, k, v = (rng.randn(B, H, S, D).astype(np.float32) * 0.5
               for _ in range(3))
    mask = np.ones((B, S), np.float32)
    mask[0, 200:] = 0
    mask[1, 40:] = 0
    x = rng.randn(B, S, 64).astype(np.float32) * 0.5
    return dict(q=q, k=k, v=v, mask=mask, x=x, x_mask=mask,
                scale=np.float32(SCALE))


@pytest.fixture(scope="module")
def ring(tmp_path_factory):
    """The ranks' results (each case's output concatenated over the
    ranks, the input gradients and the parameter gradients summed), the
    inputs and the encoders' JAX params."""
    tmp = tmp_path_factory.mktemp("ring")
    d = _inputs()
    np.savez(tmp / "inputs.npz", **d)
    x = jnp.asarray(d["x"])
    mask = jnp.asarray(d["x_mask"])
    params = jax.jit(JRingEncoders().init)(jax.random.PRNGKey(0), x,
                                           mask)["params"]
    params = jax.tree.map(np.asarray, params)
    torch.save(state_dict_from_jax(params), tmp / "encoder.pt")
    ranks = torch_ranks.spawn(torch_ranks.ring_ranks, WORLD, tmp,
                              inputs=str(tmp / "inputs.npz"),
                              encoder=str(tmp / "encoder.pt"))
    got = {}
    for name in torch_ranks.RING_CASES:
        out = torch.cat([r[name][0] for r in ranks], dim=2).numpy()
        grads = [sum(r[name][1][i] for r in ranks).numpy()
                 for i in range(3)]
        got[name] = (out, grads)
    for flash in (False, True):
        key = f"encoder_{flash}"
        out = torch.cat([r[key][0] for r in ranks], dim=1).numpy()
        grads = {n: sum(r[key][1][n] for r in ranks).numpy()
                 for n in ranks[0][key][1]}
        got[key] = (out, grads)
    return got, d, params


def _jax_ring(d, use_flash, causal, masked):
    mesh = j_make_mesh(devices=jax.devices()[:WORLD])
    mask = jnp.asarray(d["mask"]) if masked else None

    def loss(q, k, v):
        out = j_ring_attend(q, k, v, mesh=mesh, scale=SCALE, causal=causal,
                            attention_mask=mask, use_flash=use_flash)
        return jnp.sum(out ** 2), out

    (_, out), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(
        *(jnp.asarray(d[n]) for n in ("q", "k", "v")))
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("name", list(torch_ranks.RING_CASES))
def test_ring_attend_matches_jax_ring(ring, name):
    got, d, _ = ring
    use_flash, causal, masked = torch_ranks.RING_CASES[name]
    want, want_grads = _jax_ring(d, use_flash, causal, masked)
    out, grads = got[name]
    tol = dict(rtol=1e-4, atol=1e-5) if use_flash else dict(rtol=1e-5,
                                                           atol=1e-5)
    np.testing.assert_allclose(out, want, **tol)
    for g, w, n in zip(grads, want_grads, "qkv"):
        np.testing.assert_allclose(g, w, err_msg=f"d{n}", **tol)


@pytest.mark.parametrize("ring_flash", [False, True],
                         ids=["dense_ring", "flash_ring"])
@pytest.mark.parametrize("reference", ["jax_dense", "jax_ring"])
def test_ring_encoders_match_jax(ring, ring_flash, reference):
    got, d, params = ring
    x, mask = jnp.asarray(d["x"]), jnp.asarray(d["x_mask"])
    mesh = (j_make_mesh(devices=jax.devices()[:WORLD])
            if reference == "jax_ring" else None)
    model = JRingEncoders(ring_mesh=mesh)

    def loss(p):
        out = model.apply({"params": p}, x, mask)
        return jnp.sum(out ** 2), out

    (_, want), want_grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params)
    out, grads = got[f"encoder_{ring_flash}"]
    np.testing.assert_allclose(out, np.asarray(want), rtol=1e-4, atol=1e-5)
    want_sd = state_dict_from_jax(jax.tree.map(np.asarray, want_grads))
    assert set(grads) <= set(want_sd)
    for name, g in grads.items():
        ref = want_sd[name].numpy()
        assert np.linalg.norm(g - ref) <= 1e-4 * np.linalg.norm(ref), name
