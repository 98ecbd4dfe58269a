"""The streaming backward past d = 256 on the CPU against the JAX package.

On the card, K4 and K5 run in bf16 at a padded width of 384 on the
backwards' sliced wgmma kernels and at 768 on the chain body
(csrc/flash_bwd_chain.cuh), both held there to the port's plain streaming
backward `flash_mha_bwd_online_reference`. Here that plain version, behind
`flash_mha(force_online=True, return_lse=True)`, is held to the JAX
package's streaming kernels `_fwd_online_kernel`, `_bwd_dq_kernel` and
`_bwd_dkdv_kernel` in interpret mode at d = 384 and 768, in the cases
tests/test_torch_flash_head_dims.py does not reach there: a nonzero lse
cotangent (the ring's case: delta = rowsum(dO * out) - g_lse), with causal
xPos and a key mask or with neither, and a batch row whose keys are all
masked, where P = exp(S - lse) is 1 for every key (ROADMAP §3). s = 70
(a ragged 64-row tile), b = 2, one head; fp32 bars rtol 1e-4 / atol 1e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from meant_tpu import ops as jops
from meant_tpu.ops.flash import kernel as jkernel
from meant_tpu.ops.flash.flash_attention import _tables as j_tables
from meant_tpu_torch.ops.flash import (flash_bwd_dkdv, flash_bwd_dq,
                                       flash_bwd_dq_dkdv, flash_mha)

import torch_threads

torch_threads.share_cores()

RTOL, ATOL = 1e-4, 1e-5
B, S = 2, 70
COUNTERS = (flash_bwd_dq, flash_bwd_dkdv, flash_bwd_dq_dkdv)


def _case(d: int, case: str, seed: int):
    """numpy q, k, v, dO (B, 1, S, d), the lse cotangent (B, 1, S, 1), the
    tables (or None), the mask (or None) and the keywords."""
    rng = np.random.RandomState(seed)
    q, k, v, do = [(rng.randn(B, 1, S, d) * 0.5).astype(np.float32)
                   for _ in range(4)]
    dlse = rng.randn(B, 1, S, 1).astype(np.float32)
    tables, mask = None, None
    if case in ("xpos_masked", "pixel_masked_row"):
        xpos = case == "xpos_masked"
        freqs = (jops.lang_freqs if xpos else jops.pixel_freqs)(d // 2)
        tables = [np.asarray(t) for t in j_tables(S, d, freqs, xpos, 512.0)]
        mask = np.ones((B, S), np.float32)
        if xpos:
            mask[0, S - 9:] = 0.0
            mask[1, 3:11] = 0.0
        else:
            mask[1] = 0.0      # every key of the second row masked
    kw = dict(scale=1.0 / np.sqrt(d), causal=case == "xpos_masked")
    return (q, k, v, do, dlse), tables, mask, kw


def _jax_online(q, k, v, do, dlse, tables, mask, kw):
    """JAX out, lse and the gradients of sum(out * dO) + sum(lse * dlse)
    through its streaming kernels (interpret mode on the CPU)."""
    tab = {} if tables is None else dict(zip(("qcos", "qsin", "kcos",
                                              "ksin"), tables))

    def loss(q_, k_, v_):
        out, lse = jkernel.flash_mha(
            q_, k_, v_, attention_mask=None if mask is None
            else jnp.asarray(mask), force_online=True, return_lse=True,
            **tab, **kw)
        return jnp.sum(out * do) + jnp.sum(lse * dlse), (out, lse)

    (_, (out, lse)), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(q, k, v)
    return [np.asarray(a) for a in (out, lse, *grads)]


def _port_online(q, k, v, do, dlse, tables, mask, kw):
    """The port's out, lse and gradients of the same loss on the CPU (the
    plain versions of K3 and of K4 + K5)."""
    tab = {} if tables is None else dict(zip(
        ("qcos", "qsin", "kcos", "ksin"), map(torch.as_tensor, tables)))
    leaves = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    out, lse = flash_mha(*leaves, attention_mask=None if mask is None
                         else torch.as_tensor(mask), force_online=True,
                         return_lse=True, **tab, **kw)
    torch.autograd.backward((out, lse), (torch.as_tensor(do),
                                         torch.as_tensor(dlse)))
    return [out.detach().numpy(), lse.detach().numpy(),
            *(t.grad.numpy() for t in leaves)]


@pytest.mark.parametrize("case", ["xpos_masked", "plain",
                                  "pixel_masked_row"])
@pytest.mark.parametrize("d", [384, 768])
def test_streaming_backward_past_256_matches_pallas(d, case):
    """out, lse and dq, dk, dv through a loss on out and lse at d = 384
    and 768: the plain K4 + K5 (fed delta = rowsum(dO * out) - g_lse)
    against JAX's interpret-mode kernels; no kernel launches on the CPU."""
    inputs, tables, mask, kw = _case(d, case, seed=d + len(case))
    want = _jax_online(*inputs, tables, mask, kw)
    before = [c.launches for c in COUNTERS]
    got = _port_online(*inputs, tables, mask, kw)
    assert [c.launches for c in COUNTERS] == before
    for name, a, b in zip(("out", "lse", "dq", "dk", "dv"), got, want):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL, err_msg=name)
    if case == "pixel_masked_row":
        # P = exp(S - lse) = 1 for every key of the masked row: its dv is
        # the sum of dO over the rows (the resident path's would be 1/S of
        # that)
        np.testing.assert_allclose(got[4][1, 0],
                                   np.broadcast_to(inputs[3][1, 0].sum(0),
                                                   got[4][1, 0].shape),
                                   rtol=1e-4, atol=1e-4)
