"""The GPipe pipeline (meant_tpu_torch/parallel/pipeline.py) against the JAX
package's `pipeline_apply` on its 8-device CPU mesh (jitted).

tests/test_pipeline.py's six cases at its bars, the port's schedule
played in one process at 8 stages (`stages=8`: every tick runs each stage
in turn, the shift hands stage s the state of stage s - 1): the MLP
stack's output (1e-5 / 1e-6) at the default and at 16 microbatches, its
gradients (1e-4 / 1e-5), a stack of MEANT LanguageEncoders (xPos
attention with a key mask) forward (2e-4 / 2e-5) and gradients (2e-3 /
1e-5), and the stack placed by `pipeline_stage_shardings` over a real
one-rank ("pipe",) mesh (a gloo group started here and ended after the
test). The weights come from numpy seeds (the MLP) or JAX's init carried
over by `weights.state_dict_from_jax` (the encoders). The P2P run over
four ranks is tests/test_torch_tp_train.py's.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import Shard, distribute_tensor

import jax
import jax.numpy as jnp

from meant_tpu.nn.encoders import LanguageEncoder as JLanguageEncoder
from meant_tpu.parallel import make_mesh as j_make_mesh
from meant_tpu.parallel.pipeline import pipeline_apply as j_pipeline_apply
from meant_tpu.parallel.pipeline import stack_layer_params as j_stack
from meant_tpu_torch.parallel import (make_mesh, pipeline_apply,
                                      pipeline_stage_shardings,
                                      stack_layer_params)
from meant_tpu_torch.weights import state_dict_from_jax

import torch_ranks as R

import torch_threads

torch_threads.share_cores()

STAGES = 8


def _j_mlp(params, x):
    h = jnp.tanh(x @ params["w1"] + params["b1"])
    return x + h @ params["w2"]


def _j_pipe(layer, stacked, x, microbatches=None, grad_of=None):
    """JAX's pipeline output (or the gradients of `grad_of(output)` at the
    stacked params) on its 8-device ("pipe",) mesh, jitted."""
    mesh = j_make_mesh(axes=("pipe",))

    def run(p, x_):
        return j_pipeline_apply(layer, p, x_, mesh=mesh, axis="pipe",
                                microbatches=microbatches)
    if grad_of is None:
        return jax.tree.map(np.asarray, jax.jit(run)(stacked, x))
    return jax.tree.map(np.asarray, jax.jit(jax.grad(
        lambda p: grad_of(run(p, x))))(stacked))


def _mlp(seed, n_layers=8):
    trees = R.mlp_trees(n_layers, seed=seed)
    return (j_stack([{k: jnp.asarray(v) for k, v in t.items()}
                     for t in trees]), R.stacked_tensors(trees))


@pytest.mark.parametrize("n_layers,rows,micro,seed", [
    (8, 32, None, 0),           # test_pipeline_matches_sequential
    (16, 48, 16, 2)])           # test_pipeline_more_microbatches
def test_mlp_pipeline_matches_jax(n_layers, rows, micro, seed):
    j_stacked, stacked = _mlp(seed, n_layers)
    x = np.random.RandomState(seed + 1).randn(rows, 16).astype(np.float32)
    want = _j_pipe(_j_mlp, j_stacked, jnp.asarray(x), micro)
    got = pipeline_apply(R._mlp_layer, stacked, torch.tensor(x),
                         stages=STAGES, microbatches=micro)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_mlp_pipeline_gradients_match_jax():
    j_stacked, stacked = _mlp(4)
    x = np.random.RandomState(5).randn(16, 16).astype(np.float32)
    want = _j_pipe(_j_mlp, j_stacked, jnp.asarray(x),
                   grad_of=lambda o: jnp.sum(o ** 2))
    _, got = R.pipe_run(R._mlp_layer, stacked, torch.tensor(x),
                        lambda o: o.square().sum(), stages=STAGES)
    for k, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[k], rtol=1e-4,
                                   atol=1e-5, err_msg=k)


def _lang_stack(seed):
    """tests/test_pipeline.py's stack of 8 JAX LanguageEncoders (width 64,
    4 heads, rot_dim 8), and the port's encoder holding layer 0's
    buffers with the 8 layers' parameters stacked."""
    enc = JLanguageEncoder(64, 4, ff_dropout=0.0, rot_dim=8)
    x0, m0 = jnp.zeros((2, 8, 64)), jnp.ones((2, 8))
    key = jax.random.PRNGKey(seed)
    init = jax.jit(enc.init)
    trees = [jax.tree.map(np.asarray,
                          init(jax.random.fold_in(key, i), x0, m0)["params"])
             for i in range(8)]
    port = R.language_encoder()
    sds = [state_dict_from_jax(t) for t in trees]
    port.load_state_dict(sds[0])
    names = [k for k, _ in port.named_parameters()]
    stacked = stack_layer_params([{k: sd[k] for k in names} for sd in sds])

    def j_layer(p, state):
        h, mask = state
        return enc.apply({"params": p}, h, mask), mask
    return j_layer, j_stack(trees), port, stacked


def test_language_encoder_pipeline_matches_jax():
    j_layer, j_stacked, port, stacked = _lang_stack(0)
    rng = np.random.RandomState(8)
    h = rng.randn(16, 8, 64).astype(np.float32)
    mask = (rng.rand(16, 8) > 0.3).astype(np.float32)
    mask[:, 0] = 1.0
    want, _ = _j_pipe(j_layer, j_stacked, (jnp.asarray(h),
                                           jnp.asarray(mask)))
    got, got_mask = pipeline_apply(R.language_layer(port), stacked,
                                   (torch.tensor(h), torch.tensor(mask)),
                                   stages=STAGES)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=2e-4,
                               atol=2e-5)
    np.testing.assert_array_equal(got_mask.numpy(), mask)


def test_language_encoder_pipeline_gradients_match_jax():
    j_layer, j_stacked, port, stacked = _lang_stack(9)
    rng = np.random.RandomState(10)
    h = rng.randn(8, 8, 64).astype(np.float32)
    mask = np.ones((8, 8), np.float32)
    grads = _j_pipe(j_layer, j_stacked, (jnp.asarray(h), jnp.asarray(mask)),
                    grad_of=lambda o: jnp.mean(o[0] ** 2))
    want = stack_layer_params([
        state_dict_from_jax(jax.tree.map(lambda a, i=i: a[i], grads))
        for i in range(8)])
    _, got = R.pipe_run(R.language_layer(port), stacked,
                        (torch.tensor(h), torch.tensor(mask)),
                        lambda o: o[0].square().mean(), stages=STAGES)
    for k, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[k].numpy(), rtol=2e-3,
                                   atol=1e-5, err_msg=k)


@pytest.fixture
def one_rank():
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def test_placed_stack_over_a_one_rank_mesh_matches_jax(one_rank):
    """tests/test_pipeline.py's sharded-params case: each leaf placed by
    `pipeline_stage_shardings` (its layer axis over 'pipe') and run over
    a real mesh, here of one rank, at 8 microbatches."""
    j_stacked, stacked = _mlp(6)
    x = np.random.RandomState(7).randn(32, 16).astype(np.float32)
    want = _j_pipe(_j_mlp, j_stacked, jnp.asarray(x))
    mesh = make_mesh(("pipe",), device="cpu")
    specs = pipeline_stage_shardings(stacked, mesh)
    assert specs == {k: (Shard(0),) for k in stacked}
    placed = {k: distribute_tensor(v, mesh, specs[k])
              for k, v in stacked.items()}
    got = pipeline_apply(R._mlp_layer, placed, torch.tensor(x), mesh=mesh,
                         microbatches=8)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
