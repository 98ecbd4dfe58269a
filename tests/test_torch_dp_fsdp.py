"""The port's data parallel, FSDP, tensor-parallel serving and the other
trainers' meshes across ranks over gloo, against the JAX package and the
port at one process.

Two spawns (tests/torch_ranks.py: free port, 60 s rendezvous, one 120 s
deadline for the joins):

* world 2: the tiny meant_src of tests/test_torch_train.py (2 + 2
  encoders, width 64, fixed_proj=True, dropout off, at JAX's params) takes
  2 `meant_trainer` steps data parallel on 4-row global batches, held to
  JAX's `meant_trainer` on a 2-device mesh (losses 1e-5 relative,
  parameters 1e-4 relative L2, the key biases, whose gradient is zero in
  exact arithmetic, 3 lr per element) and to the port at one process (the
  same bars); `mlm_pretrainer`, `vqa_trainer` and the text classifier one
  step each, held to one process's loss (1e-6 relative);
  `Predictor(tensor_parallel=True)` on a (1, 2) (data, model) mesh, each
  rank with one of the two heads, held to JAX's Predictor on the same
  mesh within 1e-4; `cli.in_loop_train --fsdp`;
* world 4: the same model 3 steps replicated and with fsdp=True: equal
  losses (1e-6 relative) and parameters (1e-5 relative L2, the key
  biases 3 lr per element), each rank's
  moments ceil(P / 4) elements, gathered whole equal to the replicated
  run's within 1e-5 relative L2; the meshes' axes and shapes, a hybrid
  mesh of 2 nodes of 2 ranks among them; `fsdp_shardings` and
  `fsdp_shard` on tests/test_fsdp.py's cases.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from meant_tpu.models import EmbeddingConfig as JEmb
from meant_tpu.models.meant_src import meant_src as JMeantSrc
from meant_tpu.parallel import make_mesh as j_make_mesh
from meant_tpu.serve import Predictor as JPredictor
from meant_tpu.data.loader import ArrayLoader as JArrayLoader
from meant_tpu.train.classify import meant_trainer as j_meant_trainer
from meant_tpu_torch.weights import state_dict_from_jax

import torch_ranks as R

import torch_threads

torch_threads.share_cores()


class _NoDropout:
    """The JAX model with dropout off inside the JAX trainer's step."""

    def __init__(self, model):
        self.model = model

    def init(self, *args, **kwargs):
        return self.model.init(*args, **kwargs)

    def apply(self, variables, *args, deterministic=True, rngs=None,
              **kwargs):
        return self.model.apply(variables, *args, **kwargs)


def _jax_model():
    return JMeantSrc(embedding=JEmb(**R.EMB), fixed_proj=True, **R.GEOM)


@pytest.fixture(scope="module")
def shared(tmp_path_factory):
    """JAX params (parameters initialised to zero drawn from N(0, 0.02),
    as tests/test_torch_train.py does) and three global batches, written
    for the ranks."""
    tmp = tmp_path_factory.mktemp("layouts")
    batches = [R.meant_src_batch(seed) for seed in (3, 4, 5)]
    sample = {k: jnp.asarray(v) for k, v in batches[0].items() if k != "y"}
    params = jax.jit(_jax_model().init)(jax.random.PRNGKey(1),
                                        **sample)["params"]
    rng = np.random.RandomState(6)
    params = jax.tree.map(
        lambda a: (a if np.any(a) else
                   rng.normal(0, 0.02, a.shape).astype(np.float32)),
        jax.tree.map(np.asarray, params))
    torch.save(state_dict_from_jax(params), tmp / "params.pt")
    np.savez(tmp / "batches.npz", **{f"{i}_{k}": v
                                     for i, b in enumerate(batches)
                                     for k, v in b.items()})
    return tmp, params, batches


@pytest.fixture(scope="module")
def world2(shared):
    tmp, _, _ = shared
    return R.spawn(R.dp_ranks, 2, tmp, state_dict=str(tmp / "params.pt"),
                   batches=str(tmp / "batches.npz"),
                   out_dir=str(tmp / "cli"))


@pytest.fixture(scope="module")
def world4(shared):
    tmp, _, _ = shared
    return R.spawn(R.fsdp_ranks, 4, tmp, local_world=2,
                   state_dict=str(tmp / "params.pt"),
                   batches=str(tmp / "batches.npz"))


def _rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _close_params(got: dict, want: dict, bar: float):
    for name, p in got.items():
        g, ref = p.numpy(), want[name].numpy()
        if name.endswith("k.bias"):
            assert np.abs(g - ref).max() <= 3 * R.TRAIN["lr"], name
        else:
            assert _rel(g, ref) <= bar, name


def test_data_parallel_matches_jax_trainer_on_two_devices(shared, world2):
    _, params, batches = shared
    jt = j_meant_trainer(dict(
        R.TRAIN, model=_NoDropout(_jax_model()), init_params=params,
        train_loader=JArrayLoader(batches[0], R.ROWS),
        mesh=j_make_mesh(devices=jax.devices()[:2])))
    jt._init_state(batches[0])
    jt._build_steps()
    losses = []
    for batch in batches[:2]:
        jt.state, loss, _ = jt._jit_train(jt.state, jt._device_batch(batch))
        losses.append(float(loss))
    want = state_dict_from_jax(jax.tree.map(np.asarray, jt.state.params))
    for rank in world2:
        np.testing.assert_allclose(rank["losses"], losses, rtol=1e-5)
        _close_params(rank["params"], want, 1e-4)


def test_data_parallel_matches_one_process(shared, world2):
    tmp, _, batches = shared
    one = R.train_meant_src(torch.load(tmp / "params.pt"), batches[:2])
    for rank in world2:
        np.testing.assert_allclose(rank["losses"], one["losses"], rtol=1e-5)
        _close_params(rank["params"], one["params"], 1e-4)


@pytest.mark.parametrize("name", list(R.OTHER_TRAINERS))
def test_other_trainers_at_world_two_give_one_process_loss(world2, name):
    want = R.OTHER_TRAINERS[name]()
    for rank in world2:
        np.testing.assert_allclose(rank[name], want, rtol=1e-6)


def test_tensor_parallel_serving_matches_jax(shared, world2):
    _, params, batches = shared
    rows = {k: v for k, v in batches[2].items() if k != "y"}
    mesh = j_make_mesh(axes=("data", "model"), shape=(1, 2),
                       devices=jax.devices()[:2])
    want = JPredictor(_jax_model(), "meant_src", params=params,
                      batch_size=R.ROWS, mesh=mesh,
                      tensor_parallel=True)(rows)
    for rank in world2:
        assert rank["tp_heads"] == (2, 1)           # one head a rank
        assert rank["tp_q_rows"] == 32              # half of q's 64
        np.testing.assert_allclose(rank["tp_probs"], want, atol=1e-4)


def test_fsdp_cli_trains_at_world_two(world2, shared):
    tmp, _, _ = shared
    for rank in world2:
        cli = rank["cli"]
        assert all(np.isfinite(h["train_loss"]) for h in cli["history"])
        assert cli["m"] == math.ceil(cli["n"] / 2)
    assert (tmp / "cli" / "models" / "meant_src").is_dir()
    assert world2[0]["cli"]["history"] == world2[1]["cli"]["history"]


def test_fsdp_matches_replicated_at_world_four(world4):
    for rank in world4:
        dp, fsdp = rank[False], rank[True]
        np.testing.assert_allclose(fsdp["losses"], dp["losses"], rtol=1e-6)
        _close_params(fsdp["params"], dp["params"], 1e-5)
        assert fsdp["m_local"] == math.ceil(fsdp["n"] / 4)
        assert dp["m_local"] == dp["n"] == fsdp["n"]
        assert _rel(fsdp["m"].numpy(), dp["m"].numpy()) <= 1e-5


def test_meshes_at_world_four(world4):
    for r, rank in enumerate(world4):
        flat, grid, hybrid = rank["meshes"]
        assert flat == (("data",), (4,), (r,))
        assert grid[:2] == (("data", "model"), (2, 2))
        assert grid[2] == (r // 2, r % 2)
        assert hybrid[:2] == (("dcn", "model"), (2, 2))   # 2 nodes of 2
        assert hybrid[2] == (r // 2, r % 2)


def test_fsdp_shardings_and_shard_at_world_four(world4):
    """tests/test_fsdp.py's cases: a tensor-parallel placement is left as
    it is, a big leaf shards its largest dim over 'data', a small one
    replicates; fsdp_shard keeps 1/4 of a (1024, 512) leaf a rank."""
    for rank in world4:
        specs = rank["fsdp_specs"]
        assert specs["q"] == ("Replicate()", "Shard(dim=1)")
        assert specs["ff"] == ("Shard(dim=1)", "Replicate()")
        assert specs["bias"] == ("Replicate()", "Replicate()")
        assert rank["fsdp_local"] == {"w": (256, 512), "b": (512,)}
