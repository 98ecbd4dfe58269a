"""Tensor-parallel training, int8 under tensor parallelism and the pipeline
over P2P, across four ranks over gloo, against the JAX package and the
port at one process.

One world-4 spawn (tests/torch_ranks.py `tp_ranks`: free port, 60 s
rendezvous, one 120 s deadline for the joins), every model cut by
`parallelize_model`:

* `meant` (__graft_entry__.py's dp x tp model, 8 heads of 8, at lag 2)
  dp x tp (2, 2), fsdp x tp (2, 2) and on the hybrid (dcn, model) mesh of
  2 nodes of 2; meant_timesformer dp x tp (2, 2) with scan_layers and
  remat "dots": each rank's gradients, averaged over the data axis and
  gathered whole over the model axis, against JAX's on its (2, 2) mesh
  at 1e-4 max abs (__graft_entry__.py's bar); one FlatAdam step with the
  clip engaged: the clip's global norm against the one-process step's
  (1e-4 relative: fp32 sums over 1.3e5 and 4.8e5 entries in other
  orders read 1.3e-5) and the parameters after the step at 1e-5 relative
  L2;
* `meant` at (1, 4) with its dropout on: the same masks on every rank of
  the model axis, so the gradients equal the one-process step's (1e-6
  max abs);
* `Predictor(tensor_parallel=True, quantize="int8")` at (1, 4) and (2, 2)
  against JAX's replicated int8 Predictor at atol 2e-5
  (tests/test_quant.py's bar for its own TP int8);
* `pipeline_apply` over a ("pipe",) mesh of 4 ranks (real P2P): the MLP
  and LanguageEncoder stacks of tests/test_torch_pipeline.py, output and
  gradients against the pipeline played in one process (1e-6 max abs).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from meant_tpu.models import EmbeddingConfig as JEmb
from meant_tpu.models import meant as JMeant
from meant_tpu.models.meant_timesformer import meant_timesformer as JMTS
from meant_tpu.parallel import batch_sharding as j_batch_sharding
from meant_tpu.parallel import make_mesh as j_make_mesh
from meant_tpu.parallel import shard_params as j_shard_params
from meant_tpu.serve import Predictor as JPredictor
from meant_tpu.train.classify import model_inputs as j_model_inputs
from meant_tpu.train.classify import sigmoid_ce_loss as j_loss
from meant_tpu_torch.weights import state_dict_from_jax

import torch_ranks as R

import torch_threads

torch_threads.share_cores()

GRAD_ATOL = 1e-4
NORM_RTOL = 1e-4
STEP_REL_L2 = 1e-5
INT8_ATOL = 2e-5


def _jax_grads(model, name, params, batch):
    """JAX's gradients of the trainer's loss, params cut by its megatron
    rules on a (2, 2) (data, model) mesh, the batch on 'data'."""
    mesh = j_make_mesh(axes=("data", "model"), shape=(2, 2),
                       devices=jax.devices()[:4])

    def loss(p, b):
        args, kwargs = j_model_inputs(name, b)
        return j_loss(model.apply({"params": p}, *args, **kwargs), b["y"])

    db = {k: jax.device_put(jnp.asarray(v), j_batch_sharding(mesh))
          for k, v in batch.items()}
    grads = jax.jit(jax.grad(loss))(j_shard_params(params, mesh), db)
    return state_dict_from_jax(jax.tree.map(np.asarray, grads))


@pytest.fixture(scope="module")
def shared(tmp_path_factory):
    """JAX's models, params and gradients, and the inputs the ranks read."""
    tmp = tmp_path_factory.mktemp("tp_train")
    batch = R.tp_meant_batch()
    jm = JMeant(embedding=JEmb(**R.TP_EMB), **R.TP_GEOM)
    params = jax.jit(jm.init)(
        jax.random.PRNGKey(0), jnp.asarray(batch["tweets"]),
        jnp.asarray(batch["graphs"]), jnp.asarray(batch["attention_masks"]))[
        "params"]
    params = jax.tree.map(np.asarray, params)
    ts_b = R.ts_batch()
    jts = JMTS(embedding=JEmb(**R.TS_EMB), **R.TS_GEOM)
    ts_params = jax.tree.map(np.asarray, jax.jit(
        lambda key: jts.init(key, **{k: jnp.asarray(v) for k, v in
                                     ts_b.items() if k != "y"},
                             deterministic=True))(jax.random.PRNGKey(11))[
        "params"])
    ref = {"meant": _jax_grads(jm, "meant", params, batch),
           "ts": _jax_grads(jts, "meant_timesformer", ts_params, ts_b),
           "int8": JPredictor(jm, "meant", params=params,
                              batch_size=R.TP_ROWS, quantize="int8")(
               {k: v for k, v in batch.items() if k != "y"})}
    inputs = {"meant": state_dict_from_jax(params), "meant_batch": batch,
              "ts": state_dict_from_jax(ts_params), "ts_batch": ts_b,
              **R.pipe_inputs()}
    torch.save(inputs, tmp / "inputs.pt")
    return tmp, inputs, ref


@pytest.fixture(scope="module")
def world4(shared):
    tmp, _, _ = shared
    return R.spawn(R.tp_ranks, 4, tmp, local_world=2,
                   inputs=str(tmp / "inputs.pt"))


@pytest.fixture(scope="module")
def one_process(shared):
    _, inputs, _ = shared
    return {"meant": R.tp_step("meant", inputs["meant"],
                               inputs["meant_batch"]),
            "ts": R.tp_step("meant_timesformer", inputs["ts"],
                            inputs["ts_batch"]),
            "dropout": R.tp_step("meant", inputs["meant"],
                                 inputs["meant_batch"], dropout=True)}


def _rel(a: dict, b: dict) -> float:
    num = sum(float((a[k] - b[k]).double().square().sum()) for k in b)
    den = sum(float(b[k].double().square().sum()) for k in b)
    return (num / den) ** 0.5


LAYOUTS = {"dp_tp": "meant", "fsdp_tp": "meant", "hybrid": "meant",
           "ts_dp_tp": "ts"}


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_tensor_parallel_gradients_match_jax(shared, world4, layout):
    _, _, ref = shared
    want = ref[LAYOUTS[layout]]
    for rank in world4:
        got = rank[layout]["grads"]
        assert set(got) <= set(want)
        for name, g in got.items():
            err = np.abs(g.numpy() - want[name].numpy()).max()
            assert err <= GRAD_ATOL, (layout, name, err)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_tensor_parallel_step_matches_one_process(shared, world4,
                                                  one_process, layout):
    """The clip is engaged (norm > TP_OPT's clip_norm) and its global norm,
    summed from the sharded and replicated parts, is the one-process one;
    the parameters after the step are the one-process step's."""
    _, inputs, _ = shared
    key = LAYOUTS[layout]
    one = one_process[key]
    start = inputs[key]
    assert one["norm"] > R.TP_OPT["clip_norm"]
    for rank in world4:
        got = rank[layout]
        assert abs(got["norm"] - one["norm"]) <= NORM_RTOL * one["norm"]
        after = {k: start[k] + u for k, u in got["update"].items()}
        want = {k: start[k] + u for k, u in one["update"].items()}
        assert _rel(after, want) <= STEP_REL_L2, layout
        assert abs(got["loss"] - one["loss"]) <= 1e-6 * abs(one["loss"])


def test_hybrid_mesh_is_dcn_by_model(world4):
    assert all(rank["hybrid_axes"] == ("dcn", "model") for rank in world4)


def test_dropout_masks_agree_over_the_model_axis(world4, one_process):
    one = one_process["dropout"]
    for rank in world4:
        got = rank["dropout_tp"]
        assert got["loss"] == pytest.approx(one["loss"], rel=1e-6)
        for name, g in got["grads"].items():
            assert (g - one["grads"][name]).abs().max() <= 1e-6, name


@pytest.mark.parametrize("mesh", ["1x4", "2x2"])
def test_int8_under_tensor_parallelism_matches_jax(shared, world4, mesh):
    _, _, ref = shared
    for rank in world4:
        np.testing.assert_allclose(rank[f"int8_{mesh}"], ref["int8"],
                                   atol=INT8_ATOL)


@pytest.mark.parametrize("case", ["mlp", "lang"])
def test_pipeline_over_p2p_matches_played(shared, world4, case):
    """4 stages over gloo P2P against the same schedule played in one
    process: the output on every rank, and the stage's gradients (zero at
    the other stages' layers) summing to the played ones."""
    _, inputs, _ = shared
    out, grads = R.pipe_case(case, inputs, stages=4)
    got_grads = {k: sum(rank[f"pipe_{case}"][1][k] for rank in world4)
                 for k in grads}
    for rank in world4:
        got = rank[f"pipe_{case}"][0]
        got = got if case == "mlp" else got[0]
        want = out if case == "mlp" else out[0]
        assert (got - want).abs().max() <= 1e-6
    for k, g in grads.items():
        assert (got_grads[k] - g).abs().max() <= 1e-6, k
