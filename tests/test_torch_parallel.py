"""The port's parallel layouts (meant_tpu_torch/parallel/, ops/ring.py) as
functions, and at one rank in this process.

Pure functions, no processes: `fsdp_spec` on tests/test_fsdp.py's cases
against JAX's, `fsdp_shardings` on a stand-in mesh, `param_shardings` over
the port's names against JAX's column / row / vocab choice on every
Linear and Embedding of a meant_src (a (2, 4) (data, model) mesh, as
tests/test_tp_sharding.py lays it), and `shard_params`' slices.

At one rank (a gloo group started here and ended after each test), where
every collective is a copy: `make_mesh`'s axes and shapes; `ring_attend`
through the flash engine bit for bit `flash_mha(force_online=True)`;
`Predictor(tensor_parallel=True)` on a (1, 1) (data, model) mesh bit for
bit the plain Predictor.
"""

import types

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard

import jax
from jax.sharding import PartitionSpec as P

from meant_tpu.parallel import fsdp_spec as j_fsdp_spec
from meant_tpu.parallel import make_mesh as j_make_mesh
from meant_tpu.parallel import param_shardings as j_param_shardings
from meant_tpu_torch.ops.flash.kernel import flash_mha
from meant_tpu_torch.ops.ring import ring_attend
from meant_tpu_torch.parallel import (fsdp_shardings, fsdp_spec, make_mesh,
                                      param_shardings, shard_params)
from meant_tpu_torch.serve import Predictor
from meant_tpu_torch.weights import state_dict_from_jax

import torch_ranks as R

import torch_threads

torch_threads.share_cores()


class _Mesh:
    """A stand-in for a DeviceMesh: its axis names and sizes, rank 0."""

    def __init__(self, names, shape):
        self.mesh_dim_names = tuple(names)
        self._sizes = dict(zip(names, shape))

    def __getitem__(self, name):
        return types.SimpleNamespace(size=lambda: self._sizes[name])

    def get_local_rank(self, name):
        return 0


def _port_placement(spec: P):
    """JAX's spec on a 'data' axis as the port's placement."""
    for d, name in enumerate(spec):
        if name == "data":
            return Shard(d)
    return Replicate()


@pytest.mark.parametrize("shape,n,min_size", [
    ((768, 3072), 8, 0), ((3072, 768), 8, 0), ((1001, 768), 8, 0),
    ((7, 13), 8, 0), ((768,), 8, None), ((), 8, None), ((768, 768), 1, 0)])
def test_fsdp_spec_matches_jax(shape, n, min_size):
    kw = {} if min_size is None else {"min_size": min_size}
    assert fsdp_spec(shape, n, **kw) == _port_placement(
        j_fsdp_spec(shape, n, **kw))


def test_fsdp_shardings_shard_data_and_replicate_small_leaves():
    mesh = _Mesh(("data", "model"), (4, 2))
    tree = {"ff": torch.zeros(256, 1024), "bias": torch.zeros(256),
            "layers": [torch.zeros(512, 64)]}
    specs = fsdp_shardings(tree, mesh)
    assert specs["ff"] == (Shard(1), Replicate())
    assert specs["bias"] == (Replicate(), Replicate())
    assert specs["layers"][0] == (Shard(0), Replicate())


@pytest.fixture(scope="module")
def meant_src_params():
    """JAX params of the tiny meant_src and the port's state dict of
    them."""
    from meant_tpu.models import EmbeddingConfig as JEmb
    from meant_tpu.models.meant_src import meant_src as JMeantSrc
    batch = R.meant_src_batch(0)
    model = JMeantSrc(embedding=JEmb(**R.EMB), fixed_proj=True, **R.GEOM)
    params = jax.jit(model.init)(jax.random.PRNGKey(1), **{
        k: v for k, v in batch.items() if k != "y"})["params"]
    params = jax.tree.map(np.asarray, params)
    return params, state_dict_from_jax(params)


def _jax_choice(path: str, leaf_ndim: int, spec: P) -> int:
    """The port's sharded dim of a JAX leaf's spec on 'model' (-1 for
    replicated): a Flax kernel (in, out) is the port's (out, in)."""
    dims = [d for d, name in enumerate(spec) if name == "model"]
    if not dims:
        return -1
    return 1 - dims[0] if path.endswith("['kernel']") and leaf_ndim == 2 \
        else dims[0]


def test_param_shardings_match_jax_choice(meant_src_params):
    params, sd = meant_src_params
    jmesh = j_make_mesh(axes=("data", "model"), shape=(2, 4))
    jspecs = j_param_shardings(params, jmesh)
    codes = jax.tree_util.tree_map_with_path(
        lambda path, leaf, spec: np.full(
            leaf.shape, _jax_choice(jax.tree_util.keystr(path), leaf.ndim,
                                    spec.spec)),
        params, jspecs)
    want = {k: int(v.reshape(-1)[0]) for k, v in
            state_dict_from_jax(codes).items()}
    got = param_shardings(sd, _Mesh(("data", "model"), (2, 4)))
    sharded = 0
    for name, placements in got.items():
        assert placements[0] == Replicate(), name
        dim = placements[1].dim if isinstance(placements[1], Shard) else -1
        if name.endswith("bias") and dim == 0:
            # the port shards a column-parallel layer's bias with it
            assert got[name[:-4] + "weight"][1] == Shard(0), name
            continue
        assert dim == want[name], name
        sharded += dim >= 0
    assert sharded >= 30
    assert got["embedding.word_embeddings.weight"][1] == Shard(0)
    assert got["languageEncoders.0.attn.q.weight"][1] == Shard(0)
    assert got["languageEncoders.0.attn.multi_mad.weight"][1] == Shard(1)
    # 133 features do not split over 4: replicated, as in JAX
    assert got["temporal_encoding_0.proj_in.weight"][1] == Replicate()


def test_shard_params_cuts_this_ranks_slices(meant_src_params):
    _, sd = meant_src_params
    local = shard_params(sd, _Mesh(("data", "model"), (1, 2)))
    q = "languageEncoders.0.attn.q.weight"
    out = "languageEncoders.0.attn.multi_mad.weight"
    assert torch.equal(local[q], sd[q][:32])
    assert torch.equal(local[out], sd[out][:, :32])
    assert torch.equal(local["embedding.word_embeddings.weight"],
                       sd["embedding.word_embeddings.weight"][:50])
    assert local["languageEncoders.0.norm1.weight"] is \
        sd["languageEncoders.0.norm1.weight"]


@pytest.fixture
def one_rank():
    """A gloo group of this one process, ended after the test."""
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def test_make_mesh_at_one_rank(one_rank):
    flat = make_mesh(device="cpu")
    grid = make_mesh(("data", "model"), (1, 1), device="cpu")
    assert (flat.mesh_dim_names, tuple(flat.shape)) == (("data",), (1,))
    assert (grid.mesh_dim_names, tuple(grid.shape)) == (("data", "model"),
                                                        (1, 1))
    assert dist.get_backend() == "gloo"
    with pytest.raises(ValueError):
        make_mesh(("data",), (2,), device="cpu")


@pytest.mark.parametrize("causal", [False, True])
def test_ring_attend_at_one_rank_is_flash_mha(one_rank, causal):
    mesh = make_mesh(device="cpu")
    rng = np.random.RandomState(4)
    q, k, v = (torch.tensor(rng.randn(2, 4, 64, 32).astype(np.float32))
               for _ in range(3))
    mask = torch.ones(2, 64)
    mask[1, 50:] = 0
    got = ring_attend(q, k, v, mesh=mesh, scale=0.2, causal=causal,
                      attention_mask=mask, use_flash=True)
    want = flash_mha(q, k, v, scale=0.2, causal=causal,
                     attention_mask=mask, force_online=True)
    assert torch.equal(got, want)


def test_tensor_parallel_predictor_at_one_rank_is_plain(one_rank,
                                                        meant_src_params):
    _, sd = meant_src_params
    rows = {k: v for k, v in R.meant_src_batch(7, rows=6).items()
            if k != "y"}
    want = Predictor(R.meant_src_model(sd, flash=True), "meant_src",
                     batch_size=4, device="cpu")(rows)
    mesh = make_mesh(("data", "model"), (1, 1), device="cpu")
    model = R.meant_src_model(sd, flash=True)
    got = Predictor(model, "meant_src", batch_size=4, device="cpu",
                    mesh=mesh, tensor_parallel=True)(rows)
    assert model.embedding.word_embeddings.vocab_shard[1:] == (0, 100)
    np.testing.assert_array_equal(got, want)
