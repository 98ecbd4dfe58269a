"""The ranks of the port's multi-process CPU tests, and how they start.

`spawn(fn, world, tmp)` starts `world` processes with the `spawn` start
method (the pytest process holds JAX's threads), each with torchrun's
environment on a free localhost port of its own; the rank calls
`fn(rank, world, **kw)`, whose process group (gloo, `device="cpu"`) is
started by `make_mesh(..., timeout=RENDEZVOUS)`, and writes the dict it
returns to `tmp`. The joins share one deadline, after which live ranks are
killed and the test fails. This module imports no JAX: the ranks run the
port alone, on inputs the tests write with numpy.
"""

from __future__ import annotations

import os
import socket
import time
import traceback
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch import nn

RENDEZVOUS = timedelta(seconds=60)
JOIN_S = 120

# the tiny meant_src of the trainer tests: 2 + 2 encoders, width 64
GEOM = dict(text_dim=64, image_dim=64, price_dim=5, height=32, width=32,
            patch_res=16, lag=5, num_classes=2, num_heads=2, num_encoders=2,
            channels=3, seq_len=16)
EMB = dict(vocab_size=100, hidden_size=64, max_position_embeddings=12,
           dropout=0.0)
TRAIN = dict(model_name="meant_src", lr=1e-3, decay=0.01, lrst="cosine_warm",
             t0=2, seed=0)
ROWS, S = 4, 16
CLI = ["-mn", "meant_src", "-nec", "1", "--synthetic_n", "24",
       "--seq_len", "12", "--image_size", "32", "--text_dim", "32",
       "--image_dim", "32", "--vocab_size", "128", "--num_heads", "4",
       "-tb", "4", "--device", "cpu", "-lrst", "cosine", "-l", "1e-3",
       "-ne", "1"]


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _main(fn, rank, world, port, tmp, local_world, kw):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank % local_world),
                      LOCAL_WORLD_SIZE=str(local_world),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    torch.set_num_threads(1)
    try:
        out = fn(rank, world, **kw)
        torch.save(out, os.path.join(tmp, f"{fn.__name__}_{rank}.pt"))
    except BaseException:
        with open(os.path.join(tmp, f"{fn.__name__}_{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise SystemExit(1)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn, world: int, tmp, local_world=None, timeout=JOIN_S, **kw):
    """Run `fn` on `world` ranks; returns their dicts, rank by rank."""
    tmp = str(tmp)
    ctx = mp.get_context("spawn")
    port = free_port()
    procs = [ctx.Process(target=_main, args=(fn, r, world, port, tmp,
                                             local_world or world, kw))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(deadline - time.monotonic(), 0.0))
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join()
    errors = []
    for r in range(world):
        path = os.path.join(tmp, f"{fn.__name__}_{r}.err")
        if os.path.exists(path):
            with open(path) as f:
                errors.append(f"rank {r}:\n{f.read()}")
    assert not alive, f"{len(alive)} ranks still running after {timeout} s"
    assert all(p.exitcode == 0 for p in procs), "\n".join(errors) or [
        p.exitcode for p in procs]
    return [torch.load(os.path.join(tmp, f"{fn.__name__}_{r}.pt"),
                       weights_only=False) for r in range(world)]


def _mesh(*args, **kw):
    from meant_tpu_torch.parallel import make_mesh
    return make_mesh(*args, device="cpu", timeout=RENDEZVOUS, **kw)


def _tensors(batch: dict) -> dict:
    from meant_tpu_torch.data.loader import host_tensor
    return {k: host_tensor(v) for k, v in batch.items()}


def no_dropout(model):
    for m in model.modules():
        if isinstance(m, nn.Dropout):
            m.p = 0.0
    return model


def meant_src_model(state_dict=None, flash=False):
    from meant_tpu_torch.models import EmbeddingConfig, meant_src
    model = meant_src(embedding=EmbeddingConfig(**EMB), fixed_proj=True,
                      flash=flash, device="cpu", **GEOM)
    if state_dict is not None:
        model.load_state_dict(state_dict)
    return no_dropout(model)


def meant_src_batch(seed: int, rows: int = ROWS) -> dict:
    rng = np.random.RandomState(seed)
    return {"input_ids": rng.randint(2, 100, (rows, 5, S)).astype(np.int32),
            "pixels": rng.randn(rows, 5, 3, 32, 32).astype(np.float32),
            "prices": rng.randn(rows, 5, 5).astype(np.float32),
            "attention_mask": np.ones((rows, 5, S), np.float32),
            "y": (np.arange(rows) % 2).astype(np.int32)}


def train_meant_src(state_dict, batches, mesh=None, fsdp=False) -> dict:
    """meant_trainer steps on the global batches (each rank its rows);
    the losses, the parameters and the optimizer."""
    from meant_tpu_torch.data.loader import ArrayLoader
    from meant_tpu_torch.parallel import shard_batch
    from meant_tpu_torch.train.classify import meant_trainer
    model = meant_src_model(state_dict)
    trainer = meant_trainer(dict(TRAIN, model=model, mesh=mesh, fsdp=fsdp,
                                 train_loader=ArrayLoader(batches[0], ROWS)))
    losses = []
    for batch in batches:
        rows = batch if mesh is None else shard_batch(batch, mesh)
        loss, cm = trainer.train_step(_tensors(rows))
        assert int(cm.sum()) == ROWS
        losses.append(loss.item())
    trainer.optimizer.gather()
    return {"losses": losses, "trainer": trainer,
            "params": {n: p.detach().clone()
                       for n, p in model.named_parameters()}}


# ---- the other trainers: one step each ------------------------------------

def mlm_step(mesh=None) -> float:
    from meant_tpu_torch import models
    from meant_tpu_torch.data import masking
    from meant_tpu_torch.parallel import shard_batch
    from meant_tpu_torch.train.pretrain import mlm_pretrainer
    rng = np.random.RandomState(0)
    ids = rng.randint(3, 99, size=(4, 24)).astype(np.int32)
    ids[1, 10:] = 1
    inputs, labels = masking.mask_tokens(ids, 99, [0, 1, 2], seed=1)
    batch = {"input_ids": inputs, "labels": labels,
             "attention_mask": (ids != 1).astype(np.float32)}
    model = no_dropout(models.meant_language_pretrainer(
        embedding=models.EmbeddingConfig(vocab_size=100, hidden_size=64,
                                         dropout=0.0),
        num_encoders=2, text_dim=64, num_heads=4, ff_dropout=0.0,
        device="cpu"))
    trainer = mlm_pretrainer({"model": model, "train_data": [batch],
                              "mesh": mesh})
    rows = batch if mesh is None else shard_batch(batch, mesh)
    return trainer.train_step(_tensors(rows)).item()


def vqa_step(mesh=None) -> float:
    from meant_tpu_torch.data.loader import ArrayLoader
    from meant_tpu_torch.models import EmbeddingConfig, meant_vqa
    from meant_tpu_torch.parallel import shard_batch
    from meant_tpu_torch.train.vqa import vqa_trainer
    rng = np.random.RandomState(2)
    labels = np.zeros((4, 10), np.float32)
    labels[np.arange(4), rng.randint(0, 10, 4)] = 1.0
    batch = {"language_input_ids": rng.randint(2, 200, (4, 24)).astype(
                 np.int32),
             "pixel_values": rng.randn(4, 4, 64, 64).astype(np.float32),
             "attention_mask": np.ones((4, 24), np.float32),
             "pixel_mask": np.ones((4, 64, 64), np.float32),
             "labels": labels}
    model = no_dropout(meant_vqa(
        64, 64, 4, 64, 64, 16, 1, 10, num_heads=4, num_encoders=2,
        ff_dropout=0.0, device="cpu",
        embedding=EmbeddingConfig(vocab_size=200, hidden_size=64,
                                  max_position_embeddings=40, dropout=0.0)))
    trainer = vqa_trainer({"model": model, "num_classes": 10, "mesh": mesh,
                           "train_loader": ArrayLoader(batch, 4)})
    rows = batch if mesh is None else shard_batch(batch, mesh)
    return trainer.train_step(_tensors(rows))[0].item()


def text_step(mesh=None) -> float:
    from meant_tpu_torch.data.loader import ArrayLoader
    from meant_tpu_torch.models import bertweet_wrapper
    from meant_tpu_torch.parallel import shard_batch
    from meant_tpu_torch.train.text_classify import text_classifier_trainer
    rng = np.random.RandomState(3)
    batch = {"input_ids": rng.randint(3, 200, (4, 12)).astype(np.int32),
             "y": rng.randint(0, 3, 4).astype(np.int32)}
    model = no_dropout(bertweet_wrapper(input_dim=64, output_dim=3,
                                        vocab_size=200, num_layers=2,
                                        num_heads=4, device="cpu"))
    trainer = text_classifier_trainer(dict(
        model=model, loss="Cross Entropy", num_classes=3, mesh=mesh,
        train_loader=ArrayLoader(batch, 4)))
    rows = batch if mesh is None else shard_batch(batch, mesh)
    return trainer.train_step(_tensors(rows))[0].item()


OTHER_TRAINERS = {"mlm": mlm_step, "vqa": vqa_step, "text": text_step}


# ---- the rank bodies -------------------------------------------------------

class RingEncoders(nn.Module):
    """Two LanguageEncoders of width 64 in 4 heads over one ring."""

    def __init__(self, mesh=None, ring_flash=False):
        super().__init__()
        from meant_tpu_torch.nn.encoders import LanguageEncoder
        self.languageEncoders = nn.ModuleList(
            LanguageEncoder(64, 4, ring_mesh=mesh, ring_flash=ring_flash,
                            device="cpu") for _ in range(2))

    def forward(self, x, mask):
        for enc in self.languageEncoders:
            x = enc(x, mask)
        return x


RING_CASES = {          # name: (use_flash, causal, masked)
    "dense": (False, False, False), "dense_causal": (False, True, False),
    "dense_masked": (False, True, True), "flash": (True, False, False),
    "flash_masked": (True, True, True)}


def ring_ranks(rank, world, inputs, encoder):
    """ring_attend in every RING_CASES case (its output chunk and the
    gradients of sum(out^2) at the global inputs) and the ring encoders,
    dense and flash, on this rank's chunk of x (output and parameter
    gradients)."""
    from meant_tpu_torch.ops.ring import ring_attend
    mesh = _mesh()
    d = np.load(inputs)
    qkv = [torch.tensor(d[n]) for n in ("q", "k", "v")]
    out = {}
    for name, (use_flash, causal, masked) in RING_CASES.items():
        leaves = [t.clone().requires_grad_() for t in qkv]
        o = ring_attend(*leaves, mesh=mesh, scale=float(d["scale"]),
                        causal=causal, use_flash=use_flash,
                        attention_mask=(torch.tensor(d["mask"]) if masked
                                        else None))
        o.square().sum().backward()
        out[name] = (o.detach(), [t.grad for t in leaves])
    x, mask = torch.tensor(d["x"]), torch.tensor(d["x_mask"])
    s_loc = x.shape[1] // world
    rows = slice(rank * s_loc, (rank + 1) * s_loc)
    for ring_flash in (False, True):
        model = RingEncoders(mesh, ring_flash)
        model.load_state_dict(torch.load(encoder))
        model.eval()
        y = model(x[:, rows], mask[:, rows])
        y.square().sum().backward()
        out[f"encoder_{ring_flash}"] = (
            y.detach(), {n: p.grad for n, p in model.named_parameters()})
    return out


def dp_ranks(rank, world, state_dict, batches, out_dir):
    """World 2: meant_src trained data parallel; the other trainers one
    step each; tensor-parallel serving on a (1, 2) (data, model) mesh;
    cli.in_loop_train --fsdp."""
    from meant_tpu_torch.cli import in_loop_train
    from meant_tpu_torch.serve import Predictor
    mesh = _mesh()
    sd = torch.load(state_dict)
    data = np.load(batches)
    batches = [{k[2:]: data[k] for k in data.files if k[0] == str(i)}
               for i in range(3)]
    run = train_meant_src(sd, batches[:2], mesh=mesh)
    out = {"losses": run["losses"], "params": run["params"],
           **{name: step(mesh) for name, step in OTHER_TRAINERS.items()}}
    tp_mesh = _mesh(("data", "model"), (1, 2))
    model = meant_src_model(sd, flash=True)
    heads = model.languageEncoders[0].attn.num_heads
    predictor = Predictor(model, "meant_src", batch_size=ROWS, device="cpu",
                          mesh=tp_mesh, tensor_parallel=True)
    out["tp_heads"] = (heads, model.languageEncoders[0].attn.num_heads)
    out["tp_q_rows"] = model.languageEncoders[0].attn.q.weight.shape[0]
    rows = {k: v for k, v in batches[2].items() if k != "y"}
    out["tp_probs"] = predictor(rows)
    results = in_loop_train.main(CLI + ["-rid", "fsdp", "--fsdp", "-fp",
                                        out_dir])
    opt = results["trainer"].optimizer
    out["cli"] = {"history": results["history"], "m": opt.m.numel(),
                  "n": opt.n, "checkpoint": results["checkpoint"]}
    return out


def fsdp_ranks(rank, world, state_dict, batches):
    """World 4: meant_src replicated and FSDP-sharded, 3 steps each; the
    meshes' axes and shapes; fsdp_shardings and fsdp_shard."""
    from torch.distributed.tensor import (Replicate, Shard,
                                          distribute_tensor)
    from meant_tpu_torch.parallel import (fsdp_shard, fsdp_shardings,
                                          make_hybrid_mesh)
    mesh = _mesh()
    sd = torch.load(state_dict)
    data = np.load(batches)
    batches = [{k[2:]: data[k] for k in data.files if k[0] == str(i)}
               for i in range(3)]
    out = {}
    for fsdp in (False, True):
        run = train_meant_src(sd, batches, mesh=mesh, fsdp=fsdp)
        opt = run["trainer"].optimizer
        out[fsdp] = {"losses": run["losses"], "params": run["params"],
                     "m_local": opt.m.numel(), "n": opt.n,
                     "m": opt.state_dict()["m"]}
    grid = _mesh(("data", "model"), (2, 2))
    hybrid = make_hybrid_mesh(device="cpu", timeout=RENDEZVOUS)
    # tests/test_fsdp.py's cases: a tensor-parallel leaf keeps its
    # placement; a (1024, 512) leaf lives 1/4 a rank, a bias whole
    tp = distribute_tensor(torch.zeros(256, 256), grid,
                           (Replicate(), Shard(1)))
    specs = fsdp_shardings({"q": tp, "ff": torch.zeros(256, 1024),
                            "bias": torch.zeros(256)}, grid, axis="data")
    placed, _ = fsdp_shard({"w": torch.ones(1024, 512),
                            "b": torch.ones(512)}, mesh)
    out["fsdp_specs"] = {k: tuple(repr(p) for p in v)
                         for k, v in specs.items()}
    out["fsdp_local"] = {k: tuple(v.to_local().shape)
                         for k, v in placed.items()}
    out["meshes"] = [(m.mesh_dim_names, tuple(m.shape),
                      tuple(m.get_coordinate()))
                     for m in (mesh, grid, hybrid)]
    return out


# ---- tensor-parallel training, int8 and the pipeline (world 4) ----------

# __graft_entry__.py's dp x tp `meant` (8 heads of 8) at lag 2, and its
# meant_timesformer dp x tp case (scanned, remat "dots")
TP_GEOM = dict(text_dim=64, image_dim=64, price_dim=4, height=32, width=32,
               patch_res=16, lag=2, num_classes=2, num_heads=8,
               num_encoders=2, channels=4)
TP_EMB = dict(vocab_size=100, hidden_size=64, max_position_embeddings=40,
              dropout=0.0)
TS_GEOM = dict(text_dim=64, image_dim=64, price_dim=4, height=32, width=32,
               patch_res=16, lag=2, num_classes=2, num_heads=4,
               num_encoders=2, channels=3, seq_len=16, scan_layers=True,
               remat="dots")
TS_EMB = dict(vocab_size=128, hidden_size=64, max_position_embeddings=40,
              dropout=0.0)
TP_ROWS = 8
# one FlatAdam step with the clip engaged (the models' first gradients have
# norms 0.58 and 1.7)
TP_OPT = dict(lr=1e-3, weight_decay=0.01, clip_norm=0.1)


def tp_meant_batch(seed: int = 11) -> dict:
    rng = np.random.RandomState(seed)
    masks = np.ones((TP_ROWS, 2, 16), np.float32)
    masks[::3, :, 12:] = 0.0
    return {"tweets": rng.randint(2, 100, (TP_ROWS, 2, 16)).astype(np.int32),
            "graphs": rng.randn(TP_ROWS, 2, 4, 32, 32).astype(np.float32),
            "attention_masks": masks,
            "y": (np.arange(TP_ROWS) % 2).astype(np.int32)}


def ts_batch(seed: int = 7) -> dict:
    rng = np.random.RandomState(seed)
    return {"input_ids": rng.randint(2, 128, (TP_ROWS, 2, 16)).astype(
                np.int32),
            "pixels": rng.randn(TP_ROWS, 2, 3, 32, 32).astype(np.float32),
            "prices": rng.randn(TP_ROWS, 2, 4).astype(np.float32),
            "attention_mask": np.ones((TP_ROWS, 2, 16), np.float32),
            "y": rng.randint(0, 2, TP_ROWS).astype(np.int32)}


def tp_model(name: str, state_dict, dropout: bool = False):
    """`meant` or `meant_timesformer` at the TP geometry, with the given
    weights, in training mode (dropout off unless `dropout`)."""
    from meant_tpu_torch.models import (EmbeddingConfig, meant,
                                        meant_timesformer)
    if name == "meant":
        model = meant(embedding=EmbeddingConfig(**TP_EMB), device="cpu",
                      **TP_GEOM)
    else:
        model = meant_timesformer(embedding=EmbeddingConfig(**TS_EMB),
                                  device="cpu", **TS_GEOM)
    model.load_state_dict(state_dict)
    model.train()
    return model if dropout else no_dropout(model)


def _loss(name, model, batch):
    from meant_tpu_torch.train.classify import model_inputs, sigmoid_ce_loss
    args, kwargs = model_inputs(name, batch)
    return sigmoid_ce_loss(model(*args, **kwargs), batch["y"])


def tp_step(name, state_dict, batch, mesh=None, fsdp=False, dropout=False):
    """One forward and backward of `name`'s loss on this rank's rows and
    one FlatAdam step (TP_OPT), the model cut by `parallelize_model` over
    the mesh's 'model' axis, its data axis the mesh's leading one (None:
    one process). Returns the loss, the gradients averaged over the data
    axis and the step's update, each parameter gathered whole."""
    from meant_tpu_torch.parallel import (param_shardings, parallelize_model,
                                          shard_batch)
    from meant_tpu_torch.parallel.mesh import axis_size
    from meant_tpu_torch.parallel.sharding_rules import (AXIS, MODEL_GROUP,
                                                         _model_shard)
    from meant_tpu_torch.train.classify import seed_dropout
    from meant_tpu_torch.train.optim import FlatAdam
    model = tp_model(name, state_dict, dropout)
    group, n = None, 1
    dims = {}
    if mesh is not None:
        dims = {k: _model_shard(v, mesh)
                for k, v in param_shardings(model, mesh).items()}
        parallelize_model(model, mesh)
        data = mesh.mesh_dim_names[0]
        group, n = mesh.get_group(data), axis_size(mesh, data)
        batch = shard_batch(batch, mesh)
    opt = FlatAdam(model.parameters(), lambda step: TP_OPT["lr"],
                   coupled=False, weight_decay=TP_OPT["weight_decay"],
                   clip_norm=TP_OPT["clip_norm"], group=group, shard=fsdp)
    opt.gather()
    opt.zero_grad()
    seed_dropout(torch.device("cpu"), 0)
    loss = _loss(name, model, _tensors(batch))
    loss.backward()
    flat_g, loss = opt.flat_g.clone(), loss.detach().clone()
    if group is not None:
        dist.all_reduce(flat_g, group=group)
        dist.all_reduce(loss, group=group)
        flat_g, loss = flat_g / n, loss / n
    before = opt.flat_p[:opt.n].clone()
    opt.step()
    opt.gather()
    update = opt.flat_p[:opt.n] - before

    def whole(flat):
        out, offset = {}, 0
        for pname, p in model.named_parameters():
            t = flat[offset:offset + p.numel()].view_as(p)
            offset += p.numel()
            g = getattr(p, MODEL_GROUP, None)
            if g is not None:
                parts = [torch.empty_like(t) for _ in range(mesh[AXIS].size())]
                dist.all_gather(parts, t.contiguous(), group=g)
                t = torch.cat(parts, dim=dims[pname].dim)
            out[pname] = t.clone()
        return out
    return {"loss": loss.item(), "grads": whole(flat_g),
            "update": whole(update), "norm": opt.last_norm.item()}


def _mlp_layer(params, x):
    return x + torch.tanh(x @ params["w1"] + params["b1"]) @ params["w2"]


def language_layer(encoder):
    """layer_fn of a LanguageEncoder stack: (h, mask) -> (h', mask)."""
    def layer(params, state):
        h, mask = state
        return torch.func.functional_call(encoder, params, (h, mask)), mask
    return layer


def language_encoder():
    from meant_tpu_torch.nn.encoders import LanguageEncoder
    return LanguageEncoder(64, 4, ff_dropout=0.0, rot_dim=8,
                           device="cpu").eval()


def pipe_run(layer_fn, stacked: dict, x, loss, mesh=None, **kw):
    """pipeline_apply's output and the gradients of `loss(output)` at the
    stacked parameters (None: forward only)."""
    from meant_tpu_torch.parallel import pipeline_apply
    leaves = {k: v.clone().requires_grad_(loss is not None)
              for k, v in stacked.items()}
    out = pipeline_apply(layer_fn, leaves, x, mesh=mesh, **kw)
    if loss is None:
        return out, None
    loss(out).backward()
    return out, {k: v.grad for k, v in leaves.items()}


def mlp_trees(n_layers: int = 8, d: int = 16, seed: int = 0) -> list:
    """tests/test_pipeline.py's MLP layers, numpy from one seed."""
    rng = np.random.RandomState(seed)
    return [{"w1": rng.randn(d, 2 * d).astype(np.float32) * 0.1,
             "b1": rng.randn(2 * d).astype(np.float32) * 0.1,
             "w2": rng.randn(2 * d, d).astype(np.float32) * 0.1}
            for _ in range(n_layers)]


def stacked_tensors(trees: list) -> dict:
    return {k: torch.tensor(np.stack([t[k] for t in trees])) for k in trees[0]}


def pipe_inputs() -> dict:
    """The P2P pipeline's inputs: 8 MLP layers and a (16, 16) x; 8
    LanguageEncoders (width 64, 4 heads, the port's init from seeds 0-7)
    and (8, 8, 64) hidden states with a key mask."""
    from meant_tpu_torch.nn.layers import init_weights
    rng = np.random.RandomState(20)
    mask = (rng.rand(8, 8) > 0.3).astype(np.float32)
    mask[:, 0] = 1.0
    trees = []
    for i in range(8):
        enc = language_encoder()
        init_weights(enc, torch.Generator().manual_seed(i))
        trees.append({k: p.detach().numpy()
                      for k, p in enc.named_parameters()})
    return {"mlp_stack": stacked_tensors(mlp_trees(seed=4)),
            "mlp_x": rng.randn(16, 16).astype(np.float32),
            "lang_stack": stacked_tensors(trees),
            "lang_h": rng.randn(8, 8, 64).astype(np.float32),
            "lang_mask": mask}


def pipe_case(case: str, d: dict, mesh=None, stages=None):
    """The P2P run's case `case` ("mlp": microbatches 8, loss sum(out^2);
    "lang": microbatches 4, loss mean(h^2)) over `mesh` or played in
    `stages` stages: (output, gradients at the stacked parameters)."""
    if case == "mlp":
        return pipe_run(_mlp_layer, d["mlp_stack"], torch.tensor(d["mlp_x"]),
                        lambda o: o.square().sum(), mesh=mesh, stages=stages,
                        microbatches=8)
    x = (torch.tensor(d["lang_h"]), torch.tensor(d["lang_mask"]))
    return pipe_run(language_layer(language_encoder()), d["lang_stack"], x,
                    lambda o: o[0].square().mean(), mesh=mesh,
                    stages=stages, microbatches=4)


def tp_ranks(rank, world, inputs):
    """World 4: `meant` dp x tp (2, 2), fsdp x tp (2, 2) and on the hybrid
    (dcn, model) mesh of 2 nodes of 2; meant_timesformer dp x tp with scan
    and remat; `meant` at (1, 4) with dropout on; the int8 Predictor at
    (1, 4) and (2, 2); the pipeline over a ("pipe",) mesh of 4 stages (the
    MLP stack and the LanguageEncoder stack, forward and gradients)."""
    from meant_tpu_torch.parallel import make_hybrid_mesh
    from meant_tpu_torch.serve import Predictor
    d = torch.load(inputs, weights_only=False)
    grid = _mesh(("data", "model"), (2, 2))
    out = {"dp_tp": tp_step("meant", d["meant"], d["meant_batch"], grid),
           "fsdp_tp": tp_step("meant", d["meant"], d["meant_batch"], grid,
                              fsdp=True)}
    hybrid = make_hybrid_mesh(device="cpu", timeout=RENDEZVOUS)
    out["hybrid"] = tp_step("meant", d["meant"], d["meant_batch"], hybrid)
    out["hybrid_axes"] = hybrid.mesh_dim_names
    out["ts_dp_tp"] = tp_step("meant_timesformer", d["ts"], d["ts_batch"],
                              grid)
    line = _mesh(("data", "model"), (1, 4))
    out["dropout_tp"] = tp_step("meant", d["meant"], d["meant_batch"], line,
                                dropout=True)
    rows = {k: v for k, v in d["meant_batch"].items() if k != "y"}
    for tag, mesh in (("1x4", line), ("2x2", grid)):
        model = tp_model("meant", d["meant"]).eval()
        out[f"int8_{tag}"] = Predictor(model, "meant", batch_size=TP_ROWS,
                                       device="cpu", mesh=mesh,
                                       tensor_parallel=True,
                                       quantize="int8")(rows)
    pipe = _mesh(("pipe",))
    for case in ("mlp", "lang"):
        out[f"pipe_{case}"] = pipe_case(case, d, mesh=pipe)
    return out
