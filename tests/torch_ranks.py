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
