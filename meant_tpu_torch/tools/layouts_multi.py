"""The parallel layouts across several cards of one host.

    torchrun --nproc_per_node N -m meant_tpu_torch.tools.layouts_multi \\
        [--out FILE]

Every rank builds the same flagship (`chip_smoke.build_flagship`,
flash=True, fixed_proj=True, seed 0) and the same global inputs, over an
NCCL group of N ranks (one card each). It reads, beside the card's name
and power limit, and rank 0 prints one JSON line (and writes it to
FILE):

- `dp` / `fsdp`: STEPS `meant_trainer` steps on one replayed global batch
  of 16 rows (16 / N a rank), dropout off, with `make_mesh()` and with
  fsdp=True; their
  losses against the plain trainer on the 16 rows at rank 0 (largest
  relative difference), the median step ms (host clock, synchronized),
  samples/s, peak memory and each rank's moment count;
- `tp`: `Predictor(tensor_parallel=True)` on a (1, N) (data, model) mesh,
  one 16-row request against the plain Predictor at rank 0 (max abs
  probability difference, held to chip_smoke's PROBS_ATOL: the
  row-parallel partial sums round to bf16 before their all_reduce), and
  the request's ms against the plain one's;
- `ring`: src4096's text attention ((10, 8, 4096, 96) bf16, causal, xPos
  at global positions) split over the N ranks and run through the real
  P2P ring with the flash engine, forward and backward from one dO:
  the output gathered and the gradients summed over the ranks against
  the unsplit R1 + K3 and R1 + K4 + K5 (relative L2; the output at
  `BF16_REL_L2`), and both paths' forward and backward ms (CUDA events;
  backward as forward + backward less forward);
- `tp_train`: the flagship cut by `parallelize_model` and trained STEPS
  steps as `dp` is, on a (1, N) (data, model) mesh, and at N = 4 also dp
  x tp and fsdp x tp on (2, 2): the losses against the plain trainer at
  rank 0 (largest relative difference), the median step ms, samples/s
  and every rank's peak memory;
- `tp_int8`: `Predictor(tensor_parallel=True, quantize="int8")` at (1, N)
  against the plain int8 Predictor at rank 0 (max abs probability
  difference, held to PROBS_ATOL as `tp` is);
- `pipe`: chip_smoke's pipeline case (the flagship's language tower, 80
  sequences of 512 with a key mask, one dO) over a real ("pipe",) mesh
  of N stages at 4 and 8 microbatches, P2P between the cards: the
  output and the input's gradient against the sequential stack at rank
  0 (relative L2, held to BF16_REL_L2 and BWD_BF16_REL_L2 as chip_smoke
  holds the played pipeline), and both paths' forward and forward +
  backward ms.

The kernels must be built first (`cuda_build.build_all`); run it with
the repository's root as the working directory.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import torch
import torch.distributed as dist

STEPS = 5


def _cs():
    sys.path.insert(0, os.getcwd())
    import chip_smoke
    return chip_smoke


def _steps(cs, mesh, fsdp, host, steps, tp=False):
    from meant_tpu_torch.parallel import parallelize_model, shard_batch
    model = cs.build_flagship(flash=True, fixed_proj=True)
    if tp:
        parallelize_model(model, mesh)
    for m in model.modules():      # the ranks' draws are not one run's
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    extra = {"mesh": mesh, "fsdp": fsdp} if mesh is not None else {}
    trainer = cs.make_trainer(model, host, **extra)
    rows = cs.to_card(host if mesh is None else shard_batch(host, mesh))
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, _ = trainer.train_step(rows)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss.item())
    peak = torch.tensor([torch.cuda.max_memory_allocated()], device="cuda")
    peaks = peak.new_empty(dist.get_world_size() if mesh is not None else 1)
    if mesh is not None:
        dist.all_gather_into_tensor(peaks, peak)
    else:
        peaks = peak
    out = {"losses": losses, "step_ms_median": statistics.median(times[1:]),
           "samples_per_s": 16 / statistics.median(times[1:]) * 1e3,
           "peak_memory_bytes": int(peak.item()),
           "peak_memory_bytes_by_rank": peaks.tolist(),
           "m_local": trainer.optimizer.m.numel()}
    del trainer, model
    torch.cuda.empty_cache()
    return out


def _rel(a, b) -> float:
    return max(abs(x - y) / abs(y) for x, y in zip(a, b))


def layouts(cs, mesh, steps) -> dict:
    host = cs.train_batch(cs.BATCH, seed=1)
    res = {"dp": _steps(cs, mesh, False, host, steps),
           "fsdp": _steps(cs, mesh, True, host, steps)}
    if dist.get_rank() == 0:
        res["plain"] = _steps(cs, None, False, host, steps)
        for way in ("dp", "fsdp"):
            res[way]["loss_rel_vs_plain"] = _rel(res[way]["losses"],
                                                 res["plain"]["losses"])
    return res


def tp_training(cs, n, steps, plain) -> dict:
    """`tp_train`: (1, n), and dp x tp and fsdp x tp at (2, 2) on 4."""
    from meant_tpu_torch.parallel import make_mesh
    host = cs.train_batch(cs.BATCH, seed=1)
    shapes = {"tp": ((1, n), False)}
    if n == 4:
        shapes.update(dp_tp=((2, 2), False), fsdp_tp=((2, 2), True))
    res = {}
    for name, (shape, fsdp) in shapes.items():
        mesh = make_mesh(("data", "model"), shape)
        res[name] = _steps(cs, mesh, fsdp, host, steps, tp=True)
        res[name]["mesh"] = list(shape)
        if plain is not None:
            res[name]["loss_rel_vs_plain"] = _rel(res[name]["losses"],
                                                  plain["losses"])
    return res


def serving(cs, n, quantize=None) -> dict:
    from meant_tpu_torch.parallel import make_mesh
    from meant_tpu_torch.serve import Predictor
    chunk = cs.request_batch(cs.BATCH, seed=3)
    tp = Predictor(cs.build_flagship(flash=True, fixed_proj=True),
                   "meant_src", batch_size=cs.BATCH,
                   mesh=make_mesh(("data", "model"), (1, n)),
                   tensor_parallel=True, quantize=quantize)
    res = {"request_ms": cs.event_ms(lambda: tp.forward(chunk), iters=5)}
    got = tp.forward(chunk).float()
    del tp
    torch.cuda.empty_cache()
    if dist.get_rank() == 0:
        plain = Predictor(cs.build_flagship(flash=True, fixed_proj=True),
                          "meant_src", batch_size=cs.BATCH,
                          quantize=quantize)
        want = plain.forward(chunk).float()
        res["plain_request_ms"] = cs.event_ms(lambda: plain.forward(chunk),
                                              iters=5)
        res["max_abs_err"] = (got - want).abs().max().item()
        res["ok"] = res["max_abs_err"] <= cs.PROBS_ATOL
        del plain
        torch.cuda.empty_cache()
    return res


def ring(cs, mesh, n) -> dict:
    from meant_tpu_torch.ops.flash import flash_mha
    from meant_tpu_torch.ops.flash.kernel import BF16_REL_L2
    from meant_tpu_torch.ops.ring import make_ring_attention
    gen = torch.Generator(device="cuda").manual_seed(16)
    c = cs.ring_case(torch.bfloat16, gen)
    s_loc = cs.LONG_SEQ // n
    r = dist.get_rank()
    rows = slice(r * s_loc, (r + 1) * s_loc)

    def tables(chunk):
        part = slice(chunk * s_loc, (chunk + 1) * s_loc)
        return tuple(t[part] for t in c["tables"])

    fn = make_ring_attention(mesh, scale=c["scale"], causal=True,
                             use_flash=True, tables=tables)
    mask = torch.ones((c["q"].shape[0], s_loc), device="cuda")

    def ring_run(grad):
        leaves = [c[t][:, :, rows].detach().requires_grad_(grad)
                  for t in ("q", "k", "v")]
        return fn(*leaves, mask), leaves

    whole_tables = dict(zip(("qcos", "qsin", "kcos", "ksin"), c["tables"]))

    def whole_run(grad):
        leaves = [c[t].detach().requires_grad_(grad)
                  for t in ("q", "k", "v")]
        return flash_mha(*leaves, scale=c["scale"], causal=True,
                         force_online=True, **whole_tables), leaves

    out, leaves = ring_run(True)
    out.backward(c["do"][:, :, rows])
    parts = out.new_empty((n * out.shape[0], *out.shape[1:]))
    dist.all_gather_into_tensor(parts, out.detach().contiguous())
    got = torch.cat(parts.chunk(n), dim=2)
    whole, whole_leaves = whole_run(True)
    whole.backward(c["do"])
    res = {"out_rel_l2": cs.rel_l2(got, whole)}
    for name, a, b in zip(("dq", "dk", "dv"), leaves, whole_leaves):
        g = torch.zeros_like(b.grad)
        g[:, :, rows] = a.grad
        dist.all_reduce(g)
        res[f"{name}_rel_l2"] = cs.rel_l2(g, b.grad)
    res["ok"] = res["out_rel_l2"] <= BF16_REL_L2

    def ring_fwd():
        with torch.no_grad():
            ring_run(False)

    def ring_fwd_bwd():
        o, _ = ring_run(True)
        o.backward(c["do"][:, :, rows])

    def whole_fwd():
        with torch.no_grad():
            whole_run(False)

    def whole_fwd_bwd():
        o, _ = whole_run(True)
        o.backward(c["do"])

    for name, f in (("ring_fwd", ring_fwd), ("ring_fwd_bwd", ring_fwd_bwd),
                    ("whole_fwd", whole_fwd),
                    ("whole_fwd_bwd", whole_fwd_bwd)):
        dist.barrier()
        res[f"{name}_ms"] = cs.event_ms(f, iters=3, warmup=1)
    res["ring_bwd_ms"] = res["ring_fwd_bwd_ms"] - res["ring_fwd_ms"]
    res["whole_bwd_ms"] = res["whole_fwd_bwd_ms"] - res["whole_fwd_ms"]
    return res


def pipe(cs, n) -> dict:
    """`pipe`: the tower over a ("pipe",) mesh of n stages (P2P), at each
    of chip_smoke's PIPE_MICROBATCHES, against the sequential stack."""
    from meant_tpu_torch.ops.flash.kernel import (BF16_REL_L2,
                                                  BWD_BF16_REL_L2)
    from meant_tpu_torch.parallel import make_mesh
    mesh = make_mesh(("pipe",))
    gen = torch.Generator(device="cuda").manual_seed(17)
    tower = cs.pipe_tower()
    x, mask, do = cs.pipe_inputs(gen)
    res = {}
    want = (cs.pipe_pass(tower, x, mask, do) if dist.get_rank() == 0
            else None)
    for m in cs.PIPE_MICROBATCHES:
        kw = dict(mesh=mesh, microbatches=m)
        got = cs.pipe_pass(tower, x, mask, do, **kw)
        r = {}
        if want is not None:
            r.update(out_rel_l2=cs.rel_l2(got[0], want[0]),
                     dx_rel_l2=cs.rel_l2(got[1], want[1]))
            r["ok"] = (r["out_rel_l2"] <= BF16_REL_L2
                       and r["dx_rel_l2"] <= BWD_BF16_REL_L2)
        del got
        for name, fn in (("fwd", lambda: cs.pipe_pass(tower, x, mask, **kw)),
                         ("fwd_bwd", lambda: cs.pipe_pass(tower, x, mask, do,
                                                          **kw))):
            dist.barrier()
            r[f"{name}_ms"] = cs.event_ms(fn, iters=3, warmup=1)
        res[f"m{m}"] = r
    del want
    if dist.get_rank() == 0:
        for name, fn in (("fwd", lambda: cs.pipe_pass(tower, x, mask)),
                         ("fwd_bwd", lambda: cs.pipe_pass(tower, x, mask,
                                                          do))):
            res[f"sequential_{name}_ms"] = cs.event_ms(fn, iters=3,
                                                       warmup=1)
    dist.barrier()
    del tower
    torch.cuda.empty_cache()
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--steps", type=int, default=STEPS)
    args = ap.parse_args(argv)
    from meant_tpu_torch.parallel import make_mesh
    cs = _cs()
    mesh = make_mesh()
    n = dist.get_world_size()
    res = {"ranks": n, "card": cs.card_line()}
    t0 = time.perf_counter()
    res["layouts"] = layouts(cs, mesh, args.steps)
    res["tp"] = serving(cs, n)
    res["ring"] = ring(cs, mesh, n)
    res["tp_train"] = tp_training(cs, n, args.steps,
                                  res["layouts"].get("plain"))
    res["tp_int8"] = serving(cs, n, quantize="int8")
    res["pipe"] = pipe(cs, n)
    res["wall_s"] = time.perf_counter() - t0
    ok = bool(res["ring"]["ok"])
    if dist.get_rank() == 0:
        ok = (ok and bool(res["tp"]["ok"]) and bool(res["tp_int8"]["ok"])
              and all(r["ok"] for k, r in res["pipe"].items()
                      if isinstance(r, dict)))
        print(json.dumps(res, default=str), flush=True)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(res, f, default=str, indent=1)
    dist.destroy_process_group()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
