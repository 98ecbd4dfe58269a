"""The fused AdamW (A1) and the trainer's optimizer on the CPU against the
JAX package.

* `adamw_reference` (A1's plain version) against the Pallas kernel `_kernel`
  of scripts/probe_fused_adamw.py, loaded by path and run through
  `pl.pallas_call(..., interpret=True)` with that script's constants.
* The port's `build_optimizer` against the JAX `build_optimizer` (optax:
  clip_by_global_norm(1.0), then adamw or add_decayed_weights + adam, on a
  per-epoch schedule that changes every step here) over 4 steps, with the
  gradient's global norm above and below 1.0.
* `epoch_schedule` against the JAX schedule, every kind.
* `build_optimizer(mu_dtype=torch.bfloat16)` against the JAX one with
  `mu_dtype=jnp.bfloat16` (jitted, as the trainer runs it) over 7 steps:
  p at the bar below, the bf16 first moment within one bf16 ulp.
* `build_optimizer(accumulation_steps=k)` against `optax.MultiSteps` of
  the JAX one at k = 2 and 3 over 7 micro-steps (the leftover included):
  p at the bar below after every micro-step, and the applied-update count
  the schedule reads equal.

Bar: 1e-6 relative, plus an absolute 1e-9 for entries that land near 0,
where the two sides' different order of the last multiply-subtract (A1
computes lr * m / (...), the port lr * (m / (...)); optax divides by the
bias correction, the port multiplies) leaves one rounding of an update of
size lr, about 1e-11.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from jax.experimental import pallas as pl

from meant_tpu.train.optim import build_optimizer as j_build_optimizer
from meant_tpu.train.optim import epoch_schedule as j_epoch_schedule
from meant_tpu_torch.ops.adamw import (adamw_reference, adamw_update,
                                       fused_adamw, update_scalars)
from meant_tpu_torch.train.optim import build_optimizer, epoch_schedule

import torch_threads

torch_threads.share_cores()

RTOL, ATOL = 1e-6, 1e-9
PROBE = Path(__file__).resolve().parents[1] / "scripts" / \
    "probe_fused_adamw.py"


def _probe_module():
    spec = importlib.util.spec_from_file_location("probe_fused_adamw", PROBE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_reference_matches_pallas_a1_in_interpret_mode():
    mod = _probe_module()
    rows, blk = 16, 8
    shape = (rows, 1024)
    rng = np.random.RandomState(0)
    p = rng.randn(*shape).astype(np.float32)
    g = (rng.randn(*shape) * 1e-3).astype(np.float32)
    m = (rng.randn(*shape) * 1e-4).astype(np.float32)
    v = (rng.rand(*shape) * 1e-6).astype(np.float32)
    step = jnp.asarray(10.0)
    c1 = (1.0 / (1 - mod.B1 ** step))[None]
    c2 = (1.0 / (1 - mod.B2 ** step))[None]
    spec = pl.BlockSpec((blk, 1024), lambda i: (i, 0))
    sspec = pl.BlockSpec((1,), lambda i: (0,))
    out = pl.pallas_call(
        mod._kernel, grid=(rows // blk,),
        in_specs=[spec, spec, spec, spec, sspec, sspec],
        out_specs=[spec, spec, spec],
        out_shape=[jax.ShapeDtypeStruct(shape, jnp.float32)] * 3,
        interpret=True)(*(jnp.asarray(a) for a in (p, m, v, g)), c1, c2)

    h = dict(lr=mod.LR, b1=mod.B1, one_minus_b1=1 - mod.B1, b2=mod.B2,
             one_minus_b2=1 - mod.B2, eps=mod.EPS, wd=mod.WD,
             c1=float(c1[0]), c2=float(c2[0]), coupled=False)
    tp, tm, tv = (torch.tensor(a.reshape(-1)) for a in (p, m, v))
    adamw_reference(tp, torch.tensor(g.reshape(-1)), tm, tv, h, None, 0.0)
    for name, got, want in zip("pmv", (tp, tm, tv), out):
        np.testing.assert_allclose(got.numpy(), np.asarray(want).reshape(-1),
                                   rtol=RTOL, atol=ATOL, err_msg=name)


def test_cpu_update_is_the_plain_version_and_launches_nothing():
    rng = np.random.RandomState(1)
    p, g, m, v = (torch.tensor(rng.rand(33).astype(np.float32))
                  for _ in range(4))
    ref = [t.clone() for t in (p, m, v)]
    norm = torch.linalg.vector_norm(g)
    kw = dict(lr=1e-3, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.1, step=2,
              coupled=True)
    before = fused_adamw.launches
    adamw_update(p, g, m, v, norm=norm, max_norm=1.0, **kw)
    adamw_reference(ref[0], g, ref[1], ref[2], update_scalars(**kw), norm,
                    1.0)
    assert fused_adamw.launches == before
    for got, want in zip((p, m, v), ref):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("optimizer,schedule,decay", [
    ("AdamW", "cosine_warm", 0.01), ("Adam", "linear", 0.01),
    ("AdamW", "cosine", 0.0)])
def test_optimizer_matches_optax_chain(optimizer, schedule, decay):
    rng = np.random.RandomState(2)
    shapes = {"w": (5, 7), "b": (13,), "s": (3, 2, 4)}
    params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    kw = dict(optimizer=optimizer, learning_rate=1e-3, decay=decay,
              beta_1=0.9, beta_2=0.99, lr_scheduler=schedule, t0=3, tmax=4,
              steps_per_epoch=1)
    tx = j_build_optimizer(params, **kw)
    j_params = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(j_params)

    t_params = {k: torch.nn.Parameter(torch.tensor(v))
                for k, v in params.items()}
    opt = build_optimizer(list(t_params.values()), **kw)
    # global norm of each step's gradient: the clip acts on steps 1 and 3
    for step, norm in enumerate((3.0, 0.5, 2.0, 0.2)):
        grads = {k: rng.randn(*s).astype(np.float32) for k, s in
                 shapes.items()}
        total = np.sqrt(sum((g.astype(np.float64) ** 2).sum()
                            for g in grads.values()))
        grads = {k: (g * norm / total).astype(np.float32)
                 for k, g in grads.items()}
        updates, state = tx.update({k: jnp.asarray(v) for k, v in
                                    grads.items()}, state, j_params)
        j_params = optax.apply_updates(j_params, updates)
        opt.zero_grad()
        for k, p in t_params.items():
            p.grad.add_(torch.tensor(grads[k]))
        opt.step()
        for k, p in t_params.items():
            np.testing.assert_allclose(
                p.detach().numpy(), np.asarray(j_params[k]), rtol=RTOL,
                atol=ATOL, err_msg=f"{k} after step {step + 1}")
    assert opt.step_count == 4


def test_optimizer_keeps_params_and_grads_as_views_of_flat_buffers():
    w = torch.nn.Parameter(torch.ones(3, 2))
    frozen = torch.nn.Parameter(torch.ones(4), requires_grad=False)
    opt = build_optimizer([w, frozen], learning_rate=0.1)
    assert opt.flat_p.numel() == 6
    (w * 2.0).sum().backward()
    assert torch.equal(opt.flat_g, torch.full((6,), 2.0))
    opt.step()
    assert torch.equal(w.detach().reshape(-1), opt.flat_p)
    opt.zero_grad()
    assert w.grad is not None and float(w.grad.abs().sum()) == 0.0
    bf16 = build_optimizer([w], mu_dtype=torch.bfloat16)
    assert bf16.m.dtype == torch.bfloat16 and bf16.v.dtype == torch.float32
    assert bf16.m.numel() == 6 and bf16.state_dict()["m"] is bf16.m
    with pytest.raises(ValueError):
        build_optimizer([w], mu_dtype=torch.float16)
    with pytest.raises(ValueError):
        build_optimizer([torch.nn.Parameter(
            torch.ones(2, dtype=torch.float64))])


@pytest.mark.parametrize("kind", ["cosine_warm", "cosine", "linear",
                                  "linear_warmup", "constant"])
def test_epoch_schedule_matches_jax(kind):
    kw = dict(t0=3, tmax=7, steps_per_epoch=2, warmup_steps=4,
              total_steps=30)
    j = j_epoch_schedule(kind, 2e-4, **kw)
    t = epoch_schedule(kind, 2e-4, **kw)
    for step in range(32):
        np.testing.assert_allclose(t(step), float(j(jnp.asarray(step))),
                                   rtol=1e-6, atol=1e-12,
                                   err_msg=f"step {step}")
    with pytest.raises(ValueError):
        epoch_schedule("exponential", 1e-3)


def _optax_state_get(state, name):
    """The one leaf `name` (mu, count) of an optax state tree."""
    return optax.tree_utils.tree_get(state, name)


def _shapes_params(seed):
    rng = np.random.RandomState(seed)
    shapes = {"w": (5, 7), "b": (13,), "s": (3, 2, 4)}
    return rng, shapes, {k: rng.randn(*s).astype(np.float32)
                         for k, s in shapes.items()}


def _scaled_grads(rng, shapes, norm):
    grads = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    total = np.sqrt(sum((g.astype(np.float64) ** 2).sum()
                        for g in grads.values()))
    return {k: (g * norm / total).astype(np.float32)
            for k, g in grads.items()}


@pytest.mark.parametrize("optimizer,decay", [("AdamW", 0.01), ("Adam", 0.0)])
def test_bf16_first_moment_matches_optax_mu_dtype(optimizer, decay):
    rng, shapes, params = _shapes_params(4)
    kw = dict(optimizer=optimizer, learning_rate=1e-3, decay=decay,
              beta_1=0.9, beta_2=0.99, lr_scheduler="cosine_warm", t0=3,
              tmax=4, steps_per_epoch=2)
    tx = j_build_optimizer(params, mu_dtype=jnp.bfloat16, **kw)
    update = jax.jit(tx.update)
    j_params = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(j_params)
    t_params = {k: torch.nn.Parameter(torch.tensor(v))
                for k, v in params.items()}
    opt = build_optimizer(list(t_params.values()), mu_dtype=torch.bfloat16,
                          **kw)
    for step, norm in enumerate((3.0, 0.5, 2.0, 0.2, 1.5, 0.7, 4.0)):
        grads = _scaled_grads(rng, shapes, norm)
        updates, state = update({k: jnp.asarray(v) for k, v in
                                 grads.items()}, state, j_params)
        j_params = optax.apply_updates(j_params, updates)
        opt.zero_grad()
        for k, p in t_params.items():
            p.grad.add_(torch.tensor(grads[k]))
        opt.step()
        mu = _optax_state_get(state, "mu")
        offset = 0
        for k, p in t_params.items():
            np.testing.assert_allclose(
                p.detach().numpy(), np.asarray(j_params[k]), rtol=RTOL,
                atol=ATOL, err_msg=f"{k} after step {step + 1}")
            n = p.numel()
            got = opt.m[offset:offset + n].float().numpy()
            want = np.asarray(mu[k].astype(jnp.float32)).reshape(-1)
            offset += n
            ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want),
                                                      1e-38))) - 7)
            assert mu[k].dtype == jnp.bfloat16
            assert (np.abs(got - want) <= ulp).all(), (k, step)
    assert opt.m.dtype == torch.bfloat16 and opt.step_count == 7


@pytest.mark.parametrize("k_steps", [2, 3])
def test_accumulation_matches_optax_multisteps(k_steps):
    rng, shapes, params = _shapes_params(5)
    kw = dict(optimizer="AdamW", learning_rate=1e-3, decay=0.01,
              beta_1=0.9, beta_2=0.99, lr_scheduler="cosine_warm", t0=3,
              tmax=4, steps_per_epoch=2)
    tx = optax.MultiSteps(j_build_optimizer(params, **kw), k_steps)
    update = jax.jit(tx.update)
    j_params = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(j_params)
    t_params = {k: torch.nn.Parameter(torch.tensor(v))
                for k, v in params.items()}
    opt = build_optimizer(list(t_params.values()),
                          accumulation_steps=k_steps, **kw)
    before = {k: p.detach().clone() for k, p in t_params.items()}
    for micro, norm in enumerate((3.0, 0.5, 2.0, 0.2, 1.5, 0.7, 4.0)):
        grads = _scaled_grads(rng, shapes, norm)
        updates, state = update({k: jnp.asarray(v) for k, v in
                                 grads.items()}, state, j_params)
        j_params = optax.apply_updates(j_params, updates)
        opt.zero_grad()
        for k, p in t_params.items():
            p.grad.add_(torch.tensor(grads[k]))
        applied = opt.step()
        assert applied == ((micro + 1) % k_steps == 0)
        assert opt.step_count == int(state.gradient_step)
        assert opt.mini_step == int(state.mini_step)
        counts = optax.tree_utils.tree_get_all_with_path(
            state.inner_opt_state, "count")
        assert counts and all(int(c) == opt.step_count for _, c in counts)
        for k, p in t_params.items():
            np.testing.assert_allclose(
                p.detach().numpy(), np.asarray(j_params[k]), rtol=RTOL,
                atol=ATOL, err_msg=f"{k} after micro-step {micro + 1}")
            if not applied:
                assert torch.equal(p.detach(), before[k])
            before[k] = p.detach().clone()
    # 7 micro-steps leave a leftover accumulation behind
    assert opt.mini_step == 7 % k_steps and opt.step_count == 7 // k_steps
    state_dict = opt.state_dict()
    assert state_dict["mini_step"] == opt.mini_step
    assert state_dict["acc"].abs().sum() > 0
