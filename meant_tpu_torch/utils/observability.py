"""Tracing, profiling, debugging and plots (counterpart of
meant_tpu/utils/observability.py).

* `profile_trace(log_dir)`: a `torch.profiler` trace of the host and the
  card around a block, written as a Chrome trace (`trace_*.json`) under
  `log_dir` (JAX's is `jax.profiler.trace`, viewed in TensorBoard).
* `set_debug_nans(enable)`: `torch.autograd.set_detect_anomaly`. JAX's
  `jax_debug_nans` raises at the first operation whose output holds a NaN,
  forward or backward; anomaly mode raises only when a backward function
  returns a NaN, and names the forward operation that made it (a NaN of a
  forward pass under no_grad goes unseen). It also slows every backward.
* `ema_smooth`, `plot_loss_curve`, `plot_f1_scatter`,
  `save_confusion_matrix`: the reference's loss curve, F1 scatter and
  confusion-matrix PNG, with matplotlib imported when a plot is drawn
  (a machine without it raises ImportError there, as JAX's module does).
* `summary_writer(model_name)`: TensorBoard's `SummaryWriter` under
  `runs/{model_name}`, or a writer that drops everything where tensorboard
  is missing; `wandb_init`: opt-in tracking, None where wandb is missing.
"""

from __future__ import annotations

import contextlib
import os
from typing import Optional, Sequence

import numpy as np
import torch


@contextlib.contextmanager
def profile_trace(log_dir: str = "meant_torch_trace"):
    """Profile the block (host ops, and the card's kernels and copies when
    CUDA is available) and write `log_dir/trace_<pid>.json`; yields
    `log_dir`."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield log_dir
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir,
                                          f"trace_{os.getpid()}.json"))


def set_debug_nans(enable: bool = True) -> None:
    torch.autograd.set_detect_anomaly(enable)


def ema_smooth(values: Sequence[float], alpha: float = 0.9) -> np.ndarray:
    """EMA smoothing of the reference's loss plots
    (`in_loop_train.py:152-164`)."""
    out = np.empty(len(values))
    acc = None
    for i, v in enumerate(values):
        acc = v if acc is None else alpha * acc + (1 - alpha) * v
        out[i] = acc
    return out


def _plt():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def _save(fig, plt, path: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path)
    plt.close(fig)


def plot_loss_curve(losses: Sequence[float], path: str, alpha: float = 0.9):
    plt = _plt()
    fig, ax = plt.subplots()
    ax.plot(losses, alpha=0.3, label="loss")
    ax.plot(ema_smooth(losses, alpha), label="ema")
    ax.set_xlabel("step")
    ax.set_ylabel("loss")
    ax.legend()
    _save(fig, plt, path)


def plot_f1_scatter(f1s: Sequence[float], path: str):
    plt = _plt()
    fig, ax = plt.subplots()
    ax.scatter(np.arange(len(f1s)), f1s)
    ax.set_xlabel("epoch")
    ax.set_ylabel("macro F1")
    _save(fig, plt, path)


def save_confusion_matrix(cm: np.ndarray, path: str, title: str = ""):
    """A heatmap of the confusion counts with each count written in its
    cell (`src/utils/torchUtils.py:17-24`, no seaborn)."""
    plt = _plt()
    cm = np.asarray(cm)
    fig, ax = plt.subplots()
    im = ax.imshow(cm, cmap="Blues")
    for i in range(cm.shape[0]):
        for j in range(cm.shape[1]):
            ax.text(j, i, f"{int(cm[i, j])}", ha="center", va="center")
    ax.set_xlabel("predicted")
    ax.set_ylabel("target")
    if title:
        ax.set_title(title)
    fig.colorbar(im)
    _save(fig, plt, path)


class _NullWriter:
    def add_scalar(self, *args, **kwargs):
        pass

    def close(self):
        pass


def summary_writer(model_name: str, root: str = "runs"):
    try:
        from torch.utils.tensorboard import SummaryWriter
        return SummaryWriter(os.path.join(root, model_name))
    except Exception as e:
        print(f"[observability] tensorboard unavailable: {e}")
        return _NullWriter()


def wandb_init(project: str, name: str, entity: Optional[str] = None):
    try:
        import wandb
        return wandb.init(project=project, entity=entity,
                          sync_tensorboard=True, name=name, save_code=True)
    except Exception as e:
        print(f"[observability] wandb unavailable: {e}")
        return None
