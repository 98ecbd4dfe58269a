"""The port's observability helpers (meant_tpu_torch/utils/observability.py)
against the JAX package's, on the CPU: the EMA smoothing (exact), the loss
curve, F1 scatter and confusion-matrix PNGs (written where JAX writes
them), the TensorBoard writer and its null stand-in, wandb's opt-in,
`set_debug_nans` (torch's anomaly mode) and `profile_trace` (a
torch.profiler trace written under its directory); and the trainer's
confusion-matrix PNG after its test pass."""

import json
import os

import numpy as np
import pytest
import torch

from meant_tpu.utils import observability as j_obs
from meant_tpu_torch.utils import observability as obs

import torch_threads

torch_threads.share_cores()


@pytest.mark.parametrize("alpha", [0.0, 0.5, 0.9])
def test_ema_smooth_matches_jax(alpha):
    values = np.random.RandomState(0).rand(30).tolist()
    np.testing.assert_array_equal(obs.ema_smooth(values, alpha),
                                  j_obs.ema_smooth(values, alpha))
    assert obs.ema_smooth([], alpha).shape == (0,)


def test_plots_write_pngs_as_jax(tmp_path):
    cm = np.array([[5, 1], [2, 7]])
    for module, name in ((obs, "p"), (j_obs, "j")):
        module.plot_loss_curve([1.0, 0.8, 0.9, 0.5],
                               str(tmp_path / name / "loss.png"))
        module.plot_f1_scatter([0.4, 0.6], str(tmp_path / name / "f1.png"))
        module.save_confusion_matrix(cm, str(tmp_path / name / "a" /
                                             "cm.png"), title="meant")
    for rel in ("loss.png", "f1.png", "a/cm.png"):
        got = (tmp_path / "p" / rel).read_bytes()
        assert got[:8] == b"\x89PNG\r\n\x1a\n"
        assert len(got) > 1000 and (tmp_path / "j" / rel).exists()


def test_summary_writer_and_wandb_fall_back(tmp_path, monkeypatch, capsys):
    import builtins
    real_import = builtins.__import__

    def no_tensorboard(name, *args, **kwargs):
        if name in ("torch.utils.tensorboard", "wandb"):
            raise ImportError(f"no {name}")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_tensorboard)
    writer = obs.summary_writer("meant", root=str(tmp_path))
    writer.add_scalar("loss", 1.0, 0)
    writer.close()
    assert obs.wandb_init("project", "run") is None
    out = capsys.readouterr().out
    assert "tensorboard unavailable" in out and "wandb unavailable" in out
    assert not os.listdir(tmp_path)


def test_set_debug_nans_is_anomaly_mode():
    try:
        obs.set_debug_nans(True)
        assert torch.is_anomaly_enabled()
        x = torch.tensor([0.0], requires_grad=True)
        with pytest.raises(RuntimeError, match="nan"):
            torch.sqrt(x - 1.0).sum().backward()
    finally:
        obs.set_debug_nans(False)
    assert not torch.is_anomaly_enabled()


def test_profile_trace_writes_a_trace(tmp_path):
    with obs.profile_trace(str(tmp_path / "trace")) as log_dir:
        torch.ones(64, 64) @ torch.ones(64, 64)
    files = os.listdir(log_dir)
    assert len(files) == 1 and files[0].endswith(".json")
    with open(os.path.join(log_dir, files[0])) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "aten::mm" in names


def test_trainer_draws_the_confusion_matrix_after_its_test_pass(tmp_path):
    """cli.in_loop_train's test pass writes
    output_files/<dataset>/plots/confusion_<model>_<run>.png, as JAX's
    trainer does (meant_tpu/train/classify.py:304-316)."""
    from meant_tpu_torch.cli import in_loop_train
    results = in_loop_train.main([
        "-rid", "cm", "-mn", "meant_src", "-nec", "1", "--synthetic_n",
        "12", "--seq_len", "8", "--image_size", "32", "--text_dim", "32",
        "--image_dim", "32", "--vocab_size", "64", "--num_heads", "4", "-tb",
        "4", "--device", "cpu", "-fp", str(tmp_path)])
    png = tmp_path / "output_files" / "Tempstock" / "plots" / \
        "confusion_meant_src_cm.png"
    assert png.read_bytes()[:4] == b"\x89PNG"
    assert "test" in results and results["checkpoint"]
