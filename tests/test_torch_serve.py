"""Serving in the port: Predictor padding, the CLI smoke, and the rule that
entry points run on the card unless the caller asks for the CPU."""

import numpy as np
import pytest
import torch

from meant_tpu_torch.cli import serve as serve_cli
from meant_tpu_torch.models import EmbeddingConfig, meant_src
from meant_tpu_torch.serve import Predictor
from meant_tpu_torch.train import checkpoint as ckpt

GEOM = dict(text_dim=32, image_dim=32, price_dim=5, height=32, width=32,
            patch_res=16, lag=5, num_classes=2, num_heads=4, num_encoders=1,
            channels=3, seq_len=16)
EMB = EmbeddingConfig(vocab_size=64, hidden_size=32,
                      max_position_embeddings=40, dropout=0.0)


def _batch(n, seed=0):
    rng = np.random.RandomState(seed)
    return {"input_ids": rng.randint(2, 64, (n, 5, 12)).astype(np.int32),
            "pixels": rng.randn(n, 5, 3, 32, 32).astype(np.float32),
            "prices": rng.randn(n, 5, 5).astype(np.float32),
            "attention_mask": np.ones((n, 5, 12), np.float32)}


def test_predictor_pads_and_matches_direct():
    model = meant_src(embedding=EMB, fixed_proj=True, device="cpu", **GEOM)
    batch = _batch(11)
    probs = Predictor(model, "meant_src", batch_size=4, device="cpu")(batch)
    assert probs.shape == (11, 2) and probs.dtype == np.float32
    with torch.no_grad():
        direct = model(**{k: torch.as_tensor(v) for k, v in batch.items()})
    np.testing.assert_allclose(probs, direct.numpy(), rtol=1e-5, atol=1e-6)


def test_serve_cli_smoke(tmp_path):
    out = tmp_path / "probs.npy"
    probs = serve_cli.main([
        "-rid", "50", "-mn", "meant_src", "-nec", "1", "--synthetic_n", "10",
        "--seq_len", "12", "--image_size", "32", "--text_dim", "32",
        "--image_dim", "32", "--vocab_size", "128", "--num_heads", "4",
        "--serve_batch", "4", "--device", "cpu", "--output", str(out)])
    assert probs.shape == (10, 2)
    assert np.isfinite(probs).all()
    np.testing.assert_array_equal(np.load(out), probs)


def test_serve_cli_takes_and_ignores_mu_bf16():
    """--mu_bf16 is a training flag of the shared parser: the serving CLI
    takes it and serves the same probabilities, as JAX's does."""
    argv = ["-rid", "51", "-mn", "meant_src", "-nec", "1", "--synthetic_n",
            "6", "--seq_len", "12", "--image_size", "32", "--text_dim", "32",
            "--image_dim", "32", "--vocab_size", "128", "--num_heads", "4",
            "--serve_batch", "4", "--device", "cpu"]
    np.testing.assert_array_equal(serve_cli.main(argv + ["--mu_bf16"]),
                                  serve_cli.main(argv))


@pytest.mark.parametrize("flag", [["--fsdp"]])
def test_serve_cli_refuses_what_is_not_ported(flag):
    argv = ["-rid", "0", "-mn", "meant_src", "--device", "cpu",
            "--seq_len", "12", "--image_size", "32", "-nec", "1"] + flag
    with pytest.raises(NotImplementedError):
        serve_cli.main(argv)


def test_predictor_refuses_checkpoint_path(tmp_path):
    """Predictor restores a checkpoint of the port's trainer; a path that
    holds none, or one of another architecture, is refused."""
    model = meant_src(embedding=EMB, device="cpu", **GEOM)
    with pytest.raises(FileNotFoundError):
        Predictor(model, "meant_src", checkpoint_path=str(tmp_path / "none"),
                  device="cpu")
    other = meant_src(embedding=EMB, device="cpu",
                      **dict(GEOM, num_encoders=2))
    path = str(tmp_path / "models" / "ckpt")
    ckpt.save(path, {"params": other.state_dict(), "step": 0})
    with pytest.raises(RuntimeError):
        Predictor(model, "meant_src", checkpoint_path=path, device="cpu")


def test_serve_cli_serves_a_checkpoint(tmp_path):
    argv = ["-rid", "51", "-mn", "meant_src", "-nec", "1", "--synthetic_n",
            "6", "--seq_len", "12", "--image_size", "32", "--text_dim", "32",
            "--image_dim", "32", "--vocab_size", "64", "--num_heads", "4",
            "--serve_batch", "4", "--device", "cpu"]
    args = serve_cli.serve_parser().parse_args(argv + ["--seed", "3"])
    trained = serve_cli.build_model(args)
    path = str(tmp_path / "models" / "ckpt")
    ckpt.save(path, {"params": trained.state_dict(), "step": 1})
    probs = serve_cli.main(argv + ["--checkpoint", path])
    rows = serve_cli.synthetic_batch(args, 6)
    del rows["y"]
    want = Predictor(trained, "meant_src", batch_size=4, device="cpu")(rows)
    np.testing.assert_array_equal(probs, want)
    fresh = serve_cli.main(argv)
    assert not np.array_equal(fresh, probs)


def test_entry_points_need_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = meant_src(embedding=EMB, device="cpu", **GEOM)
    with pytest.raises(RuntimeError, match="CUDA"):
        Predictor(model, "meant_src")
    with pytest.raises(RuntimeError, match="CUDA"):
        meant_src(embedding=EMB, **GEOM)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_cli.main(["-rid", "0", "-mn", "meant_src", "-nec", "1",
                        "--seq_len", "12", "--image_size", "32"])
