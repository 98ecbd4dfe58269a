"""The exported forward of the port (`serve.export_forward` /
`load_exported`, `cli/serve.py --export`) on the CPU.

A narrow meant_src (2 encoders, width 64 in 2 heads, s=12, flash on,
fixed_proj=True so the towers reach the probabilities) exported in fp32
and in int8 serves as the live Predictor does, within 1e-5 (JAX's
`test_stablehlo_export_roundtrip` bar); the program holds the port's
flash op; it takes its params as an input; and it loads and runs in a
process that never imports the model code.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from meant_tpu_torch.cli import serve as serve_cli
from meant_tpu_torch.models import EmbeddingConfig, meant_src
from meant_tpu_torch.serve import Predictor, export_forward, load_exported

import torch_threads

torch_threads.share_cores()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GEOM = dict(text_dim=64, image_dim=64, price_dim=5, height=32, width=32,
            patch_res=16, lag=3, num_classes=2, num_heads=2, num_encoders=2,
            channels=3, seq_len=16, fixed_proj=True, flash=True)
EMB = EmbeddingConfig(vocab_size=64, hidden_size=64,
                      max_position_embeddings=40, dropout=0.0)
B = 4
FLASH_OPS = ("meant_tpu_torch.flash_fwd.default",
             "meant_tpu_torch.flash_fwd_lse.default")


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    return {"input_ids": rng.randint(2, 64, (B, 3, 12)).astype(np.int32),
            "pixels": rng.randn(B, 3, 3, 32, 32).astype(np.float32),
            "prices": rng.randn(B, 3, 5).astype(np.float32),
            "attention_mask": np.ones((B, 3, 12), np.float32)}


@pytest.fixture(scope="module", params=[None, "int8"], ids=["fp32", "int8"])
def exported(request, tmp_path_factory):
    """(quantize, model, program, path) of one export."""
    model = meant_src(embedding=EMB, device="cpu", seed=1, **GEOM)
    path = str(tmp_path_factory.mktemp("export") / "forward.pt2")
    program = export_forward(model, "meant_src", _batch(), path,
                             quantize=request.param)
    return request.param, model, program, path


def test_round_trip_equals_the_live_predictor(exported):
    quantize, model, _, path = exported
    batch = _batch(3)
    live = Predictor(model, "meant_src", batch_size=B, device="cpu",
                     quantize=quantize)(batch)
    got = load_exported(path)(model.state_dict(), batch)
    assert got.shape == (B, 2) and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), live, rtol=1e-5, atol=1e-5)


def test_program_holds_the_flash_op_and_no_params(exported):
    _, model, program, _ = exported
    targets = [str(n.target) for n in program.graph.nodes
               if n.op == "call_function"]
    assert targets.count(FLASH_OPS[0]) == 2 * GEOM["num_encoders"]
    assert not program.state_dict    # the params are inputs, not stored
    n_inputs = len(program.graph_signature.user_inputs)
    assert n_inputs == len(model.state_dict()) + len(_batch())


def test_program_serves_other_params(exported):
    quantize, _, _, path = exported
    other = meant_src(embedding=EMB, device="cpu", seed=7, **GEOM)
    batch = _batch(4)
    got = load_exported(path)(other.state_dict(), batch)
    want = Predictor(other, "meant_src", batch_size=B, device="cpu",
                     quantize=quantize)(batch)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


LOAD = """
import json, sys
import numpy as np, torch
from meant_tpu_torch.serve import load_exported
fn = load_exported(sys.argv[1])
params = torch.load(sys.argv[2])
probs = fn(params, dict(np.load(sys.argv[3])))
np.save(sys.argv[4], probs.numpy())
print(json.dumps(sorted(m for m in sys.modules
                        if m.startswith("meant_tpu_torch.models"))))
"""


def test_loads_without_the_model_code(exported, tmp_path):
    quantize, model, _, path = exported
    batch = _batch(5)
    files = [str(tmp_path / f) for f in ("params.pt", "batch.npz",
                                         "probs.npy")]
    torch.save(model.state_dict(), files[0])
    np.savez(files[1], **batch)
    env = dict(os.environ, PYTHONPATH=ROOT)
    done = subprocess.run([sys.executable, "-c", LOAD, path, *files],
                          capture_output=True, text=True, env=env,
                          timeout=300)
    assert done.returncode == 0, done.stderr[-3000:]
    assert json.loads(done.stdout.strip().splitlines()[-1]) == []
    want = Predictor(model, "meant_src", batch_size=B, device="cpu",
                     quantize=quantize)(batch)
    np.testing.assert_allclose(np.load(files[2]), want, rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_serve_cli_exports(int8, tmp_path):
    """`cli.serve --export PATH [--int8]`: the program (at --serve_batch
    rows, the short chunk padded with its first row) serves the CLI's rows
    as the CLI did."""
    path = str(tmp_path / "cli.pt2")
    argv = ["-rid", "0", "-mn", "meant_src", "-nec", "1", "--seq_len", "12",
            "--image_size", "32", "--text_dim", "32", "--image_dim", "32",
            "--vocab_size", "64", "--num_heads", "4", "--synthetic_n", "3",
            "--serve_batch", "4", "--device", "cpu", "--flash", "true",
            "--export", path] + (["--int8"] if int8 else [])
    probs = serve_cli.main(argv)
    args = serve_cli.serve_parser().parse_args(argv)
    model = serve_cli.build_model(args)
    batch = serve_cli.synthetic_batch(args, 3)
    del batch["y"]
    padded = {k: np.concatenate([v, v[:1]]) for k, v in batch.items()}
    got = load_exported(path)(model.state_dict(), padded)
    assert got.shape == (4, 2)
    np.testing.assert_allclose(got.float().numpy()[:3], probs, rtol=1e-5,
                               atol=1e-5)
