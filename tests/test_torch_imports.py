"""Import hygiene of the port: no module of meant_tpu_torch and not
chip_smoke.py imports jax, flax, optax, safetensors, transformers, pandas,
a parquet library (pyarrow, fastparquet) or a snappy binding (snappy,
cramjam), or anything of meant_tpu (the card's machine has none of them:
the port reads the safetensors format, its `.csv` files and its
`.parquet` files itself)."""

import ast
import sys
from pathlib import Path

import pytest

import torch_threads

torch_threads.share_cores()

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "meant_tpu", "safetensors",
             "transformers", "pandas", "pyarrow", "fastparquet", "snappy",
             "cramjam")
FILES = sorted((ROOT / "meant_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
              and node.func.id == "__import__" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


def test_port_has_sources():
    assert len(FILES) > 10 and (ROOT / "chip_smoke.py").exists()


# the host data path: numpy, the standard library and g++ only
HOST_MODULES = ["native/__init__.py", "utils/observability.py",
                "data/macd.py", "data/smote.py", "data/parquet.py",
                "data_engineering/__init__.py", "data_engineering/dataprep.py",
                "data_engineering/fetchers.py",
                "data_engineering/image_prep.py",
                "data_engineering/mosi_prep.py",
                "data_engineering/prepare_vqa.py", "data_engineering/snes.py",
                "data_engineering/stocknet_prep.py"]


def test_host_data_modules_are_checked():
    assert {ROOT / "meant_tpu_torch" / m for m in HOST_MODULES} <= set(FILES)


def test_parquet_reader_needs_only_numpy_and_the_standard_library():
    roots = set(_imported_roots(ROOT / "meant_tpu_torch" / "data" /
                                "parquet.py"))
    assert roots - set(sys.stdlib_module_names) == {"numpy"}


# the parallel layouts, the GPipe pipeline among them
PARALLEL_MODULES = ["parallel/mesh.py", "parallel/sharding_rules.py",
                    "parallel/fsdp.py", "parallel/pipeline.py",
                    "ops/ring.py", "train/layout.py"]


def test_parallel_modules_are_checked():
    assert {ROOT / "meant_tpu_torch" / m
            for m in PARALLEL_MODULES} <= set(FILES)


@pytest.mark.parametrize("path", FILES,
                         ids=[str(p.relative_to(ROOT)) for p in FILES])
def test_no_jax_or_reference_imports(path):
    bad = sorted({r for r in _imported_roots(path) if r in FORBIDDEN})
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"
