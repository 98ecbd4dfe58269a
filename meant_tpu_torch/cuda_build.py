"""Build the package's CUDA sources with nvcc into shared libraries with a
plain C interface, and load them with ctypes.

Each library is built at first use into `meant_tpu_torch/_build/` (listed
in .gitignore), named by a hash of its source, the shared headers in
`csrc/*.cuh` and the flags, so an edited source or header is rebuilt.
`build_all` starts one nvcc per source at once and waits for them all.
`KernelLauncher` is the base of every kernel wrapper: it binds the C entry
point, launches on PyTorch's current stream, raises on a launch error and
counts launches.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from collections import Counter
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

PACKAGE_DIR = Path(__file__).resolve().parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "are built from csrc/ at first use")
    return nvcc


def _library_path(name: str, csrc: Optional[Path] = None,
                  build: Optional[Path] = None) -> Path:
    csrc, build = csrc or CSRC_DIR, build or BUILD_DIR
    digest = hashlib.sha256((csrc / f"{name}.cu").read_bytes())
    for header in sorted(csrc.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return build / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build_all(names: Iterable[str],
              trees: Optional[Iterable[tuple]] = None) -> Dict[str, str]:
    """Build csrc/<name>.cu for every name not built yet, one nvcc each,
    all started together. Returns nvcc's output per name (with the -Xptxas
    -v register/shared-memory report; "" when there was nothing to build);
    raises if any nvcc fails, after all of them have ended. `trees`, (csrc,
    build) directory pairs, builds each name in each of them instead of
    the package's own (patched copies of csrc/); the output is then keyed
    "<csrc>:<name>"."""
    trees = list(trees) if trees is not None else [(CSRC_DIR, BUILD_DIR)]
    own = trees == [(CSRC_DIR, BUILD_DIR)]
    logs: Dict[str, str] = {}
    running = {}
    for csrc, build in trees:
        Path(build).mkdir(parents=True, exist_ok=True)
        for name in names:
            key = name if own else f"{csrc}:{name}"
            out = _library_path(name, Path(csrc), Path(build))
            if out.exists():
                logs[key] = ""
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            running[key] = (out, tmp, subprocess.Popen(
                [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                 str(Path(csrc) / f"{name}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
    failed = []
    for name, (out, tmp, proc) in running.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name} (exit "
                          f"{proc.returncode}):\n{logs[name]}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


def load_library(name: str) -> ctypes.CDLL:
    """ctypes handle of csrc/<name>.cu, building it first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(_library_path(name)))
        _loaded[name] = lib
    return lib


class KernelLauncher:
    """A C entry point `symbol` of csrc/<library>.cu (argument types
    `argtypes`, the stream last, a cudaError_t returned), loaded at the
    first launch. `launches` counts launches that reached the card;
    `launches_by_shape` splits the same count by the shape key each
    launch names."""

    symbol = ""
    library = ""
    argtypes: list = []

    def __init__(self):
        self.launches = 0
        self.launches_by_shape: Counter = Counter()
        self._fn = None

    def _function(self):
        if self._fn is None:
            fn = getattr(load_library(self.library), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def _launch(self, device, *args, shape) -> None:
        stream = torch.cuda.current_stream(device).cuda_stream
        with torch.cuda.device(device):
            err = self._function()(*args, stream)
        if err != 0:
            raise RuntimeError(f"{self.symbol} launch failed: cudaError "
                               f"{err}")
        self.launches += 1
        self.launches_by_shape[shape] += 1
