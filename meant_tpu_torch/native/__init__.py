"""Host C++ for the data path, bound with ctypes (counterpart of
meant_tpu/native/__init__.py).

`collate.cpp` (a copy of the JAX package's) is built with g++ at first
use into `meant_tpu_torch/_build/` (git-ignored), named by a hash of the
source and the flags, so an edited source or a changed flag set is
rebuilt. A machine with no compiler takes the numpy path of each
function, as the JAX package does. The two paths of `fnv1a_tokenize`
split differently: the library on spaces only, numpy on any whitespace,
so "a\\tb" is one token through the library and two through numpy.

`MEANT_NATIVE_ARCH=native` adds `-march=native` to the flags.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Optional

import numpy as np

SOURCE = Path(__file__).resolve().parent / "collate.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"

_lib: Optional[ctypes.CDLL] = None
_tried = False
_lock = threading.Lock()


def _flags() -> list:
    arch = (["-march=native"]
            if os.environ.get("MEANT_NATIVE_ARCH", "") == "native" else [])
    return ["g++", "-O3", *arch, "-shared", "-fPIC", "-std=c++17"]


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(_flags()).encode())
    return BUILD_DIR / f"libcollate-{digest.hexdigest()[:16]}.so"


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C")
    lib.fnv1a_tokenize.argtypes = [
        ctypes.c_char_p, i64p, ctypes.c_int, ctypes.c_int, ctypes.c_int64,
        ctypes.c_int32, i32p, f32p]
    lib.pad_two_level.argtypes = [
        i32p, i32p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int32, i32p, f32p]
    lib.center_pad_images.argtypes = [
        f32p, i32p, ctypes.c_int, ctypes.c_int, ctypes.c_int, f32p, f32p]
    for fn in (lib.fnv1a_tokenize, lib.pad_two_level,
               lib.center_pad_images):
        fn.restype = None
    return lib


def _build() -> Optional[ctypes.CDLL]:
    """The loaded library, built first if needed; None (once, with the
    reason printed) where g++ is missing or fails. Concurrent builds
    write to their own temporary file and rename it into place."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = library_path()
        if not path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            try:
                subprocess.run([*_flags(), str(SOURCE), "-o", str(tmp)],
                               check=True, capture_output=True, text=True)
                os.replace(tmp, path)
            except (subprocess.CalledProcessError, FileNotFoundError) as e:
                detail = getattr(e, "stderr", "") or e
                print(f"[meant_tpu_torch.native] build failed, using the "
                      f"numpy path: {detail}")
                return None
        _lib = _bind(ctypes.CDLL(str(path)))
        return _lib


def available() -> bool:
    """Whether the C++ library is built and loaded."""
    return _build() is not None


def _fnv1a(b: bytes) -> int:
    h = 1469598103934665603
    for c in b:
        h = ((h ^ c) * 1099511628211) & 0xFFFFFFFFFFFFFFFF
    return h


def fnv1a_tokenize(texts: List[str], max_len: int, vocab: int,
                   pad_id: int = 1):
    """Deterministic hash tokenizer: BOS/EOS id 2 around the first
    max_len - 2 words, each hashed into [4, vocab). Returns (ids (n,
    max_len) int32, mask (n, max_len) f32)."""
    n = len(texts)
    lib = _build()
    if lib is not None:
        enc = [t.encode("utf-8", "ignore") for t in texts]
        offsets = np.zeros(n + 1, np.int64)
        np.cumsum([len(e) for e in enc], out=offsets[1:])
        ids = np.empty((n, max_len), np.int32)
        mask = np.empty((n, max_len), np.float32)
        lib.fnv1a_tokenize(b"".join(enc), offsets, n, max_len, vocab,
                           pad_id, ids, mask)
        return ids, mask
    ids = np.full((n, max_len), pad_id, np.int32)
    mask = np.zeros((n, max_len), np.float32)
    for i, t in enumerate(texts):
        toks = [2] + [4 + _fnv1a(w.encode("utf-8", "ignore")) % (vocab - 4)
                      for w in t.split()][: max_len - 2] + [2]
        ids[i, : len(toks)] = toks
        mask[i, : len(toks)] = 1.0
    return ids, mask


def pad_two_level(token_lists: List[List[List[int]]], max_len: int,
                  pad_id: int = 1):
    """token_lists: n samples x lag days x ragged token ids. Returns
    ((n, lag, max_len) int32 ids, f32 mask): the reference's lag collator
    (`src/utils/custom_datasets.py:238-277`) at a fixed max_len."""
    n = len(token_lists)
    lag = len(token_lists[0])
    lib = _build()
    if lib is not None:
        lengths = np.array([len(day) for s in token_lists for day in s],
                           np.int32)
        flat = np.fromiter((t for s in token_lists for day in s
                            for t in day), np.int32,
                           count=int(lengths.sum()))
        ids = np.empty((n * lag, max_len), np.int32)
        mask = np.empty((n * lag, max_len), np.float32)
        lib.pad_two_level(flat, lengths, n, lag, max_len, pad_id, ids, mask)
        return ids.reshape(n, lag, max_len), mask.reshape(n, lag, max_len)
    ids = np.full((n, lag, max_len), pad_id, np.int32)
    mask = np.zeros((n, lag, max_len), np.float32)
    for i, sample in enumerate(token_lists):
        for d, day in enumerate(sample):
            keep = min(len(day), max_len)
            ids[i, d, :keep] = day[:keep]
            mask[i, d, :keep] = 1.0
    return ids, mask


def center_pad_images(images: List[np.ndarray], height: int, width: int):
    """Center-pad (c, h, w) float32 images to (n, c, H, W) and an (n, H,
    W) pixel mask."""
    n = len(images)
    c = images[0].shape[0]
    lib = _build()
    if lib is not None:
        dims = np.array([im.shape for im in images], np.int32).reshape(-1)
        flat = np.concatenate([np.ascontiguousarray(im, np.float32).ravel()
                               for im in images])
        out = np.empty((n, c, height, width), np.float32)
        mask = np.empty((n, height, width), np.float32)
        lib.center_pad_images(flat, dims, n, height, width, out, mask)
        return out, mask
    from meant_tpu_torch.data.vqa import center_pad_images as numpy_path
    return numpy_path(images, height, width)
