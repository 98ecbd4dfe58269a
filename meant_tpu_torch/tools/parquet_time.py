"""Host time of the port's parquet reader on large files.

    python3 -m meant_tpu_torch.tools.parquet_time FILE [FILE ...]

decodes each `.parquet` `REPEATS` times through
`data.datasets.read_parquet_texts` (footer, pages, codecs, values,
strings) and prints one JSON line a file: its bytes,
rows and UTF-8 text bytes, the decode seconds of each repeat, the seconds
of each repeat spent in `data.parquet.snappy_decompress`, and the
machine's card and power limit (`nvidia-smi`; "none" where it has no
card). The reader runs on the host's CPU only: the card does not enter
the number, it names the machine. Write ~10 MB text columns with
`python tests/torch_parquet_fixtures.py --big runs/parquet_big` where
pyarrow is installed, and ship them with the tree.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

from meant_tpu_torch.data import parquet
from meant_tpu_torch.data.datasets import read_parquet_texts

REPEATS = 3


def machine() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return "none"
    return out.stdout.strip().splitlines()[0]


def time_file(path: str) -> dict:
    snappy = parquet.snappy_decompress
    spent = []

    def timed(data):
        t0 = time.perf_counter()
        out = snappy(data)
        spent[-1] += time.perf_counter() - t0
        return out

    decode = []
    parquet.snappy_decompress = timed
    try:
        for _ in range(REPEATS):
            spent.append(0.0)
            t0 = time.perf_counter()
            texts = read_parquet_texts(path)
            decode.append(time.perf_counter() - t0)
    finally:
        parquet.snappy_decompress = snappy
    return {"file": path, "bytes": os.path.getsize(path),
            "rows": len(texts),
            "text_bytes": sum(len(t.encode("utf-8")) for t in texts),
            "decode_s": decode, "snappy_s": spent}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("files", nargs="+")
    args = ap.parse_args(argv)
    card = machine()
    for path in args.files:
        print(json.dumps(dict(time_file(path), card=card,
                              cpus=os.cpu_count())), flush=True)


if __name__ == "__main__":
    main()
