"""Writes the `.parquet` fixtures of the port's parquet reader into
tests/data/torch_parquet/, one directory a file, and `texts.json`: the
texts the JAX harness's `load_text` (pandas) reads from each, as `str()`
gives them. The card's machine has no pyarrow, so these files are how the
reader is checked there (`chip_smoke.py` phase 9); the CPU tests hold them
to `texts.json` and to the JAX harness.

    python tests/torch_parquet_fixtures.py [--big DIR]

needs pyarrow and pandas. `--big DIR` also writes a text column of some
10 MB (`BIG_BYTES` of UTF-8) under DIR, at pyarrow's defaults (snappy,
dictionary pages falling back to PLAIN) and snappy PLAIN, for
`meant_tpu_torch/tools/parquet_time.py`; keep DIR out of git (runs/).
`draw_texts` also feeds tests/test_torch_parquet.py.
"""

import argparse
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(ROOT, "data", "torch_parquet")

WORDS = ("the", "market", "fell", "rose", "after", "earnings", "$TSLA",
         "AAPL", "naïve", "café", "résumé", "🚀", "📉", "日本株", "don't",
         '"quoted"', "a,b", "—", "q3", "guidance")
PHRASES = ("buy the dip", "to the moon", "earnings beat expectations",
           "the fed raised rates again", "short squeeze incoming")

# name: (rows, share of nulls, pq.write_table options)
FILES = {
    "snappy_dict_v1_groups": (240, 0.1, dict(
        compression="SNAPPY", use_dictionary=True, data_page_version="1.0",
        row_group_size=80)),
    "gzip_plain_v2": (200, 0.1, dict(
        compression="GZIP", use_dictionary=False, data_page_version="2.0",
        data_page_size=2048, write_batch_size=32)),
    "cli_snappy_96": (96, 0.03, dict(
        compression="SNAPPY", use_dictionary=True, data_page_version="1.0")),
}
BIG_BYTES = 10_000_000
BIG = {"defaults": dict(compression="SNAPPY"),
       "plain": dict(compression="SNAPPY", use_dictionary=False)}


def draw_texts(rng: np.random.RandomState, n: int, null_share: float = 0.1,
               words: tuple = (3, 30)) -> list:
    """`n` tweet-like texts from `rng`: unicode words, repeated phrases
    (snappy's copies), some empty strings, some rows repeating an earlier
    one, and a `null_share` of None."""
    out, said = [], []
    for _ in range(n):
        r = rng.rand()
        if r < null_share:
            out.append(None)
        elif r < null_share + 0.05:
            out.append("")
        elif r < null_share + 0.15 and said:
            out.append(said[rng.randint(len(said))])
        else:
            out.append(" ".join(
                PHRASES[rng.randint(len(PHRASES))] if rng.rand() < 0.3
                else WORDS[rng.randint(len(WORDS))]
                for _ in range(rng.randint(*words))))
            said.append(out[-1])
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=FIXTURES)
    ap.add_argument("--big", default=None)
    args = ap.parse_args(argv)
    import pyarrow as pa
    import pyarrow.parquet as pq
    sys.path.insert(0, os.path.dirname(ROOT))
    from meant_tpu.cli.pretrain_mlm import load_text

    texts = {}
    for seed, (name, (rows, nulls, options)) in enumerate(FILES.items()):
        d = os.path.join(args.out, name)
        os.makedirs(d, exist_ok=True)
        table = pa.table({"text": pa.array(draw_texts(
            np.random.RandomState(seed), rows, nulls), pa.string())})
        pq.write_table(table, os.path.join(d, "texts.parquet"), **options)
        texts[name] = [str(t) for t in load_text(
            argparse.Namespace(data_dir=d))]
    with open(os.path.join(args.out, "texts.json"), "w",
              encoding="utf-8") as f:
        json.dump(texts, f, ensure_ascii=False, indent=0)
        f.write("\n")
    if args.big:
        rng, big, size = np.random.RandomState(len(FILES)), [], 0
        while size < BIG_BYTES:
            more = draw_texts(rng, 1000)
            big += more
            size += sum(len(t.encode()) for t in more if t)
        for name, options in BIG.items():
            d = os.path.join(args.big, name)
            os.makedirs(d, exist_ok=True)
            pq.write_table(pa.table({"text": pa.array(big, pa.string())}),
                           os.path.join(d, "texts.parquet"), **options)


if __name__ == "__main__":
    main()
