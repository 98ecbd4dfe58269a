"""TempStock-small loading, the synthetic TempStock set and deterministic
splits (counterpart of meant_tpu/data/datasets.py), numpy only.

* `load_tempstock_small` reads the SMOTE-resampled `.npy` arrays
  (graphs, tweets, attention_masks, macds, y_resampled, each with the lag
  suffix), optionally shifting the graphs by their global mean.
* `synthetic_tempstock` draws a TempStock-shaped set from a seed, with a
  learnable token planted on the target day.
* Splits are the reference's two sklearn train_test_split(random_state=42)
  calls, reproduced with numpy so index membership and order are identical
  to sklearn's.
* `fnv1a_tokenize` / `hash_tokenize` are the JAX package's FNV-1a hash
  tokenizer, through the port's copy of its C++ library (`native`), so a
  tab or a newline splits no token, as in JAX; `read_csv_texts` reads a
  column of a `.csv` (the pretraining texts, tweet_eval's text and label),
  `read_parquet_texts` one of a `.parquet` (the pretraining texts) and
  `read_csv_chunk` a window of a one-column `.csv` with the standard
  library and numpy, as the JAX harnesses read them with pandas.
* The frame converters (`tempstock_large_from_frame`,
  `stocknet_from_frame`, `djia_from_frame`) take any frame with
  `iterrows()` (a pandas DataFrame) or a list of row mappings, and
  `clean_bad_vqa` / `filter_arrays` drop VQA rows with empty soft labels.
"""

from __future__ import annotations

import csv
import math
import os
from typing import Dict, List, Tuple, Union

import numpy as np

from meant_tpu_torch.data.parquet import read_column
from meant_tpu_torch.native import fnv1a_tokenize  # re-exported


def load_tempstock_small(dir_path: str, lag_suffix: str = "_5",
                         normalize: bool = False) -> Dict[str, np.ndarray]:
    """`graphs{lag}.npy, tweets{lag}.npy, attention_masks{lag}.npy,
    macds{lag}.npy, y_resampled{lag}.npy` of `dir_path`, keyed graphs,
    tweets, attention_masks, macds, y."""
    def load(name):
        return np.load(os.path.join(dir_path, f"{name}{lag_suffix}.npy"))

    graphs = load("graphs")
    if normalize:
        graphs = graphs - graphs.mean()
    return {"graphs": graphs, "tweets": load("tweets"),
            "attention_masks": load("attention_masks"),
            "macds": load("macds"), "y": load("y_resampled")}


def synthetic_tempstock(n: int = 64, lag: int = 5, seq: int = 128,
                        channels: int = 4, size: int = 224,
                        vocab: int = 64000, seed: int = 0,
                        learnable: bool = True) -> Dict[str, np.ndarray]:
    """A TempStock-shaped set from `seed`; with `learnable`, the target
    day's first token is 3 for label 1 and 5 for label 0."""
    rng = np.random.RandomState(seed)
    tweets = rng.randint(4, vocab, size=(n, lag, seq)).astype(np.int32)
    graphs = rng.randn(n, lag, channels, size, size).astype(np.float32)
    macds = rng.randn(n, lag, 4).astype(np.float32)
    y = rng.randint(0, 2, size=(n,)).astype(np.int32)
    if learnable:
        tweets[y == 1, -1, 0] = 3
        tweets[y == 0, -1, 0] = 5
    masks = np.ones((n, lag, seq), np.float32)
    return {"graphs": graphs, "tweets": tweets, "attention_masks": masks,
            "macds": macds, "y": y}


def _sklearn_shuffle_split(n: int, test_size: float,
                           seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """sklearn `train_test_split(test_size=..., random_state=seed)`:
    `RandomState(seed).permutation(n)`, the first `ceil(test_size * n)`
    entries are the test part."""
    perm = np.random.RandomState(seed).permutation(n)
    n_test = int(math.ceil(test_size * n))
    return perm[n_test:], perm[:n_test]


def train_val_test_split(n: int, seed: int = 42, test_size: float = 0.2,
                         val_size: float = 0.25) -> Tuple[np.ndarray, ...]:
    """60/20/20: test carved off first, the rest split into train/val."""
    train_val, test = _sklearn_shuffle_split(n, test_size, seed)
    tr, va = _sklearn_shuffle_split(len(train_val), val_size, seed)
    return train_val[tr], train_val[va], test


def split_arrays(arrays: Dict[str, np.ndarray], seed: int = 42):
    """(train, val, test) dicts of the same keys."""
    n = len(next(iter(arrays.values())))
    tr, va, te = train_val_test_split(n, seed)
    pick = lambda sel: {k: v[sel] for k, v in arrays.items()}
    return pick(tr), pick(va), pick(te)


def hash_tokenize(vocab_size: int = 64000, max_len: int = 128):
    """text -> list of ids, BOS and EOS included (`native.fnv1a_tokenize`,
    the C++ library where it builds): the no-network stand-in for an HF
    tokenizer."""

    def tok(text: str):
        ids, mask = fnv1a_tokenize([text], max_len, vocab_size)
        return ids[0, : int(mask[0].sum())].tolist()

    return tok


# pandas.read_csv's default missing-value strings (`na_values`)
_CSV_NA = frozenset((
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null"))


def read_csv_texts(path: str, column: Union[int, str] = 0) -> List[str]:
    """One column of a `.csv` (the first, or the one whose header is
    `column`) as `pd.read_csv(path)[column].astype(str)` reads it: the
    first row is the header, blank lines are skipped, quoted fields may
    hold commas and newlines, and a missing value (an empty cell, "NA",
    ...) reads "nan", as pandas 2 gives it. A column pandas would parse as
    numbers keeps its text here."""
    with open(path, newline="", encoding="utf-8-sig") as f:
        rows = [row for row in csv.reader(f) if row]
    i = column if isinstance(column, int) else rows[0].index(column)
    cells = [row[i] if i < len(row) else "" for row in rows[1:]]
    return ["nan" if c in _CSV_NA else c for c in cells]


def read_parquet_texts(path: str, column: int = 0) -> List[str]:
    """One column of a `.parquet` (the first, or the `column`-th, index
    columns of the pandas metadata left out) as
    `pd.read_parquet(path).iloc[:, column].astype(str)` reads it: every
    row group and page in order, a missing value as "nan", as
    `read_csv_texts` reads one, an integer column with a null as pandas'
    float64 strings ("1.0"). Decoded by `data.parquet` with the standard
    library and numpy: UNCOMPRESSED, SNAPPY and GZIP pages of strings,
    integers, floats and booleans; what it does not decode raises
    NotImplementedError naming it."""
    return read_column(path, column)


# ---- frames to arrays (meant_tpu/data/datasets.py:85-186) ---------------

TEMPSTOCK_PRICE_COLS = ("EMA12", "EMA26", "Signal_Line", "MACD_Histogram",
                        "MACD")


def _rows(frame) -> list:
    """The rows of a pandas DataFrame (`iterrows()`) or of a list of row
    mappings."""
    if hasattr(frame, "iterrows"):
        return [row for _, row in frame.iterrows()]
    return list(frame)


def _labels(rows) -> np.ndarray:
    return np.asarray([row["label"] for row in rows]).astype(np.int32)


def _tokenized_days(rows, tokenize, text, lag, max_len, pad_id):
    """(n, lag, max_len) ids padded with pad_id and their mask, day d of
    row i from `tokenize(text(row, d))` cut at max_len."""
    ids = np.full((len(rows), lag, max_len), pad_id, np.int32)
    mask = np.zeros((len(rows), lag, max_len), np.float32)
    for i, row in enumerate(rows):
        for day in range(lag):
            toks = tokenize(text(row, day))[:max_len]
            ids[i, day, :len(toks)] = toks
            mask[i, day, :len(toks)] = 1.0
    return ids, mask


def tempstock_large_from_frame(df, graphs: np.ndarray, tokenize,
                               lag: int = 5, max_len: int = 512,
                               pad_id: int = 1):
    """TempStockLarge layout (`src/utils/custom_datasets.py:440-560`):
    text_0..text_{lag-1}, the per-day `TEMPSTOCK_PRICE_COLS` and `label`;
    `tokenize(text) -> list[int]` is the harness's."""
    rows = _rows(df)
    ids, mask = _tokenized_days(rows, tokenize,
                                lambda r, d: str(r[f"text_{d}"]), lag,
                                max_len, pad_id)
    prices = np.zeros((len(rows), lag, len(TEMPSTOCK_PRICE_COLS)),
                      np.float32)
    for i, row in enumerate(rows):
        for day in range(lag):
            for j, col in enumerate(TEMPSTOCK_PRICE_COLS):
                prices[i, day, j] = row[f"{col}_{day}"]
    return {"input_ids": ids, "attention_mask": mask, "prices": prices,
            "pixels": graphs.astype(np.float32), "y": _labels(rows)}


def stocknet_from_frame(df, tokenize, lag: int = 5, max_len: int = 128,
                        pad_id: int = 1, price_cols=("high", "low", "close")):
    """Stocknet layout (`src/utils/custom_datasets.py:398-437`); a price
    column a row lacks stays 0."""
    rows = _rows(df)
    ids, mask = _tokenized_days(rows, tokenize,
                                lambda r, d: str(r[f"text_{d}"]), lag,
                                max_len, pad_id)
    prices = np.zeros((len(rows), lag, len(price_cols)), np.float32)
    for i, row in enumerate(rows):
        for day in range(lag):
            for j, col in enumerate(price_cols):
                if f"{col}_{day}" in row:
                    prices[i, day, j] = row[f"{col}_{day}"]
    return {"tweets": ids, "attention_masks": mask, "prices": prices,
            "y": _labels(rows)}


def djia_from_frame(df, tokenize, lag: int = 5, max_len: int = 512,
                    pad_id: int = 1):
    """djiaNews layout (`src/utils/custom_datasets.py:353-396`): the 25
    headlines Top1_d..Top25_d of each shifted day joined by spaces."""
    rows = _rows(df)

    def text(row, day):
        return " ".join(str(row.get(f"Top{k}_{day}", ""))
                        for k in range(1, 26))

    ids, mask = _tokenized_days(rows, tokenize, text, lag, max_len, pad_id)
    return {"tweets": ids, "attention_masks": mask, "y": _labels(rows)}


def _csv_records(f):
    """Records of a `.csv` read as pandas' C parser reads it with
    `lineterminator="\\n"`: a quoted field may hold commas, newlines and
    doubled quotes; a quote inside an unquoted field is kept; a record is a
    list of (text, quoted) fields. (The `csv` module would end a record at
    a lone "\\r" too, which pandas keeps in the text.)"""
    fields, field = [], []
    state, quoted, started = "start", False, False
    for line in f:
        for ch in line:
            started = True
            if state == "quoted":
                if ch == '"':
                    state = "quote"
                else:
                    field.append(ch)
                continue
            if state == "quote" and ch == '"':
                field.append(ch)
                state = "quoted"
                continue
            if ch in ",\n":
                fields.append(("".join(field), quoted))
                field, state, quoted = [], "start", False
                if ch == "\n":
                    yield fields
                    fields, started = [], False
            elif state == "start" and ch == '"':
                state, quoted = "quoted", True
            else:
                field.append(ch)
                state = "field"
    if started:
        fields.append(("".join(field), quoted))
        yield fields


def read_csv_chunk(csv_file: str, start_row: int, end_row: int) -> list:
    """`CSVChunkDataset` (`src/utils/custom_datasets.py:563-571`): rows of
    a one-text-column `.csv` as `pd.read_csv(csv_file, skiprows=start_row,
    nrows=end_row - start_row - 1, names=["text"], lineterminator="\\n")`
    gives them, with the reference's off-by-one (the last requested row is
    never read), as a list of {"text": value} mappings. The first
    `start_row` records are skipped (a quoted newline is no record end,
    a blank line counts), after that a line of spaces and tabs is no row,
    a missing value ("", "NA", ...) reads float("nan"), and a "\\r"
    stays in its text. Text that pandas would parse as numbers stays text
    here; a row of more than one field raises ValueError, as pandas does
    past the first row."""
    nrows = end_row - start_row - 1
    if nrows < 0:
        raise ValueError("'nrows' must be an integer >=0")
    rows = []
    with open(csv_file, newline="\n", encoding="utf-8") as f:
        for i, record in enumerate(_csv_records(f)):
            if i < start_row:
                continue                      # skipped rows count blanks
            if len(rows) == nrows:
                break
            if len(record) > 1:
                raise ValueError(f"Expected 1 fields, saw {len(record)}")
            text, quoted = record[0]
            if not quoted and not text.strip(" \t"):
                continue                      # a blank line is no row
            rows.append({"text": float("nan") if text in _CSV_NA
                         else text})
    return rows


def clean_bad_vqa(records) -> Tuple[list, list]:
    """The `clean_bad` flow of `vqa.py:372-400`: a VQA row is bad when its
    soft-label ids or weights are empty, HF-style (`{'label': {'ids': [...],
    'weights': [...]}}`) or in `extract_records`' layout (`{'answers':
    {answer: count}}`). Returns (bad_indices, good_indices)."""
    bad_indices, good_indices = [], []
    for index, data in enumerate(records):
        label = data.get("label") if isinstance(data, dict) else None
        if label is not None:
            empty = (len(label.get("ids", ())) == 0
                     or len(label.get("weights", ())) == 0)
        else:
            empty = len(data.get("answers", {})) == 0
        (bad_indices if empty else good_indices).append(index)
    return bad_indices, good_indices


def filter_arrays(data, good_indices):
    """`FilteredDataset` (`utils/custom_datasets.py:223-233`): the rows of
    `good_indices`, of a dict of arrays or of any indexable sequence."""
    if isinstance(data, dict):
        sel = np.asarray(good_indices, dtype=np.int64)
        return {k: v[sel] for k, v in data.items()}
    return [data[i] for i in good_indices]
