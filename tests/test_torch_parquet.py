"""The port's parquet reader (`meant_tpu_torch/data/parquet.py`) against
the JAX harness, which reads a `.parquet` with pandas: `cli.pretrain_mlm`'s
`load_text` on files pyarrow writes into `tmp_path` (codecs, dictionary
and PLAIN pages, v1 and v2 pages, row groups, many pages, pandas index
columns, every physical type the reader takes, with and without nulls),
the snappy decoder against pyarrow's compressor and hand-built streams,
the refusals (codecs, encodings, types, nested columns) and malformed
files, the committed fixtures that `chip_smoke.py` decodes on the card,
and `mlm_arrays` and the CLI's loop on a `.parquet`."""

import argparse
import json
import os

import numpy as np
import pytest

pa = pytest.importorskip("pyarrow")
import pyarrow.parquet as pq  # noqa: E402
import pandas as pd  # noqa: E402

import meant_tpu.cli.pretrain_mlm as j_cli_mlm  # noqa: E402
from meant_tpu_torch.cli import pretrain_mlm  # noqa: E402
from meant_tpu_torch.cli.common import base_parser  # noqa: E402
from meant_tpu_torch.data import parquet  # noqa: E402
from meant_tpu_torch.data.datasets import read_parquet_texts  # noqa: E402

import torch_threads  # noqa: E402
from torch_parquet_fixtures import FILES, FIXTURES, draw_texts  # noqa: E402

torch_threads.share_cores()

WIDTHS = ["-nec", "2", "--seq_len", "12", "--text_dim", "32",
          "--num_heads", "4", "--vocab_size", "101", "-tb", "4"]
CPU = ["--device", "cpu"]


def texts(n=300, seed=0, nulls=0.1):
    return pa.array(draw_texts(np.random.RandomState(seed), n, nulls),
                    pa.string())


def both(d) -> tuple:
    """(the port's load_text, str() of the JAX harness's) on `d`."""
    args = argparse.Namespace(data_dir=str(d), synthetic_n=0)
    return (pretrain_mlm.load_text(args),
            [str(t) for t in j_cli_mlm.load_text(args)])


def data_pages(path: str, group: int = 0) -> int:
    """Data pages in column 0's chunk of row group `group`."""
    cm = pq.read_metadata(path).row_group(group).column(0)
    start = cm.dictionary_page_offset or cm.data_page_offset
    with open(path, "rb") as f:
        f.seek(start)
        reader = parquet._Thrift(f.read(cm.total_compressed_size))
    n = 0
    while reader.pos < reader.end:
        header = reader.struct()
        reader.take(header[3])
        n += header[1] in (0, 3)
    return n


# ---- the reader against the JAX harness ----------------------------------

def _table(**cols):
    return lambda: pa.table(cols)


def _typed(values, typ, nulls):
    return _table(c=pa.array([None if nulls and i % 3 == 1 else v
                              for i, v in enumerate(values)], typ))


INTS = [1, -3, 7, 0, 2 ** 30, -(2 ** 31)]
TYPED = {
    "int32": (INTS, pa.int32()),
    "int64": (INTS + [2 ** 62, -(2 ** 63)], pa.int64()),
    "int8": ([1, -3, 127, -128], pa.int8()),
    "int16": ([1, -3, 32767], pa.int16()),
    "uint8": ([1, 3, 255], pa.uint8()),
    "uint32": ([1, 3, 2 ** 32 - 1], pa.uint32()),
    "uint64": ([1, 3, 2 ** 64 - 1, 2 ** 63], pa.uint64()),
    "float32": ([0.1, -0.0, 1e20, float("nan"), float("inf"), 123456789.0,
                 1e-7], pa.float32()),
    "float64": ([0.1, -0.0, 1e20, float("nan"), float("-inf"), 1e16, 1e-5,
                 123456789012.5], pa.float64()),
    "bool": ([True, False, True, True], pa.bool_()),
}

CASES = {}
for codec in ("NONE", "SNAPPY", "GZIP"):
    for dictionary in (True, False):
        for version in ("1.0", "2.0"):
            name = f"{codec}-{'dict' if dictionary else 'plain'}-v{version}"
            CASES[name] = (
                _table(text=texts(), n=pa.array(np.arange(300))),
                dict(compression=codec, use_dictionary=dictionary,
                     data_page_version=version))
CASES["row_groups"] = (_table(text=texts(250, 1)), dict(
    compression="SNAPPY", row_group_size=60))
for version in ("1.0", "2.0"):
    CASES[f"pages-v{version}"] = (_table(text=texts(400, 2)), dict(
        compression="SNAPPY", use_dictionary=False, data_page_size=512,
        write_batch_size=16, data_page_version=version))
CASES["dictionary_fallback"] = (_table(text=pa.array(
    [f"text number {i}" for i in range(2000)])), dict(
    dictionary_pagesize_limit=1024, data_page_size=512))
CASES["no_rows"] = (_table(text=pa.array([], pa.string()),
                          n=pa.array([], pa.int64())), {})
CASES["required_strings"] = (_table(text=texts(100, 3, 0.0)), dict(
    compression="SNAPPY"))
for name, (values, typ) in TYPED.items():
    for nulls in (False, True):
        CASES[f"{name}-{'nulls' if nulls else 'dense'}"] = (
            _typed(values, typ, nulls), dict(compression="SNAPPY"))
for version in ("1.0", "2.0"):
    CASES[f"bool-rle-v{version}"] = (_typed([True, False] * 20, pa.bool_(),
                                            True), dict(
        use_dictionary=False, column_encoding={"c": "RLE"},
        data_page_version=version))
CASES["int64-dict-v2"] = (_typed(INTS * 5, pa.int64(), True), dict(
    data_page_version="2.0"))
# format version 1.0 (parquet-mr's v1 writer, Spark's and Hive's default)
# labels a dictionary page PLAIN_DICTIONARY, and stores uint32 as INT64
# with no annotation
for version in ("1.0", "2.0"):
    for codec in ("NONE", "SNAPPY", "GZIP"):
        CASES[f"format1-{codec}-dict-v{version}"] = (
            _table(text=texts(200, 5), n=pa.array(np.arange(200) % 7)),
            dict(version="1.0", compression=codec, use_dictionary=True,
                 data_page_version=version))
    for name in ("int32", "uint32", "float64", "bool"):
        values, typ = TYPED[name]
        CASES[f"format1-{name}-nulls-v{version}"] = (
            _typed(values * 3, typ, True), dict(
                version="1.0", use_dictionary=True,
                data_page_version=version))
# with no ARROW:schema a duration is an INT64 to pandas as to the reader
CASES["duration-no_arrow_schema"] = (_typed([1, 2, 3], pa.duration("s"),
                                            True), dict(store_schema=False))


@pytest.mark.parametrize("case", list(CASES))
def test_reader_equals_the_jax_harness(case, tmp_path):
    make, options = CASES[case]
    path = tmp_path / "texts.parquet"
    pq.write_table(make(), path, **options)
    meta = pq.read_metadata(path)
    column = meta.row_group(0).column(0)
    if "compression" in options:
        codec = options["compression"]
        assert column.compression == ("UNCOMPRESSED" if codec == "NONE"
                                      else codec)
    if options.get("use_dictionary") is False:
        assert "RLE_DICTIONARY" not in column.encodings
    if case.startswith("format1") and column.physical_type != "BOOLEAN":
        assert "PLAIN_DICTIONARY" in column.encodings
    if case.startswith("row_groups"):
        assert meta.num_row_groups == 5
    if case.startswith("pages"):
        assert data_pages(str(path)) > 10
    if case == "dictionary_fallback":
        assert {"PLAIN", "RLE_DICTIONARY"} <= set(column.encodings)
    got, want = both(tmp_path)
    assert got == want
    assert len(got) == meta.num_rows


@pytest.mark.parametrize("index", ["named", "unnamed", "range"])
def test_pandas_index_columns_are_left_out(index, tmp_path):
    """pandas stores a named or unnamed index as a column (last, here
    moved first) and a RangeIndex as a dict in `index_columns`;
    `iloc[:, 0]` is the first column that is not an index."""
    frame = pd.DataFrame({"n": pd.array([1, None, 3], dtype="Int64"),
                          "text": ["x", None, "naïve 🚀"]})
    if index == "named":
        frame.index = pd.Index([5, 6, 7], name="idx")
    elif index == "unnamed":
        frame.index = [5, 6, 7]
    table = pa.Table.from_pandas(frame)
    if index != "range":
        table = table.select([2, 0, 1])
    pq.write_table(table, tmp_path / "texts.parquet")
    got, want = both(tmp_path)
    assert got == want == ["1", "nan", "3"]   # a nullable Int64 stays int
    assert read_parquet_texts(str(tmp_path / "texts.parquet"), 1) == [
        "x", "nan", "naïve 🚀"]


def test_first_file_in_listdir_order_wins(tmp_path):
    pq.write_table(pa.table({"t": ["from parquet"]}), tmp_path / "a.parquet")
    (tmp_path / "b.csv").write_text("t\nfrom csv\n")
    got, want = both(tmp_path)
    assert got == want
    assert got[0] == ("from parquet" if os.listdir(tmp_path)[0] ==
                      "a.parquet" else "from csv")


# ---- the snappy decoder -------------------------------------------------

def _varint(n):
    out = bytearray()
    while n >= 0x80:
        out.append(n & 0x7F | 0x80)
        n >>= 7
    return bytes(out + bytes([n]))


def _hand_built():
    """A literal whose length takes 3 extra bytes, a 4-byte-offset copy
    reaching past 64 KB, a 4-byte-offset copy overlapping itself and a
    1-byte-offset one: Google's compressor never emits the 4-byte form."""
    lit = np.random.RandomState(4).bytes(70000)
    want = lit + lit[:64] + (lit[61:64] * 11)[:32] + b"z" * 12
    stream = (_varint(len(want))
              + bytes([62 << 2]) + (len(lit) - 1).to_bytes(3, "little") + lit
              + bytes([(64 - 1) << 2 | 3]) + (70064 - 64).to_bytes(
                  4, "little")
              + bytes([(32 - 1) << 2 | 3]) + (3).to_bytes(4, "little")
              + bytes([0]) + b"z"
              + bytes([(11 - 4) << 2 | 1, 1]))
    return stream, want


SNAPPY = {
    "empty": b"",
    "random": np.random.RandomState(0).bytes(5000),
    "repetitive": b"buy the dip " * 4000,
    "past_64KB": " ".join(t or "" for t in draw_texts(
        np.random.RandomState(1), 3000)).encode(),
}


@pytest.mark.parametrize("name", list(SNAPPY) + ["hand_built"])
def test_snappy_decoder(name):
    if name == "hand_built":
        stream, want = _hand_built()
    else:
        want = SNAPPY[name]
        stream = pa.compress(want, codec="snappy", asbytes=True)
    assert parquet.snappy_decompress(stream) == want
    if name == "past_64KB":
        assert len(want) > 65536


@pytest.mark.parametrize("stream", [
    _varint(4) + bytes([(4 - 1) << 2 | 3]) + (1).to_bytes(4, "little"),
    _varint(8) + bytes([0]) + b"a" + bytes([(4 - 4) << 2 | 1, 2]),
    _varint(5) + bytes([(3 - 1) << 2]) + b"abc",
    _varint(2) + bytes([(3 - 1) << 2]) + b"ab",
], ids=["copy_before_output", "offset_past_output", "short_of_preamble",
        "literal_cut_short"])
def test_snappy_refuses_a_bad_stream(stream):
    with pytest.raises(ValueError):
        parquet.snappy_decompress(stream)


@pytest.mark.parametrize("codec", [0, 1, 2])
def test_page_size_is_checked(codec):
    body = b"texts " * 50
    data = {0: body, 1: pa.compress(body, codec="snappy", asbytes=True),
            2: pa.compress(body, codec="gzip", asbytes=True)}[codec]
    assert parquet._decompress(codec, data, len(body), "p") == body
    with pytest.raises(ValueError, match="header says"):
        parquet._decompress(codec, data, len(body) + 1, "p")


# ---- refusals and malformed files -----------------------------------------

REFUSED = {
    "ZSTD": (_table(c=texts(20)), dict(compression="ZSTD")),
    "LZ4": (_table(c=texts(20)), dict(compression="LZ4")),
    "BROTLI": (_table(c=texts(20)), dict(compression="BROTLI")),
    "DELTA_BINARY_PACKED": (_typed(INTS, pa.int64(), False), dict(
        use_dictionary=False, column_encoding={"c": "DELTA_BINARY_PACKED"})),
    "DELTA_BYTE_ARRAY": (_table(c=texts(20)), dict(
        use_dictionary=False, column_encoding={"c": "DELTA_BYTE_ARRAY"})),
    "DELTA_LENGTH_BYTE_ARRAY": (_table(c=texts(20)), dict(
        use_dictionary=False,
        column_encoding={"c": "DELTA_LENGTH_BYTE_ARRAY"})),
    "BYTE_STREAM_SPLIT": (_typed([0.5, 1.5], pa.float64(), False), dict(
        use_dictionary=False, column_encoding={"c": "BYTE_STREAM_SPLIT"})),
    "nested": (_table(c=pa.array([[1], [2, 3]])), {}),
    "TIMESTAMP": (_typed([1, 2], pa.timestamp("ms"), False), {}),
    "DATE": (_typed([1, 2], pa.date32(), False), {}),
    "DECIMAL": (_table(c=pa.array([1, 2], pa.decimal128(5, 2))), {}),
    "INT96": (_typed([1, 2], pa.timestamp("ns"), False), dict(
        use_deprecated_int96_timestamps=True)),
    "FIXED_LEN_BYTE_ARRAY": (_table(c=pa.array([b"ab"], pa.binary(2))), {}),
    "string annotation": (_table(c=pa.array([b"ab"], pa.binary())), {}),
    "timedelta64": (lambda: pa.Table.from_pandas(pd.DataFrame(
        {"c": pd.to_timedelta([1, 2], unit="s")})), {}),
    # an un-annotated INT64 that only ARROW:schema names; pandas reads it
    # as timedelta64
    "Duration": (_typed([1, 2], pa.duration("s"), False), {}),
}


@pytest.mark.parametrize("name", list(REFUSED))
def test_refused_by_name(name, tmp_path):
    make, options = REFUSED[name]
    pq.write_table(make(), tmp_path / "texts.parquet", **options)
    with pytest.raises(NotImplementedError, match=name):
        pretrain_mlm.load_text(argparse.Namespace(data_dir=str(tmp_path)))


def test_arrow_schema_types(tmp_path):
    """The type of each field that `ARROW:schema` gives, whatever Parquet
    stores it as; metadata that is not an Arrow schema is a ValueError."""
    table = pa.table({"i": pa.array([1], pa.uint32()), "s": ["a"],
                      "b": [True], "f": [0.5],
                      "d": pa.array([1], pa.duration("s")),
                      "l": pa.array(["a"], pa.large_string()),
                      "c": pa.array(["a"]).dictionary_encode()})
    pq.write_table(table, tmp_path / "t.parquet")
    blob = pq.read_metadata(tmp_path / "t.parquet").metadata[b"ARROW:schema"]
    assert parquet._arrow_types(blob, "p") == [
        "Int", "Utf8", "Bool", "FloatingPoint", "Duration", "LargeUtf8",
        "Utf8"]
    with pytest.raises(ValueError, match="ARROW:schema"):
        parquet._arrow_types(b"bm90IGFuIGFycm93IHNjaGVtYQ==", "p")


def _malformed(kind, data):
    tail = int.from_bytes(data[-8:-4], "little") + 8
    return {"empty": b"",
            "magic": b"PAR2" + data[4:],
            "truncated": data[:len(data) // 2],
            "footer_length": data[:-8] + (len(data)).to_bytes(
                4, "little") + b"PAR1",
            "chunk_outside": data[:4] + data[-tail:]}[kind]


@pytest.mark.parametrize("kind", ["empty", "magic", "truncated",
                                  "footer_length", "chunk_outside"])
def test_malformed_files_raise_value_error(kind, tmp_path):
    path = tmp_path / "texts.parquet"
    pq.write_table(pa.table({"c": texts(50)}), path)
    path.write_bytes(_malformed(kind, path.read_bytes()))
    with pytest.raises(ValueError, match="texts.parquet"):
        read_parquet_texts(str(path))


# ---- the committed fixtures, mlm_arrays and the CLI -----------------------

with open(os.path.join(FIXTURES, "texts.json"), encoding="utf-8") as _f:
    FIXTURE_TEXTS = json.load(_f)


@pytest.mark.parametrize("name", list(FILES))
def test_fixture_equals_its_json_and_the_jax_harness(name):
    d = os.path.join(FIXTURES, name)
    rows, _, options = FILES[name]
    meta = pq.read_metadata(os.path.join(d, "texts.parquet"))
    assert meta.row_group(0).column(0).compression == options["compression"]
    assert meta.num_rows == rows
    assert meta.num_row_groups == -(-rows // options.get("row_group_size",
                                                         rows))
    got, want = both(d)
    assert got == want == FIXTURE_TEXTS[name]
    assert "nan" in got and "" in got


def test_mlm_arrays_from_a_parquet_equal_the_jax_harness(monkeypatch):
    """Text -> ids -> mask_tokens -> split from the CLI's fixture, as the
    JAX harness does it. Under pandas 3 the harness's texts keep a missing
    value as the float NaN, which its tokenizer cannot encode; the texts
    go in as str() makes them, a missing value "nan" as `read_csv_texts`
    reads one (pandas 2 gives "None" for a missing string)."""
    load_text = j_cli_mlm.load_text
    monkeypatch.setattr(j_cli_mlm, "load_text",
                        lambda args: [str(t) for t in load_text(args)])
    class Captured:
        params = None

        def __init__(self, p):
            type(self).params = p

        def train(self):
            return []

    monkeypatch.setattr(j_cli_mlm, "mlm_pretrainer", Captured)
    argv = ["-rid", "3", "--data_dir", os.path.join(FIXTURES,
                                                    "cli_snappy_96")] + WIDTHS
    j_cli_mlm.main(argv)
    args = base_parser().parse_args(argv)
    train, val = pretrain_mlm.split(
        pretrain_mlm.mlm_arrays(pretrain_mlm.load_text(args), args), 4)
    for name, got in (("train_data", train), ("val_data", val)):
        want = Captured.params[name].arrays
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_cli_pretrains_from_a_parquet(tmp_path):
    out = pretrain_mlm.main(["-rid", "0", "-ne", "1", "-fp", str(tmp_path),
                             "--data_dir", os.path.join(
                                 FIXTURES, "cli_snappy_96")] + WIDTHS + CPU)
    trainer = out["trainer"]
    assert trainer.optimizer.step_count == len(trainer.train_data) > 0
    assert all(np.isfinite(h["train_loss"]) and np.isfinite(h["val_loss"])
               for h in out["history"])
    assert os.path.isfile(out["checkpoint"])
