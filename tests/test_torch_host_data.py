"""The port's host data path against the JAX package, on the CPU: the
threaded Prefetcher (order kept, a worker's error re-raised), background
checkpoint writes (a snapshot taken before save returns, restore waiting,
a bad path printed and the results kept), the frame converters and
`read_csv_chunk` (the standard library against pandas, with the
reference's off-by-one), `data/macd.py`, `data/smote.py` and the
`data_engineering` preps on the same small files. Exact where the
arithmetic is the same numpy code; the `.csv` outputs compared as pandas
parses them."""

import importlib
import math
import os
import pickle
import threading
import time

import numpy as np
import pandas as pd
import pytest
import torch

from meant_tpu.data import datasets as j_datasets
from meant_tpu.data import macd as j_macd
from meant_tpu.data_engineering import dataprep as j_dataprep
from meant_tpu.data_engineering import image_prep as j_image_prep
from meant_tpu.data_engineering import mosi_prep as j_mosi_prep
from meant_tpu.data_engineering import prepare_vqa as j_prepare_vqa
from meant_tpu.data_engineering import snes as j_snes
from meant_tpu.data_engineering import stocknet_prep as j_stocknet_prep
from meant_tpu_torch.cli.common import base_parser, build_model
from meant_tpu_torch.data import datasets, macd, smote
from meant_tpu_torch.data.loader import ArrayLoader, Prefetcher
from meant_tpu_torch.data_engineering import (dataprep, image_prep,
                                              mosi_prep, prepare_vqa, snes,
                                              stocknet_prep)
from meant_tpu_torch.train import checkpoint as ckpt
from meant_tpu_torch.train.classify import meant_trainer

import torch_threads

torch_threads.share_cores()

# meant_tpu.data's __init__ binds the name `smote` to the function
j_smote = importlib.import_module("meant_tpu.data.smote")

# ---- Prefetcher(workers>1) ------------------------------------------------


class _SlowFirst:
    """A loader whose first batch takes longest to assemble, so a pool of
    workers finishes the batches out of order."""

    def __init__(self, n=12, fail_at=None):
        self.n, self.fail_at = n, fail_at

    def __len__(self):
        return self.n

    def __iter__(self):
        for i in range(self.n):
            if i == self.fail_at:
                yield {"x": np.array(["not a number"], dtype=object)}
            else:
                yield {"x": np.full((2, 3), i, np.float32),
                       "delay": np.float32(0.05 if i % 3 == 0 else 0.0)}


@pytest.mark.parametrize("workers", [1, 3])
def test_prefetcher_workers_keep_order(workers, monkeypatch):
    stage, threads = Prefetcher._stage, set()

    def slow_stage(self, batch, i=0):
        threads.add(threading.get_ident())
        time.sleep(float(batch["delay"]))
        return stage(self, batch, i)

    monkeypatch.setattr(Prefetcher, "_stage", slow_stage)
    got = [int(b["x"][0, 0]) for b in Prefetcher(_SlowFirst(), "cpu",
                                                 workers=workers)]
    assert got == list(range(12))
    assert len(threads) == workers


class _BrokenLoader(_SlowFirst):
    """A loader that raises while drawing its fifth batch."""

    def __iter__(self):
        for i, batch in enumerate(super().__iter__()):
            if i == 4:
                raise OSError("corrupt read")
            yield batch


@pytest.mark.parametrize("loader,error", [(_SlowFirst(fail_at=4), TypeError),
                                          (_BrokenLoader(), OSError)],
                         ids=["in_a_stage", "in_the_loader"])
def test_prefetcher_workers_reraise_an_error_in_order(loader, error):
    """The batches before the failing one arrive, then its error."""
    got = []
    with pytest.raises(error):
        for b in Prefetcher(loader, "cpu", workers=3):
            got.append(int(b["x"][0, 0]))
    assert got == [0, 1, 2, 3]


# ---- background checkpoint writes -----------------------------------------

def test_background_save_snapshots_before_returning(tmp_path, monkeypatch):
    """save(block=False) then an in-place change: the file holds the
    values of before it. The write is held back 0.2 s, so `restore` must
    wait for it."""
    write = ckpt._write
    monkeypatch.setattr(ckpt, "_write",
                        lambda p, t: (time.sleep(0.2), write(p, t)))
    w = torch.arange(6.0)
    m = {"m": torch.ones(3), "step": 4}
    path = str(tmp_path / "a" / "ckpt")
    ckpt.save(path, {"params": {"w": w}, "opt_state": m}, block=False,
              lane="params")
    ckpt.save(path + "_opt", m, block=False, lane="opt")
    assert not os.path.exists(path)
    w.add_(100.0)
    m["m"].mul_(0.0)
    got = ckpt.restore(path)
    assert torch.equal(got["params"]["w"], torch.arange(6.0))
    assert torch.equal(got["opt_state"]["m"], torch.ones(3))
    assert ckpt.restore(path + "_opt")["step"] == 4


def test_wait_for_saves_raises_a_failed_write(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("")
    ckpt.save(str(blocker / "sub" / "ckpt"), {"w": torch.ones(2)},
              block=False)
    with pytest.raises(OSError):
        ckpt.wait_for_saves()
    ckpt.wait_for_saves()          # the failure is reported once


TINY = ["-mn", "meant_src", "-nec", "1", "--synthetic_n", "20",
        "--seq_len", "12", "--image_size", "32", "--text_dim", "32",
        "--image_dim", "32", "--vocab_size", "128", "--num_heads", "4",
        "--device", "cpu", "-rid", "bad"]


def test_trainer_keeps_its_results_when_the_save_fails(tmp_path, capsys):
    """A file where the checkpoint directory should be: the background
    write fails, train() prints the reference's line and keeps the
    history and the test metrics (meant_tpu/train/classify.py:317-323)."""
    from meant_tpu_torch.cli.common import synthetic_batch
    args = base_parser().parse_args(TINY)
    rows = synthetic_batch(args, 8)
    blocker = tmp_path / "file"
    blocker.write_text("")
    trainer = meant_trainer({
        "model": build_model(args), "model_name": "meant_src",
        "train_loader": ArrayLoader(rows, 4),
        "test_loader": ArrayLoader(rows, 4, drop_remainder=False),
        "epochs": 1, "file_path": str(blocker / "out")})
    results = trainer.train()
    assert "Your filepath is invalid. Save has failed" in \
        capsys.readouterr().out
    assert results["checkpoint"] is None
    assert len(results["history"]) == 1 and "f1_macro" in results["test"]


# ---- the frame converters and read_csv_chunk ------------------------------

def _frame(n=6, lag=5, seed=0):
    rng = np.random.RandomState(seed)
    words = ["up", "down", "$AAPL", "moon", "bear", "bull", "a\tb"]
    rows = []
    for i in range(n):
        row = {"label": int(rng.randint(0, 2))}
        for d in range(lag):
            row[f"text_{d}"] = " ".join(rng.choice(words, rng.randint(0, 9)))
            for col in datasets.TEMPSTOCK_PRICE_COLS:
                row[f"{col}_{d}"] = float(rng.randn())
            for col in ("high", "low", "close"):
                if (i + d) % 4:
                    row[f"{col}_{d}"] = float(rng.randn())
            for k in range(1, 26):
                if (i + k + d) % 7:
                    row[f"Top{k}_{d}"] = f"headline {k} {rng.choice(words)}"
        rows.append(row)
    return pd.DataFrame(rows)


def _assert_same_arrays(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("as_records", [False, True],
                         ids=["dataframe", "row_mappings"])
def test_frame_converters_match_jax(as_records):
    df = _frame()
    frame = df.to_dict("records") if as_records else df
    tok, j_tok = datasets.hash_tokenize(500, 16), j_datasets.hash_tokenize(
        500, 16)
    graphs = np.random.RandomState(1).rand(len(df), 5, 3, 8, 8)
    _assert_same_arrays(
        datasets.tempstock_large_from_frame(frame, graphs, tok, max_len=12),
        j_datasets.tempstock_large_from_frame(df, graphs, j_tok,
                                              max_len=12))
    _assert_same_arrays(
        datasets.stocknet_from_frame(frame, tok, max_len=10),
        j_datasets.stocknet_from_frame(df, j_tok, max_len=10))
    _assert_same_arrays(datasets.djia_from_frame(frame, tok, max_len=40),
                        j_datasets.djia_from_frame(df, j_tok, max_len=40))


CSV_TEXT = ('first\nsecond line\n\n"quoted, comma"\nNA\n\r\nlast\r\nx\n'
            '"multi\nline"\ny\n  \n"a""b"\n"NA"\n""\n"x"y\nnull\n\t\nend')


def test_read_csv_chunk_matches_pandas_with_the_off_by_one(tmp_path):
    path = tmp_path / "texts.csv"
    path.write_text(CSV_TEXT)
    norm = lambda v: "NaN" if isinstance(v, float) and math.isnan(v) else v
    for start in range(0, 18, 2):
        for end in range(start + 1, 22, 3):
            want = j_datasets.read_csv_chunk(str(path), start, end)
            got = datasets.read_csv_chunk(str(path), start, end)
            assert [norm(r["text"]) for r in got] == \
                [norm(v) for v in want["text"].tolist()], (start, end)
    assert len(datasets.read_csv_chunk(str(path), 0, 3)) == 2
    with pytest.raises(ValueError):
        datasets.read_csv_chunk(str(path), 5, 4)


def test_clean_bad_vqa_and_filter_arrays_match_jax():
    records = [{"label": {"ids": [1], "weights": [1.0]}},
               {"label": {"ids": [], "weights": []}},
               {"answers": {"yes": 3}}, {"answers": {}},
               {"label": {"ids": [2], "weights": []}}]
    got = datasets.clean_bad_vqa(records)
    assert got == j_datasets.clean_bad_vqa(records) == ([1, 3, 4], [0, 2])
    arrays = {"a": np.arange(10).reshape(5, 2), "b": np.arange(5)}
    _assert_same_arrays(datasets.filter_arrays(arrays, got[1]),
                        j_datasets.filter_arrays(arrays, got[1]))
    assert datasets.filter_arrays(records, got[1]) == \
        j_datasets.filter_arrays(records, got[1])


# ---- macd and smote -------------------------------------------------------

def test_macd_matches_jax():
    close = 100 + np.cumsum(np.random.RandomState(2).randn(80))
    close[10:13] = close[9]                      # flat days: no gain or loss
    for got, want in zip(macd.macd_signal(close), j_macd.macd_signal(close)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(macd.ema(close, 9), j_macd.ema(close, 9))
    np.testing.assert_array_equal(macd.rsi(close), j_macd.rsi(close))
    m, s, _ = j_macd.macd_signal(close)
    for got, want in zip(macd.crossover_labels(m, s),
                         j_macd.crossover_labels(m, s)):
        np.testing.assert_array_equal(got, want)
    feats = macd.tempstock_price_features(close)
    np.testing.assert_array_equal(feats,
                                  j_macd.tempstock_price_features(close))
    labels = np.eye(2)[np.arange(80) % 2]
    for lag in (5, 80):
        for got, want in zip(macd.lag_windows(feats, labels, lag),
                             j_macd.lag_windows(feats, labels, lag)):
            assert got.shape == want.shape
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 42])
def test_smote_matches_jax(seed):
    rng = np.random.RandomState(seed)
    g = rng.rand(14, 5, 2, 4, 4).astype(np.float32)
    t = rng.randint(0, 50, (14, 5, 6)).astype(np.float32)
    m = rng.randn(14, 5, 4).astype(np.float32)
    y = np.array([0] * 10 + [1] * 4)
    for got, want in zip(smote.smote_lag_windows(g, t, m, y, seed=seed),
                         j_smote.smote_lag_windows(g, t, m, y, seed=seed)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    X = rng.randn(9, 3)
    for labels in (np.array([0] * 8 + [1]), np.array([0, 1] * 4 + [0])):
        for got, want in zip(smote.smote(X, labels), j_smote.smote(X,
                                                                   labels)):
            np.testing.assert_array_equal(got, want)


# ---- data_engineering -----------------------------------------------------

def test_dataprep_matches_jax(tmp_path, capsys):
    tweets = {"2020-01-03": ["up\tand away", "moon"], "2020-01-02": ["bear"],
              "2020-01-06": []}
    got = dataprep.prepare_ticker(tweets, str(tmp_path / "p.npz"),
                                  max_len=16)
    want = j_dataprep.prepare_ticker(tweets, str(tmp_path / "j.npz"),
                                     max_len=16)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    p, j = np.load(tmp_path / "p.npz"), np.load(tmp_path / "j.npz")
    for k in j.files:
        np.testing.assert_array_equal(p[k], j[k])
    dataprep.make_tokenizer("vinai/bertweet-base")
    assert "falling back to FNV tokenizer" in capsys.readouterr().out


def test_image_prep_matches_jax(tmp_path):
    from PIL import Image
    graphs, tweets = tmp_path / "graphs", tmp_path / "tweets"
    graphs.mkdir()
    tweets.mkdir()
    rng = np.random.RandomState(3)
    for i, date in enumerate(("2020-01-02", "2020-01-03", "2020-01-06")):
        (tweets / f"{date}.json").write_text("")
        if i != 1:                   # a tweet day without a chart
            Image.fromarray(rng.randint(0, 255, (20 + i, 30, 3)).astype(
                np.uint8)).save(graphs / f"{date}.png")
    got = image_prep.prepare_ticker(str(graphs), str(tweets),
                                    str(tmp_path / "p.npy"), size=16)
    assert got.shape == (2, 3, 16, 16)
    want = j_image_prep.prepare_ticker(str(graphs), str(tweets),
                                       str(tmp_path / "j.npy"), size=16)
    np.testing.assert_array_equal(got, want)
    assert image_prep.align_dates({"a": 1, "b": 2}, {"b"}) == \
        j_image_prep.align_dates({"a": 1, "b": 2}, {"b"})


def test_mosi_prep_matches_jax(tmp_path):
    rng = np.random.RandomState(4)
    split = {"raw_text": ["good", " ", "bad", ""],
             "text": rng.randn(4, 6, 8), "vision": rng.randn(4, 6, 20),
             "audio": rng.randn(4, 6, 5), "labels": rng.randn(4, 1),
             "meta": "kept as it is"}
    path = tmp_path / "aligned_50.pkl"
    with open(path, "wb") as f:
        pickle.dump({"train": split, "test": split}, f)
    got, want = mosi_prep.load_aligned(str(path)), j_mosi_prep.load_aligned(
        str(path))
    for name in ("train", "test"):
        assert got[name]["meta"] == want[name]["meta"] == "kept as it is"
        _assert_same_arrays(mosi_prep.to_arrays(got[name]),
                            j_mosi_prep.to_arrays(want[name]))


def test_prepare_vqa_matches_jax(tmp_path, capsys):
    import json
    from PIL import Image
    images = tmp_path / "images"
    images.mkdir()
    rng = np.random.RandomState(5)
    questions, annotations = [], []
    for i, image_id in enumerate((7, 8, 9)):
        Image.fromarray(rng.randint(0, 255, (12 + i, 10, 3)).astype(
            np.uint8)).save(images / f"COCO_train2014_{image_id:012d}.jpg")
        questions.append({"question_id": 100 + i, "question": f"what {i}?"})
        answers = [] if i == 1 else [{"answer": a} for a in
                                     ("yes", "yes", "no")[: i + 1]]
        annotations.append({"question_id": 100 + i, "image_id": image_id,
                            "answers": answers,
                            "multiple_choice_answer": "yes"})
    (tmp_path / "q.json").write_text(json.dumps({"questions": questions}))
    (tmp_path / "a.json").write_text(json.dumps(
        {"annotations": annotations}))
    args = (str(tmp_path / "q.json"), str(tmp_path / "a.json"), str(images))
    records = prepare_vqa.extract_records(*args)
    assert records == j_prepare_vqa.extract_records(*args)
    tok = datasets.hash_tokenize(300, 8)
    got = prepare_vqa.prepare(records, tok, str(tmp_path / "p.npz"), 8, 16,
                              16)
    want = j_prepare_vqa.prepare(records, j_datasets.hash_tokenize(300, 8),
                                 str(tmp_path / "j.npz"), 8, 16, 16)
    assert got == want
    p, j = np.load(tmp_path / "p.npz"), np.load(tmp_path / "j.npz")
    assert p.files == j.files
    for k in j.files:
        np.testing.assert_array_equal(p[k], j[k], err_msg=k)
    assert "Rows removed: 1" in capsys.readouterr().out


def test_snes_matches_jax(tmp_path):
    import csv
    rng = np.random.RandomState(6)
    dates = [f"2008-09-{d:02d}" for d in range(1, 25)]
    with open(tmp_path / "news.csv", "w", newline="") as f:
        out = csv.writer(f)
        out.writerow(["Date", "Label"] + [f"Top{k}" for k in range(1, 26)])
        for i, d in enumerate(dates):
            tops = [f'b"news {i} {k}, quoted"' for k in range(1, 26)]
            tops[3] = "" if i == 9 else tops[3]
            out.writerow([d, rng.randint(0, 2)] + tops)
    with open(tmp_path / "price.csv", "w", newline="") as f:
        out = csv.writer(f)
        out.writerow(["Date", "Open", "Adj Close", "Volume"])
        close = 11000.0
        for i, d in enumerate(dates[::-1]):
            close *= 1 + rng.randn() * 0.01
            if i != 5:
                out.writerow([d, f"{close:.6f}", f"{close:.6f}",
                              rng.randint(10 ** 6, 10 ** 8)])
    args = (str(tmp_path / "news.csv"), str(tmp_path / "price.csv"))
    snes.prepare(*args, str(tmp_path / "p.csv"))
    j_snes.prepare(*args, str(tmp_path / "j.csv"))
    got, want = pd.read_csv(tmp_path / "p.csv"), pd.read_csv(
        tmp_path / "j.csv")
    assert len(want) > 3 and list(got.columns) == list(want.columns)
    pd.testing.assert_frame_equal(got, want, check_dtype=False)


def test_stocknet_prep_matches_jax(tmp_path):
    import json
    root = tmp_path / "tweets"
    for ticker, days in (("AAPL", 3), ("MSFT", 0)):
        (root / ticker).mkdir(parents=True)
        for d in range(days):
            lines = [json.dumps({"text": f"tweet {d} {i}, with\nnewline"})
                     for i in range(d + 1)] + ["not json"]
            (root / ticker / f"2014-01-0{d + 1}.json").write_text(
                "\n".join(lines))
        (root / ticker / "notes.txt").write_text("skipped")
    stocknet_prep.prepare(str(root), str(tmp_path / "p"))
    j_stocknet_prep.prepare(str(root), str(tmp_path / "j"))
    for ticker in ("AAPL", "MSFT"):
        name = f"{ticker}_clean.csv"
        assert (tmp_path / "p" / name).read_text() == \
            (tmp_path / "j" / name).read_text()
