"""Stocknet preparation (counterpart of
meant_tpu/data_engineering/stocknet_prep.py; the reference's
`src/stocknet_data.py:4-44`), with the `csv` module in place of pandas.

Per-ticker directories of per-day JSON-lines tweets -> one CSV per ticker
with a [SEP]-joined daily text column. Language filtering uses langdetect
where it is installed (the reference's behaviour); otherwise every tweet
is kept and a note is printed.
"""

from __future__ import annotations

import csv
import json
import os
from typing import List, Optional

try:
    from langdetect import detect
    from langdetect.lang_detect_exception import LangDetectException
    _HAS_LANGDETECT = True
except ImportError:
    _HAS_LANGDETECT = False


def _keep(text: str) -> bool:
    if not _HAS_LANGDETECT:
        return True
    try:
        return detect(text) == "en"
    except LangDetectException:
        return False


def daily_text_rows(ticker_dir: str) -> List[dict]:
    """One row per day, {'date', 'text'}, the day's tweets [SEP]-joined
    (`src/stocknet_data.py:14-37`)."""
    data = []
    for filename in sorted(os.listdir(ticker_dir)):
        if not filename.endswith(".json"):
            continue
        date = filename.split(".")[0]
        combined = ""
        with open(os.path.join(ticker_dir, filename), encoding="utf-8") as f:
            for line in f:
                try:
                    entry = json.loads(line.strip())
                except json.JSONDecodeError:
                    continue
                text = str(entry.get("text", "")).replace("\n", " ")
                if text and _keep(text):
                    combined += text + " [SEP] "
        if combined.strip():
            data.append({"date": date, "text": combined.strip()})
    return data


def write_rows(rows: List[dict], path: str) -> None:
    """`pd.DataFrame(rows).to_csv(path, index=False)`: a header and one
    line a row; no rows writes an empty line, as pandas does."""
    with open(path, "w", newline="", encoding="utf-8") as f:
        if not rows:
            f.write("\n")
            return
        out = csv.writer(f, lineterminator="\n")
        out.writerow(list(rows[0]))
        for row in rows:
            out.writerow(list(row.values()))


def prepare(tweets_root: str, out_dir: str,
            tickers: Optional[list] = None) -> None:
    os.makedirs(out_dir, exist_ok=True)
    if not _HAS_LANGDETECT:
        print("[stocknet_prep] langdetect unavailable: keeping all tweets")
    tickers = tickers or sorted(os.listdir(tweets_root))
    for ticker in tickers:
        out_csv = os.path.join(out_dir, f"{ticker}_clean.csv")
        if os.path.exists(out_csv):
            print("Clean tweet file already exists")
            continue
        write_rows(daily_text_rows(os.path.join(tweets_root, ticker)),
                   out_csv)
