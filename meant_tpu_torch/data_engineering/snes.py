"""djiaNews preparation (counterpart of meant_tpu/data_engineering/snes.py;
the reference's `src/snes.py:7-59`), with the `csv` module in place of
pandas.

Merges Combined_News_DJIA with the DJIA price table on `Date`, labels
each day by the next day's movement ratio (>= +0.55% -> 1, <= -0.5% -> 0,
else no label, and the row is dropped) and adds 5-day shifted columns
(suffix `_{4-i}`: day 4 is the target day). A table is (columns, rows),
the rows mappings of column name to the cell's text; a missing cell
(pandas' missing-value strings) is None, and a row with any missing cell
is dropped, as `dropna` drops it. The output `.csv` parses to JAX's
values; a number keeps the text it was read with (JAX writes it back as
a float: "0" where JAX writes "0.0").
"""

from __future__ import annotations

import csv
from typing import List, Sequence, Tuple

from meant_tpu_torch.data.datasets import _CSV_NA

HIGH_RATIO = 0.0055
LOW_RATIO = -0.005
LAG = 5

Table = Tuple[List[str], List[dict]]


def read_table(path: str) -> Table:
    """A `.csv` with a header row as (columns, rows)."""
    with open(path, newline="", encoding="utf-8") as f:
        records = [r for r in csv.reader(f) if r]
    columns = records[0]
    rows = [{c: (None if v in _CSV_NA else v)
             for c, v in zip(columns, r + [""] * (len(columns) - len(r)))}
            for r in records[1:]]
    return columns, rows


def write_table(table: Table, path: str) -> None:
    columns, rows = table
    with open(path, "w", newline="", encoding="utf-8") as f:
        out = csv.writer(f, lineterminator="\n")
        out.writerow(columns)
        for row in rows:
            out.writerow(["" if row[c] is None else row[c] for c in columns])


def merge_on_date(left: Table, right: Table) -> Table:
    """`pd.merge(left, right, on="Date", how="inner")`: left's order, each
    left row once for each right row of its date, in right's order."""
    by_date = {}
    for row in right[1]:
        by_date.setdefault(row["Date"], []).append(row)
    columns = left[0] + [c for c in right[0] if c != "Date"]
    rows = [{**lr, **rr} for lr in left[1]
            for rr in by_date.get(lr["Date"], ())]
    return columns, rows


def movement_labels(table: Table, close_col: str = "Adj Close",
                    high_ratio: float = HIGH_RATIO,
                    low_ratio: float = LOW_RATIO) -> Table:
    """Adds `djia_label` from the NEXT day's close against today's
    (`src/snes.py:23-37`); None where the ratio is between the bounds and
    on the last day."""
    columns, rows = table
    closes = [float("nan") if r[close_col] is None else float(r[close_col])
              for r in rows]
    out = []
    for i, row in enumerate(rows):
        label = None
        if i + 1 < len(rows):
            ratio = (closes[i + 1] - closes[i]) / closes[i]
            if ratio >= high_ratio:
                label = "1"
            elif ratio <= low_ratio:
                label = "0"
        out.append({**row, "djia_label": label})
    return columns + ["djia_label"], out


def add_lag_shifts(table: Table, lag: int = LAG,
                   keep: Sequence[str] = ("Date", "djia_label")) -> Table:
    """The kept columns, every other column (but `label`) shifted by i
    days with the suffix `_{lag-1-i}` for i = 0..lag-1, then `Date` shifted
    as `aux_date_{lag-1-i}`; rows with a missing cell dropped
    (`src/snes.py:41-57`)."""
    columns, rows = table
    cols = [c for c in columns if c not in set(keep) | {"label"}]
    out_cols = list(keep)
    for i in range(lag):
        out_cols += [f"{c}_{lag - 1 - i}" for c in cols]
    out_cols += [f"aux_date_{lag - 1 - i}" for i in range(lag)]
    out = []
    for t, row in enumerate(rows):
        new = {c: row[c] for c in keep}
        for i in range(lag):
            src = rows[t - i] if t - i >= 0 else {}
            for c in cols:
                new[f"{c}_{lag - 1 - i}"] = src.get(c)
        for i in range(lag):
            src = rows[t - i] if t - i >= 0 else {}
            new[f"aux_date_{lag - 1 - i}"] = src.get("Date")
        if all(v is not None for v in new.values()):
            out.append(new)
    return out_cols, out


def prepare(news_csv: str, price_csv: str, out_csv: str) -> Table:
    merged = merge_on_date(read_table(news_csv), read_table(price_csv))
    result = add_lag_shifts(movement_labels(merged))
    write_table(result, out_csv)
    return result
