"""Network-bound fetchers (counterpart of
meant_tpu/data_engineering/fetchers.py): `meant_data/twitter.py:43-64`
(snscrape tweet scraping) and `meant_data/av.py:36-62` (AlphaVantage daily
prices). Both need the network and an optional library, imported where it
is used; everything downstream consumes their file outputs.
"""

from __future__ import annotations

import json
import os
import time
from typing import Iterable


def scrape_tweets(ticker: str, dates: Iterable[str], out_dir: str,
                  per_day: int = 10) -> None:
    """$TICKER cashtag search, `per_day` tweets/day -> one JSON-lines file
    per date (`meant_data/twitter.py:43-64`)."""
    try:
        import snscrape.modules.twitter as sntwitter
    except ImportError as e:
        raise RuntimeError(
            "snscrape is not installed in this environment; run the scraper "
            "where it is available — downstream consumes its JSON files"
        ) from e
    os.makedirs(os.path.join(out_dir, ticker), exist_ok=True)
    for date in dates:
        path = os.path.join(out_dir, ticker, f"{date}.json")
        query = f"${ticker} since:{date} until:{date} lang:en"
        rows = []
        for i, tweet in enumerate(
                sntwitter.TwitterSearchScraper(query).get_items()):
            if i >= per_day:
                break
            rows.append({"date": str(tweet.date), "text": tweet.content})
        with open(path, "w", encoding="utf-8") as f:
            for r in rows:
                f.write(json.dumps(r) + "\n")


def fetch_daily_prices(tickers: Iterable[str], api_key: str, out_dir: str,
                       sleep_s: float = 13.0) -> None:
    """AlphaVantage TIME_SERIES_DAILY_ADJUSTED per ticker -> per-day 5-vec
    [open, high, low, adj_close, volume] .npy
    (`meant_data/av.py:36-62`, incl. the 13s rate-limit sleep)."""
    try:
        import requests
    except ImportError as e:
        raise RuntimeError("requests unavailable") from e
    import numpy as np
    os.makedirs(out_dir, exist_ok=True)
    for ticker in tickers:
        url = ("https://www.alphavantage.co/query?function="
               f"TIME_SERIES_DAILY_ADJUSTED&symbol={ticker}"
               f"&outputsize=full&apikey={api_key}")
        data = requests.get(url, timeout=60).json()
        series = data.get("Time Series (Daily)", {})
        dates = sorted(series)
        rows = np.array(
            [[float(series[d]["1. open"]), float(series[d]["2. high"]),
              float(series[d]["3. low"]),
              float(series[d]["5. adjusted close"]),
              float(series[d]["6. volume"])] for d in dates], np.float32)
        np.save(os.path.join(out_dir, f"{ticker}.npy"), rows)
        np.save(os.path.join(out_dir, f"{ticker}_dates.npy"),
                np.asarray(dates))
        time.sleep(sleep_s)
