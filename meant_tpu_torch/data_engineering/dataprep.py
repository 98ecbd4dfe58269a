"""Tweet tokenization (counterpart of
meant_tpu/data_engineering/dataprep.py; the reference's `dataprep.py:24-64`).

Each day's tweets are [SEP]-joined, then tokenized into fixed rows of
`max_len` ids. The JAX package tokenizes with an HF AutoTokenizer where
`transformers` and a local cache are at hand; the port reads no HF
tokenizer, so a given `hf_name` prints JAX's fallback notice and the
FNV hash tokenizer (`native.fnv1a_tokenize`) runs, as it does in JAX on
a machine without `transformers`.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from meant_tpu_torch import native


def make_tokenizer(hf_name: Optional[str] = None, max_len: int = 128,
                   vocab: int = 64001):
    """texts -> (ids (n, max_len) int32, mask (n, max_len) f32)."""
    if hf_name:
        print(f"[dataprep] HF tokenizer unavailable (the port reads no HF "
              f"tokenizer: {hf_name}); falling back to FNV tokenizer")

    def encode(texts: List[str]):
        return native.fnv1a_tokenize(texts, max_len, vocab)

    return encode


def join_daily_tweets(tweets_by_day: Dict[str, List[str]]) -> Dict[str, str]:
    """[SEP]-join each day's tweets (`dataprep.py:40-48`)."""
    return {d: " [SEP] ".join(t) for d, t in tweets_by_day.items()}


def prepare_ticker(tweets_by_day: Dict[str, List[str]], out_path: str,
                   hf_name: Optional[str] = None, max_len: int = 128):
    """Tokenize one ticker's daily tweets to a (days, max_len) array and
    mask, saved as .npz with the sorted dates."""
    joined = join_daily_tweets(tweets_by_day)
    dates = sorted(joined)
    encode = make_tokenizer(hf_name, max_len)
    ids, mask = encode([joined[d] for d in dates])
    np.savez(out_path, input_ids=ids, attention_mask=mask,
             dates=np.asarray(dates))
    return ids, mask, dates
