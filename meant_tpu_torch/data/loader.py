"""Batch loaders and host-to-device prefetch (counterpart of
meant_tpu/data/loader.py `ArrayLoader`, `BucketedLoader` and
`Prefetcher`).

Train batches drop the remainder; eval batches are padded to the batch
size and carry a `_weight` vector (1 for real rows, 0 for padding) so
padding never enters the metrics. `BucketedLoader` draws each batch from
one length bucket and cuts the sequence arrays to the bucket's length.
"""

from __future__ import annotations

import queue
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator

import numpy as np
import torch


class ArrayLoader:
    def __init__(self, arrays: Dict[str, np.ndarray], batch_size: int,
                 shuffle: bool = False, seed: int = 0,
                 drop_remainder: bool = True):
        sizes = {k: len(v) for k, v in arrays.items()}
        if len(set(sizes.values())) != 1:
            raise ValueError(f"ragged arrays: {sizes}")
        self.arrays = arrays
        self.n = next(iter(sizes.values()))
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_remainder = drop_remainder
        self.rng = np.random.RandomState(seed)

    def __len__(self):
        if self.drop_remainder:
            return self.n // self.batch_size
        return (self.n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        idx = np.arange(self.n)
        if self.shuffle:
            self.rng.shuffle(idx)
        bs = self.batch_size
        num_full = self.n // bs
        for i in range(num_full):
            sel = idx[i * bs:(i + 1) * bs]
            batch = {k: v[sel] for k, v in self.arrays.items()}
            batch["_weight"] = np.ones((bs,), np.float32)
            yield batch
        rem = self.n - num_full * bs
        if rem and not self.drop_remainder:
            sel = idx[num_full * bs:]
            pad = bs - rem
            batch = {}
            for k, v in self.arrays.items():
                tail = v[sel]
                batch[k] = np.concatenate(
                    [tail, np.repeat(tail[:1], pad, axis=0)], axis=0)
            w = np.zeros((bs,), np.float32)
            w[:rem] = 1.0
            batch["_weight"] = w
            yield batch


def host_tensor(v) -> torch.Tensor:
    """A numpy batch array as a CPU tensor; integer arrays become int64
    (token ids index embeddings, labels index log-probabilities)."""
    t = torch.from_numpy(np.ascontiguousarray(v))
    return t.to(torch.int64) if not t.is_floating_point() else t


class BucketedLoader:
    """Length-bucketed batches: each row goes to the smallest bucket that
    holds its content length (the largest day's count of ones in
    `length_key`, a (n, lag, s) {0, 1} mask), each batch comes from one
    bucket, and the arrays named in `seq_keys` are cut to the bucket's
    length. Buckets past s_max are dropped and s_max is added if missing.
    `bucket_batches` maps a bucket to its own batch size (others take
    `batch_size`); a key that is no bucket, or a size not divisible by
    `batch_divisor`, raises ValueError. With `shuffle`, one
    RandomState(seed) shuffles each bucket's rows in bucket order and
    then the plan of batches, so the batches and their order are the JAX
    package's at every seed."""

    def __init__(self, arrays: Dict[str, np.ndarray], batch_size: int,
                 seq_keys=("input_ids", "tweets", "attention_masks"),
                 length_key: str = "attention_masks",
                 buckets=(128, 256, 384, 512), shuffle: bool = False,
                 seed: int = 0, bucket_batches: Dict[int, int] = None,
                 batch_divisor: int = 1):
        sizes = {k: len(v) for k, v in arrays.items()}
        if len(set(sizes.values())) != 1:
            raise ValueError(f"ragged arrays: {sizes}")
        self.arrays = arrays
        self.batch_size = batch_size
        self.bucket_batches = dict(bucket_batches or {})
        self.seq_keys = [k for k in seq_keys if k in arrays]
        self.shuffle = shuffle
        self.rng = np.random.RandomState(seed)
        mask = arrays[length_key]
        lengths = mask.reshape(mask.shape[0], -1, mask.shape[-1]) \
            .sum(-1).max(-1)
        s_max = mask.shape[-1]
        self.buckets = sorted(min(b, s_max) for b in buckets
                              if b <= s_max) or [s_max]
        if self.buckets[-1] < s_max:
            self.buckets.append(s_max)
        edges = np.asarray(self.buckets)
        self.assignment = edges[np.searchsorted(
            edges, lengths, side="left").clip(0, len(edges) - 1)]
        self.index = {b: np.flatnonzero(self.assignment == b)
                      for b in self.buckets}
        stray = set(self.bucket_batches) - set(self.buckets)
        if stray:
            raise ValueError(
                f"bucket_batches keys {sorted(stray)} are not buckets "
                f"(buckets resolved to {self.buckets})")
        bad = {b: self._bucket_bs(b) for b in self.buckets
               if self._bucket_bs(b) % max(int(batch_divisor), 1)}
        if bad:
            raise ValueError(
                f"per-bucket batch sizes {bad} are not divisible by the "
                f"data-axis size {batch_divisor}")

    def _bucket_bs(self, bucket: int) -> int:
        return int(self.bucket_batches.get(bucket, self.batch_size))

    def __len__(self):
        return sum(len(ix) // self._bucket_bs(b)
                   for b, ix in self.index.items())

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        plan = []
        for b, ix in self.index.items():
            bs = self._bucket_bs(b)
            ix = ix.copy()
            if self.shuffle:
                self.rng.shuffle(ix)
            for i in range(len(ix) // bs):
                plan.append((b, ix[i * bs:(i + 1) * bs]))
        if self.shuffle:
            self.rng.shuffle(plan)
        for bucket, sel in plan:
            batch = {}
            for k, v in self.arrays.items():
                out = v[sel]
                batch[k] = out[..., :bucket] if k in self.seq_keys else out
            batch["_weight"] = np.ones((len(sel),), np.float32)
            yield batch


class Prefetcher:
    """Host-to-device pipeline: background threads assemble and copy the
    next batches while the current step computes. Batches arrive in the
    loader's order, at most `workers + depth` staged ahead; an exception
    in a worker is raised in the consumer.

    The loader is drawn on one thread and each batch staged (host
    tensors, pinning, the copy) on a pool of `workers` threads, as JAX's
    `Prefetcher` runs its `device_put`: futures consumed in submission
    order.

    On a CUDA device each batch is staged in pinned host memory and copied
    with `non_blocking` on a side stream; an event recorded after the
    batch's copies is waited on by the consumer's current stream before
    the batch is handed out, and each tensor is marked as used on that
    stream so the allocator keeps it until the step is done. Batch i is
    staged on side stream i % workers: one stream per worker, so one
    worker's copies never queue behind another's; the per-batch event
    orders each batch on its own."""

    def __init__(self, loader, device, depth: int = 2, workers: int = 1):
        self.loader = loader
        self.device = torch.device(device)
        self.depth = depth
        self.workers = max(int(workers), 1)
        self._streams = ([torch.cuda.Stream(self.device)
                          for _ in range(self.workers)]
                         if self.device.type == "cuda" else None)

    def __len__(self):
        return len(self.loader)

    def _stage(self, batch, i: int = 0):
        if self._streams is None:
            return {k: host_tensor(v).to(self.device)
                    for k, v in batch.items()}, None
        stream = self._streams[i % self.workers]
        with torch.cuda.stream(stream):
            out = {k: host_tensor(v).pin_memory().to(self.device,
                                                     non_blocking=True)
                   for k, v in batch.items()}
            ready = torch.cuda.Event()
            ready.record(stream)
        return out, ready

    def _fill(self, q: "queue.Queue") -> None:
        """Stage every batch into q in order (the background thread). An
        error of the loader is raised after the batches drawn before it
        are delivered, one of a stage at its batch's place."""
        failure = None
        with ThreadPoolExecutor(self.workers) as pool:
            it = enumerate(iter(self.loader))
            pending, live = deque(), True
            while live or pending:
                while live and len(pending) < self.workers + self.depth:
                    try:
                        i, batch = next(it)
                    except StopIteration:
                        live = False
                    except Exception as e:   # raised once pending is out
                        live, failure = False, e
                    else:
                        pending.append(pool.submit(self._stage, batch, i))
                if pending:
                    q.put(pending.popleft().result())
        if failure is not None:
            raise failure

    def __iter__(self):
        q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        end, err = object(), object()

        def worker():
            try:
                self._fill(q)
            except BaseException as e:  # re-raised in the consumer
                q.put((err, e))
            else:
                q.put(end)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is end:
                break
            if item[0] is err:
                t.join()
                raise item[1]
            batch, ready = item
            if ready is not None:
                consumer = torch.cuda.current_stream(self.device)
                consumer.wait_event(ready)
                for v in batch.values():
                    v.record_stream(consumer)
            yield batch
        t.join()
