"""Fixed-shape batch loader and host-to-device prefetch (counterpart of
meant_tpu/data/loader.py `ArrayLoader` and `Prefetcher`).

Train batches drop the remainder; eval batches are padded to the batch
size and carry a `_weight` vector (1 for real rows, 0 for padding) so
padding never enters the metrics. `BucketedLoader` is not ported yet.
"""

from __future__ import annotations

import queue
import threading
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


class Prefetcher:
    """Double-buffered host-to-device pipeline: a background thread
    assembles the next batches while the current step computes.

    On a CUDA device each batch is staged in pinned host memory and copied
    with `non_blocking` on a side stream; an event recorded after the
    copies is waited on by the consumer's current stream before the batch
    is handed out, and each tensor is marked as used on that stream so the
    allocator keeps it until the step is done. Batches arrive in order; an
    exception in the thread is raised in the consumer."""

    def __init__(self, loader, device, depth: int = 2):
        self.loader = loader
        self.device = torch.device(device)
        self.depth = depth
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)

    def __len__(self):
        return len(self.loader)

    def _stage(self, batch):
        if self._stream is None:
            return {k: host_tensor(v).to(self.device)
                    for k, v in batch.items()}, None
        with torch.cuda.stream(self._stream):
            out = {k: host_tensor(v).pin_memory().to(self.device,
                                                     non_blocking=True)
                   for k, v in batch.items()}
            ready = torch.cuda.Event()
            ready.record(self._stream)
        return out, ready

    def __iter__(self):
        q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        end, err = object(), object()

        def worker():
            try:
                for batch in self.loader:
                    q.put(self._stage(batch))
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
