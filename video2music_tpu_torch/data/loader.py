"""Threaded prefetching batch loader (the port's copy of the JAX
package's ``data/loader.py``; ``device_prefetch`` copies to a torch device).

The reference leans on ``DataLoader(num_workers=4)`` for host-side loading
parallelism (reference: ``train.py:132-134``) after eagerly materializing
every sample at startup. Here batches are assembled by a thread pool (file
parsing happens in the C++ parsers, which hold no Python state, so threads
scale) and staged into a bounded queue so the accelerator never waits on
host IO.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional

import numpy as np


def to_device(batch: dict, device, non_blocking: bool = False) -> dict:
    """One numpy batch dict -> torch tensors on ``device`` (dtypes kept)."""
    import torch
    return {k: torch.as_tensor(v).to(device, non_blocking=non_blocking)
            for k, v in batch.items()}


def device_prefetch(batches, device, depth: int = 2):
    """Stage up to ``depth`` batches on ``device`` ahead of consumption.

    Each numpy batch is copied to the device (from pinned memory when the
    device is CUDA, so the copy is asynchronous); issuing the copy of the
    *next* batch before the current step's result is read overlaps the
    host→device copy with device compute.
    """
    import torch
    dev = torch.device(device)
    if dev.type == "cuda":
        put = lambda b: to_device(
            {k: torch.as_tensor(v).pin_memory() for k, v in b.items()}, dev,
            non_blocking=True)
    else:
        put = lambda b: to_device(b, dev)
    from collections import deque

    buf: "deque" = deque()
    it = iter(batches)
    exhausted = False
    while True:
        while not exhausted and len(buf) < depth:
            try:
                buf.append(put(next(it)))
            except StopIteration:
                exhausted = True
        if not buf:
            return
        yield buf.popleft()


class PrefetchLoader:
    """Iterable over stacked numpy batch dicts with background prefetch."""

    def __init__(self, dataset, batch_size: int, *, shuffle: bool = True,
                 seed: int = 0, drop_last: bool = False,
                 num_workers: int = 4, prefetch: int = 2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.num_workers = num_workers
        self.prefetch = prefetch
        self._epoch = 0

    def __len__(self):
        n = len(self.dataset)
        full, rem = divmod(n, self.batch_size)
        return full if (self.drop_last or rem == 0) else full + 1

    def _batch_indices(self):
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + self._epoch).shuffle(order)
        for start in range(0, len(order), self.batch_size):
            idx = order[start:start + self.batch_size]
            if self.drop_last and len(idx) < self.batch_size:
                return
            yield idx

    def _make_batch(self, idx):
        samples = [self.dataset[int(i)] for i in idx]
        return {k: np.stack([s[k] for s in samples]) for k in samples[0]}

    def __iter__(self) -> Iterator[dict]:
        self._epoch += 1
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def producer():
            # bounded in-flight window: only num_workers + prefetch batches
            # exist at any time (an unbounded submit would materialize the
            # whole epoch regardless of consumption rate)
            from collections import deque

            window = self.num_workers + self.prefetch
            with ThreadPoolExecutor(self.num_workers) as pool:
                pending: deque = deque()
                it = self._batch_indices()
                try:
                    for idx in it:
                        while len(pending) >= window:
                            if not _put(pending.popleft().result()):
                                return
                        pending.append(pool.submit(self._make_batch, idx))
                    while pending:
                        if not _put(pending.popleft().result()):
                            return
                finally:
                    for fut in pending:
                        fut.cancel()
            _put(None)

        def _put(item) -> bool:
            """queue.put that gives up when the consumer is gone."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                yield item
        finally:
            stop.set()
