"""Minimal batch loader with a seeded shuffle (the port's own copy of
``glare_tpu/data/loader.py``; it replaces the reference's torch DataLoader with
``num_workers`` 0, code/data/__init__.py:10-25), and :class:`PrefetchDataLoader`,
which builds its batches in a thread ahead of the loop (reference:
prefetch_dataloader.py:8-60). Batches are stacked numpy NHWC arrays; the model
moves them to its device.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Dict, Iterator

import numpy as np


class DataLoader:
    """``sampler``: an object with ``indices()`` (``parallel.EnlargedSampler``) whose
    order replaces the loader's own shuffle: a data-parallel rank's share."""

    def __init__(self, dataset, batch_size=1, shuffle=False, drop_last=False, seed=0, sampler=None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.sampler = sampler
        self.rng = np.random.default_rng(seed)
        self.epoch = 0

    def __len__(self):
        n = len(self.dataset) if self.sampler is None else len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        if self.sampler is not None:
            order = np.asarray(self.sampler.indices())
        else:
            order = np.arange(len(self.dataset))
            if self.shuffle:
                self.rng.shuffle(order)
        n = len(order)
        self.epoch += 1
        for start in range(0, n, self.batch_size):
            idx = order[start:start + self.batch_size]
            if self.drop_last and len(idx) < self.batch_size:
                return
            yield _collate([self.dataset[int(i)] for i in idx])


def _collate(samples):
    out: Dict[str, Any] = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        out[key] = np.stack(vals, axis=0) if isinstance(vals[0], np.ndarray) else vals
    return out


class _Raised:
    def __init__(self, exc):
        self.exc = exc


class PrefetchDataLoader:
    """``loader``'s batches, in its order, built by a thread up to ``num_prefetch``
    ahead of the loop. The thread starts at ``iter()`` (after a sampler's
    ``set_epoch``) and is the only reader of the dataset while the epoch runs, so a
    dataset that draws from Python's or numpy's global RNG draws the same numbers
    in the same order as under ``loader`` alone. An exception in the thread is
    raised in the loop (the JAX loader's loop would wait forever). A loop that
    stops early stops the thread before it returns: nothing reads the dataset
    after the epoch's iterator is closed."""

    def __init__(self, loader: DataLoader, num_prefetch=2):
        self.loader = loader
        self.num_prefetch = num_prefetch

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        q: queue.Queue = queue.Queue(maxsize=self.num_prefetch)
        done, stop = object(), threading.Event()

        def producer():
            try:
                for item in self.loader:
                    q.put(item)
                    if stop.is_set():
                        return
            except Exception as exc:  # noqa: BLE001 - handed to the loop, raised there
                q.put(_Raised(exc))
                return
            q.put(done)

        thread = threading.Thread(target=producer, name="PrefetchDataLoader", daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is done:
                    return
                if isinstance(item, _Raised):
                    raise item.exc
                yield item
        finally:
            stop.set()
            while thread.is_alive():  # unblock a put, let the thread see the stop
                try:
                    q.get_nowait()
                except queue.Empty:
                    thread.join(0.01)


def create_dataloader(train, dataset, dataset_opt, opt=None, sampler=None, seed=0):
    """Factory with the reference defaults: training batches of ``batch_size``,
    shuffled (seeded), the last short batch dropped; evaluation one by one."""
    if train:
        batch_size = dataset_opt.get("batch_size") or 1
        return DataLoader(dataset, batch_size=batch_size, shuffle=True, drop_last=True, seed=seed)
    return DataLoader(dataset, batch_size=1, shuffle=False, drop_last=False, seed=seed)
