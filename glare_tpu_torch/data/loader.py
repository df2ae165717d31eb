"""Minimal batch loader with a seeded shuffle (the port's own copy of
``glare_tpu/data/loader.py``; it replaces the reference's torch DataLoader with
``num_workers`` 0, code/data/__init__.py:10-25). Batches are stacked numpy
NHWC arrays; the model moves them to its device.
"""

from __future__ import annotations

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


def create_dataloader(train, dataset, dataset_opt, opt=None, sampler=None, seed=0):
    """Factory with the reference defaults: training batches of ``batch_size``,
    shuffled (seeded), the last short batch dropped; evaluation one by one."""
    if train:
        batch_size = dataset_opt.get("batch_size") or 1
        return DataLoader(dataset, batch_size=batch_size, shuffle=True, drop_last=True, seed=seed)
    return DataLoader(dataset, batch_size=1, shuffle=False, drop_last=False, seed=seed)
