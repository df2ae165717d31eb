"""Dataset factory and loaders (the port's own copy of ``glare_tpu/data/``;
reference: code/data/__init__.py:10-25). Datasets return NHWC numpy float32;
the C++ host path is ``data/native.py``.
"""

from __future__ import annotations

from .loader import DataLoader, PrefetchDataLoader, create_dataloader
from .lol_dataset import LoLDataset, LoLDatasetRIDCP, LoLDatasetV2


def create_dataset(dataset_opt, train, all_opt):
    name = all_opt.get("dataset") or "LoL"
    if name == "LoL":
        return LoLDatasetRIDCP(dataset_opt, train, all_opt)
    if name == "LoL_old":
        return LoLDataset(dataset_opt, train, all_opt)
    if name in ("LoL_v2", "LoLv2"):
        return LoLDatasetV2(dataset_opt, train, all_opt)
    raise NotImplementedError(f"Dataset [{name}] not recognized.")


__all__ = ["create_dataset", "create_dataloader", "DataLoader", "PrefetchDataLoader", "LoLDataset",
           "LoLDatasetV2", "LoLDatasetRIDCP"]
