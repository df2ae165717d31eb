"""Dataset registry and loader factory (counterpart of ``glare_tpu/sr/data/__init__.py``;
reference: basicsr/data/__init__.py), on the port's ``data/loader.py``.

Under data parallelism the training loader draws the rank's indices from an
``EnlargedSampler`` (``sampler=``); in one process it keeps its own seeded
shuffle, as the JAX loader does. A truthy ``prefetch_mode`` wraps the training
loader in a ``PrefetchDataLoader`` (its batches built in a thread, two ahead of
the loop), as in JAX.
"""

from ...data.loader import DataLoader, PrefetchDataLoader
from ..registry import DATASET_REGISTRY, auto_import

auto_import(__name__, "_dataset")


def build_dataset(dataset_opt):
    return DATASET_REGISTRY.get(dataset_opt["type"])(dict(dataset_opt))


def build_dataloader(dataset, dataset_opt, seed=0, sampler=None):
    """Training: batches of ``batch_size_per_gpu`` (or ``batch_size``), in the
    ``sampler``'s order when one is given, else shuffled unless ``use_shuffle`` is
    false, the last short batch dropped, prefetched under ``prefetch_mode``; else
    one by one."""
    if dataset_opt.get("phase", "train") == "train":
        loader = DataLoader(
            dataset,
            batch_size=dataset_opt.get("batch_size_per_gpu") or dataset_opt.get("batch_size") or 1,
            shuffle=bool(dataset_opt.get("use_shuffle", True)),
            drop_last=True,
            seed=seed,
            sampler=sampler,
        )
        return PrefetchDataLoader(loader) if dataset_opt.get("prefetch_mode") else loader
    return DataLoader(dataset, batch_size=1, shuffle=False, drop_last=False, seed=seed)
