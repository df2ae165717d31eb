"""Registries (the port's own copy of ``glare_tpu/sr/registry.py``; reference:
basicsr/utils/registry.py).

ARCH / MODEL / DATASET / LOSS / METRIC registries with decorator registration
and build-by-name; :func:`auto_import` imports every ``*_arch.py`` /
``*_model.py`` / ``*_dataset.py`` of a package so its decorators run.
"""

from __future__ import annotations

import importlib
import os


class Registry:
    def __init__(self, name):
        self._name = name
        self._obj_map = {}

    def _do_register(self, name, obj):
        if name in self._obj_map:
            raise KeyError(f"'{name}' already registered in '{self._name}'")
        self._obj_map[name] = obj

    def register(self, obj=None):
        if obj is None:
            def deco(func_or_class):
                self._do_register(func_or_class.__name__, func_or_class)
                return func_or_class

            return deco
        self._do_register(obj.__name__, obj)
        return obj

    def get(self, name):
        ret = self._obj_map.get(name)
        if ret is None:
            raise KeyError(f"'{name}' not found in '{self._name}' registry. "
                           f"Available: {sorted(self._obj_map)}")
        return ret

    def __contains__(self, name):
        return name in self._obj_map

    def keys(self):
        return self._obj_map.keys()


ARCH_REGISTRY = Registry("arch")
MODEL_REGISTRY = Registry("model")
DATASET_REGISTRY = Registry("dataset")
LOSS_REGISTRY = Registry("loss")
METRIC_REGISTRY = Registry("metric")


def auto_import(package, suffix):
    """Import every module of ``package`` whose file name ends with ``suffix``
    (``_arch``, ``_model``, ``_dataset``) so its registry decorators run."""
    pkg = importlib.import_module(package)
    folder = os.path.dirname(pkg.__file__)
    for fn in sorted(os.listdir(folder)):
        if fn.endswith(f"{suffix}.py"):
            importlib.import_module(f"{package}.{fn[:-3]}")
