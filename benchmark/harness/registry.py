"""Finds the benchmark's parts by name, each in a file of its own.

    configs/<config>.json     a configuration: the program's conf values, the weights' rules
    workloads/<cell>.json     a cell: its configuration, traffic, entry, sample and limits
    traffic/<mix>.json        a traffic mix: the parameters its generator reads
    traffic/<generator>.py    a generator, named by a mix's ``generator`` key
    entries/<entry>.py        the call that a cell's window drives, and its reference side
    metrics/<metric>.py       the reader of one metric (``read(run) -> number | None``)

A mix of an existing generator is data alone. An entry module has

    prepare(cfg, pool, seed, device, log) -> state   what both sides are given (weights)
    Program(cfg, state, device, pool)                the timed path: ``program(items) -> answers``
    model_shape(item) -> (H, W)                      the shape its frozen count is kept at
    reference(cfg, state, device, precision=None)    the plain reference in the program's
                                                     place: ``(items) -> answers``
    compare(answers, references) -> {number: value}  optional; ``harness/compare.py`` by default
    count(config, cfg, H, W, stored) -> {"flop", ...} optional; ``flops/count.py`` by default

``BENCHMARK.json`` at the root says which metrics each cell reports. A new cell,
configuration, mix or metric is a new file here and a line there; no file of the
harness changes.
"""

from __future__ import annotations

import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


class Registry:
    def __init__(self, bench_dir=BENCH_DIR, spec_path=None):
        self.dir = bench_dir
        self.spec_path = spec_path or os.path.join(os.path.dirname(bench_dir), "BENCHMARK.json")

    def _json(self, kind, name):
        path = os.path.join(self.dir, kind, f"{name}.json")
        if not os.path.exists(path):
            raise KeyError(f"no {kind[:-1]} named {name!r} ({path})")
        with open(path) as f:
            return json.load(f)

    def _module(self, kind, name):
        path = os.path.join(self.dir, kind, f"{name}.py")
        if not os.path.exists(path):
            raise KeyError(f"no {kind[:-1]} named {name!r} ({path})")
        spec = importlib.util.spec_from_file_location(f"benchmark_{kind}_{name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    def workload(self, name):
        return self._json("workloads", name)

    def config(self, name):
        return self._json("configs", name)

    def traffic(self, name):
        return self._json("traffic", name)

    def generator(self, name):
        return self._module("traffic", name)

    def entry(self, name):
        return self._module("entries", name)

    def metric(self, name):
        return self._module("metrics", name)

    def spec(self):
        with open(self.spec_path) as f:
            return json.load(f)

    def metrics_of(self, cell, traced):
        """The metrics ``BENCHMARK.json`` asks of ``cell``: its end-to-end ones
        untraced, its per-layer ones traced. A metric without ``workloads`` is
        every cell's."""
        key = "per_layer" if traced else "end_to_end"
        return [m for m in self.spec().get(key, []) if cell in m.get("workloads", [cell])]
