"""The frozen count of operations and bytes, per image, at each served shape.

    python benchmark/flops/count.py            # rewrites benchmark/flops/counts.json

Counts are taken from the plain reference (``reference/glare.py``), run on the
meta device (shapes only) under ``torch.utils.flop_counter.FlopCounterMode``,
which counts 2 operations a multiply-add of every convolution and matrix
product. The reference's attention is two dense products, 4 * n^2 * C a block,
and its DCN one column product, 2 * P * 9 * C * O a warp: the same formulas the
program's kernels are judged by. The bytes of the two kernels are their inputs
read once and their output written once, in the served types: attention q, k, v
and the output (n * C each, bf16); the DCN x and its output (P * C, bf16), the
offsets (P * G * 9 * 2, float32), the masks (P * G * 9, float32) and the
weight (9 * C * O, bf16).

A count depends on the configuration and the model's input shape only (the
program's work per image does not depend on the batch), so ``counts.json`` is
keyed ``<config>/<H>x<W>`` with H, W the padded input. It holds every shape the
cells serve; a run counts a shape that is not there (a cell added later) itself.
"""

from __future__ import annotations

import json
import os
import sys

import torch
from torch.utils.flop_counter import FlopCounterMode

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))

from benchmark.harness.registry import Registry  # noqa: E402
from benchmark.reference import glare  # noqa: E402

COUNTS = os.path.join(HERE, "counts.json")


def count(cfg, h, w):
    """-> {"flop", "attn_flop", "attn_bytes", "dcn_flop", "dcn_bytes"} of one image."""
    with torch.device("meta"):
        model = glare.Reference(cfg)
    attn, dcn = [], []

    def on_attn(mod, args, out):
        b, c, hh, ww = args[0].shape
        n = hh * ww
        attn.append((4 * n * n * c, 4 * n * c * 2))

    def on_dcn(mod, args, out):
        b, c, hh, ww = args[0].shape
        p, o, g = hh * ww, mod.weight.shape[0], mod.conv_offset.weight.shape[0] // 27
        dcn.append((2 * p * 9 * c * o, p * c * 2 + p * o * 2 + p * g * 9 * 3 * 4 + 9 * c * o * 2))

    for m in model.modules():
        if isinstance(m, glare.AttnBlock):
            m.register_forward_hook(on_attn)
        if isinstance(m, glare.DCNv2Pack):
            m.register_forward_hook(on_dcn)
    x = torch.empty(1, 3, h, w, device="meta")
    with FlopCounterMode(display=False) as fc:
        glare.run(model, x)
    return {"flop": int(fc.get_total_flops()),
            "attn_flop": sum(a for a, _ in attn), "attn_bytes": sum(b for _, b in attn),
            "dcn_flop": sum(a for a, _ in dcn), "dcn_bytes": sum(b for _, b in dcn)}


def cell_shapes(registry=None):
    """{(config, H, W)} of every model input that the cells of ``BENCHMARK.json`` serve."""
    import numpy as np

    registry = registry or Registry()
    shapes = set()
    for w in registry.spec()["workloads"]:
        wl = registry.workload(w["name"])
        entry = registry.entry(wl["entry"])
        for size in registry.traffic(wl["traffic"])["sizes"]:
            shapes.add((wl["config"], *entry.model_shape(np.zeros((*size["hw"], 3), np.uint8))))
    return shapes


def key(config, h, w):
    return f"{config}/{h}x{w}"


def all_counts(registry=None):
    registry = registry or Registry()
    return {key(c, h, w): count(registry.config(c), h, w) for c, h, w in sorted(cell_shapes(registry))}


def lookup(config, cfg, h, w, stored=True):
    """The stored count of one image, or a fresh count of a shape not stored (or of
    a configuration changed from its file: ``stored=False``)."""
    return (load().get(key(config, h, w)) if stored else None) or count(cfg, h, w)


def load():
    with open(COUNTS) as f:
        return json.load(f)


if __name__ == "__main__":
    with open(COUNTS, "w") as f:
        json.dump(all_counts(), f, indent=1, sort_keys=True)
        f.write("\n")
    print(open(COUNTS).read())
