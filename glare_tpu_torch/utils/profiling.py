"""Profiling and timing (counterpart of ``glare_tpu/utils/profiling.py``).

  * :func:`trace` -- a ``torch.profiler`` context with CPU and CUDA activities that
    writes a Chrome trace (``trace.json`` under ``log_dir``; Perfetto opens it).
  * :func:`host_sync` -- an execution barrier: ``torch.cuda.synchronize`` on the
    device of the first tensor in ``out`` (nothing for CPU tensors).
  * :func:`timed` -- seconds per call over ``iters`` calls after ``warmup``, one
    barrier at each end.
  * :class:`StepTimer` -- rolling steps per second of a training loop.
  * :func:`memory_stats` -- ``torch.cuda.memory_stats`` per visible device.
  * :func:`aggregate` -- a finished profiler's device time by kernel category,
    kernel count and busy time: the reader that ``chip_smoke.py --profile`` and
    ``tools/profile_stage{1,3}.py`` share.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable

import torch

# substring of a kernel's name (lower case) -> its category; the first match wins
CATEGORIES = (
    ("attn_hopper_kernel", "attention (this repo)"), ("attn_bf16_kernel", "attention (this repo)"),
    ("attn_f32_kernel", "attention (this repo)"),
    ("dcn_hopper_kernel", "dcn (this repo)"), ("cascade_select_kernel", "dcn (this repo)"),
    ("dcn_bf16_kernel", "dcn (this repo)"), ("dcn_f32_kernel", "dcn (this repo)"),
    ("dcn_f32_tiled_kernel", "dcn (this repo)"), ("pass_kernel", "dcn backward (this repo)"),
    ("vq_argmin", "vq_argmin (this repo)"),
    ("groupnorm", "group norm"), ("group_norm", "group norm"), ("rowwisemoments", "group norm"),
    ("cudnn", "conv / gemm (library)"), ("conv", "conv / gemm (library)"),
    ("gemm", "conv / gemm (library)"), ("cutlass", "conv / gemm (library)"),
    ("xmma", "conv / gemm (library)"), ("nchw", "layout copies"), ("nhwc", "layout copies"),
    ("elementwise", "elementwise / casts"), ("copy", "elementwise / casts"),
    ("reduce", "reductions"), ("gather", "gather / index"), ("index", "gather / index"),
)


def category(name):
    """The category of a device kernel by its name ("other" when none matches)."""
    n = name.lower()
    for key, cat in CATEGORIES:
        if key in n:
            return cat
    return "other"


@contextlib.contextmanager
def trace(log_dir: str = "results/glare_trace", cuda: bool = None):
    """``torch.profiler`` over the block (CPU, and CUDA when a card is there or
    ``cuda``); writes ``log_dir/trace.json``. Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available() if cuda is None else cuda
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _first_tensor(out):
    if torch.is_tensor(out):
        return out
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (list, tuple)):
        for v in out:
            t = _first_tensor(v)
            if t is not None:
                return t
    return None


def host_sync(out):
    """Wait for the device of the first tensor in ``out`` (a tensor, or a list /
    tuple / dict holding one); returns ``out``."""
    t = _first_tensor(out)
    if t is not None and t.device.type == "cuda":
        torch.cuda.synchronize(t.device)
    return out


def timed(fn: Callable, *args, iters: int = 10, warmup: int = 2):
    """-> (seconds per call, the last output): ``warmup`` calls, a barrier, then
    ``iters`` calls between two barriers."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
    host_sync(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    host_sync(out)
    return (time.perf_counter() - t0) / iters, out


class StepTimer:
    """``tick()`` / ``tock()`` around each step; ``steps_per_sec`` over the last
    ``window`` steps."""

    def __init__(self, window: int = 100):
        self.window = window
        self.times = []
        self._t0 = None

    def tick(self):
        self._t0 = time.perf_counter()

    def tock(self):
        dt = time.perf_counter() - self._t0
        self.times.append(dt)
        if len(self.times) > self.window:
            self.times.pop(0)
        return dt

    @property
    def steps_per_sec(self):
        if not self.times:
            return 0.0
        return len(self.times) / sum(self.times)


def memory_stats():
    """{device name: ``torch.cuda.memory_stats``} for every visible card ({} without one)."""
    if not torch.cuda.is_available():
        return {}
    return {f"cuda:{i}": torch.cuda.memory_stats(i) for i in range(torch.cuda.device_count())}


def aggregate(prof, top=12):
    """A finished ``torch.profiler`` run -> {device_ms_by_category, top_kernels_ms,
    kernel_launches, device_busy_ms}: the self device time of every device event of
    ``key_averages()``, summed by :func:`category` and by name (the first 90
    characters; the ``top`` largest)."""
    cats, names, n_kernels = {}, {}, 0
    for ev in prof.key_averages():
        if str(getattr(ev, "device_type", "")).endswith("CUDA") or getattr(ev, "is_device", False):
            us = getattr(ev, "self_device_time_total", None)
            if us is None:
                us = getattr(ev, "self_cuda_time_total", 0.0)
            if us <= 0:
                continue
            n_kernels += ev.count
            c = category(ev.key)
            cats[c] = cats.get(c, 0.0) + us / 1e3
            names[ev.key[:90]] = names.get(ev.key[:90], 0.0) + us / 1e3
    return {"device_ms_by_category": dict(sorted(cats.items(), key=lambda kv: -kv[1])),
            "top_kernels_ms": sorted(names.items(), key=lambda kv: -kv[1])[:top],
            "kernel_launches": n_kernels, "device_busy_ms": sum(cats.values())}
