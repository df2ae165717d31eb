"""Reduces a profiler trace of the traced window to what the per-layer metrics read.

The window is the host span ``bench.window`` that the harness opens around the
traced calls. Device activity is every ``kernel``, ``gpu_memcpy`` and
``gpu_memset`` event; the busy time is the union of their intervals inside the
window, so overlapping kernels count once, and the idle share is one minus busy
over the window. Each kernel's time is filed under a category by the frozen
table below (a copy of the program's ``utils/profiling.py`` table, with cuDNN's
FFT convolution kernels filed as library convolutions, where that table leaves
them under "other").

``breakdown`` gives the ten device operations that took the most time, by name
(the first 160 characters of a templated kernel's name),
and the idle gaps by what the host was doing: each gap is named by the innermost
host event (operator, runtime call or the harness's own span) that covers its
middle, and the gaps of one name are summed.
"""

from __future__ import annotations

import heapq
import json

WINDOW_SPAN = "bench.window"
NAME_CHARS = 160      # a kernel's name in the breakdown: its first characters
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver", "python_function")

# substring of a kernel's name (lower case) -> category; the first match wins
CATEGORIES = (
    ("attn_hopper_kernel", "attention (this repo)"), ("attn_bf16_kernel", "attention (this repo)"),
    ("attn_f32_kernel", "attention (this repo)"),
    ("dcn_hopper_kernel", "dcn (this repo)"), ("cascade_select_kernel", "dcn (this repo)"),
    ("dcn_bf16_kernel", "dcn (this repo)"), ("dcn_f32_kernel", "dcn (this repo)"),
    ("dcn_f32_tiled_kernel", "dcn (this repo)"), ("pass_kernel", "dcn backward (this repo)"),
    ("vq_argmin", "vq_argmin (this repo)"),
    ("groupnorm", "group norm"), ("group_norm", "group norm"), ("rowwisemoments", "group norm"),
    ("regular_fft", "conv / gemm (library)"), ("vector_fft", "conv / gemm (library)"),
    ("fft_", "conv / gemm (library)"), ("region_transform", "conv / gemm (library)"),
    ("gemv", "conv / gemm (library)"),
    ("cudnn", "conv / gemm (library)"), ("conv", "conv / gemm (library)"),
    ("gemm", "conv / gemm (library)"), ("cutlass", "conv / gemm (library)"),
    ("xmma", "conv / gemm (library)"), ("nchw", "layout copies"), ("nhwc", "layout copies"),
    ("elementwise", "elementwise / casts"), ("copy", "elementwise / casts"),
    ("reduce", "reductions"), ("gather", "gather / index"), ("index", "gather / index"),
)


def category(name):
    n = name.lower()
    for key, cat in CATEGORIES:
        if key in n:
            return cat
    return "other"


def merged(intervals):
    """``[(start, end), ...]`` (any order) -> the union as sorted disjoint ``[start, end]``."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class Summary:
    """What the readers get: times in seconds."""

    def __init__(self, events):
        window = [e for e in events if e.get("name") == WINDOW_SPAN and e.get("cat") in HOST_CATS]
        if not window:
            raise ValueError(f"the trace holds no {WINDOW_SPAN!r} span")
        w0 = window[0]["ts"]
        w1 = w0 + window[0]["dur"]
        dev = []
        for e in events:
            if e.get("cat") in DEVICE_CATS and e.get("ph") == "X":
                s, t = max(e["ts"], w0), min(e["ts"] + e["dur"], w1)
                if t > s:
                    dev.append((s, t, e.get("name", ""), e.get("cat")))
        self.window_s = (w1 - w0) / 1e6
        self.busy_s = sum(t - s for s, t in merged([(s, t) for s, t, _, _ in dev])) / 1e6
        self.kernels = [(n, (t - s) / 1e6) for s, t, n, c in dev if c == "kernel"]
        self.launches = len(self.kernels)
        self.by_category = {}
        for n, d in self.kernels:
            c = category(n)
            self.by_category[c] = self.by_category.get(c, 0.0) + d
        self._dev = dev
        self._host = [e for e in events if e.get("cat") in HOST_CATS and e.get("ph") == "X"
                      and e["ts"] < w1 and e["ts"] + e.get("dur", 0) > w0 and e.get("name") != WINDOW_SPAN]
        self._w = (w0, w1)

    def category_s(self, *cats):
        return sum(self.by_category.get(c, 0.0) for c in cats)

    def breakdown(self, top=10):
        ops = {}
        for n, d in self.kernels:
            ops[n[:NAME_CHARS]] = ops.get(n[:NAME_CHARS], 0.0) + d
        busy = merged([(s, t) for s, t, _, _ in self._dev])
        gaps, prev = [], self._w[0]
        for s, t in busy + [[self._w[1], self._w[1]]]:
            if s > prev:
                gaps.append((prev, s))
            prev = max(prev, t)
        named = {}
        for (s, t), name in zip(gaps, innermost([(s + t) / 2 for s, t in gaps], self._host)):
            named[name] = named.get(name, 0.0) + (t - s) / 1e6
        return {"device_ops": sorted(([n, d] for n, d in ops.items()), key=lambda x: -x[1])[:top],
                "idle_gaps": sorted(([n, d] for n, d in named.items()), key=lambda x: -x[1])[:top]}


def innermost(points, host):
    """For each of the ascending ``points``, the name of the shortest host event
    that covers it (``"host outside any span"`` where none does)."""
    events = sorted(host, key=lambda e: e["ts"])
    by_end, by_dur, out, i = [], [], [], 0
    for p in points:
        while i < len(events) and events[i]["ts"] <= p:
            e = events[i]
            heapq.heappush(by_end, (e["ts"] + e["dur"], i))
            heapq.heappush(by_dur, (e["dur"], i))
            i += 1
        while by_end and by_end[0][0] < p:
            heapq.heappop(by_end)
        live = {j for _, j in by_end}
        while by_dur and by_dur[0][1] not in live:
            heapq.heappop(by_dur)
        out.append(events[by_dur[0][1]]["name"] if by_dur else "host outside any span")
    return out


def load_events(path):
    with open(path) as f:
        data = json.load(f)
    return data["traceEvents"] if isinstance(data, dict) else data
