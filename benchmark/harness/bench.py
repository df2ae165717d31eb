"""One run of one cell: set-up, the measured (or traced) window, the check.

    set-up   the inputs from the seed, by the mix's generator (``traffic/<name>.py``);
             what both sides hold (the weights), by the entry's ``prepare``; the
             program built by the entry's ``Program``; one call at each of the
             cell's shapes. ``setup_s`` runs from the start of the process to here.
    window   calls in the generator's seeded order, each sent when the last has
             returned (the mix's ``loop``: "closed"), until ``seconds`` have passed
             (``--trace 0``), or the cell's ``trace_calls`` calls under
             ``torch.profiler`` (``--trace 1``).
    check    the device peak is read and the program freed; then a sample of the
             finished calls, drawn from the seed with the largest input in it, is
             answered by the entry's ``reference`` from the same inputs and state
             and compared (the entry's ``compare``, or ``harness/compare.py``)
             with the cell's limits.

The result is the dict that ``run.py`` prints as its last line.
"""

from __future__ import annotations

import gc
import math
import os
import sys
import tempfile
import time
from types import SimpleNamespace

import numpy as np
import torch

from . import compare, trace
from .registry import Registry
from ..flops import count as flop_count

PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 495e12}  # H100 SXM data sheet: bf16, TF32 dense
PEAK_BYTES = 3.35e12                                         # H100 SXM HBM3


class Run:
    """What a metric reader sees (``metrics/<name>.py``: ``read(run)``)."""

    def __init__(self, cell, cfg, seconds):
        self.cell, self.cfg, self.seconds = cell, cfg, seconds
        self.setup_s = None
        self.calls = []          # {"t0", "t1", "ids", "ok"} per call, host clock
        self.window_s = None     # host seconds of the window (end of the last call)
        self.trace = None        # trace.Summary of a traced run
        self.counts = []         # frozen per-image counts of every image of the window
        self.peak_flops = PEAK_FLOPS[torch.bfloat16 if cfg.get("inference_dtype") == "bfloat16"
                                     else torch.float32]
        self.peak_bytes = PEAK_BYTES

    @property
    def images(self):
        return sum(len(c["ids"]) for c in self.calls if c["ok"])

    def latencies_s(self):
        """Seconds of every request of the window, call start to answer on the host."""
        return [c["t1"] - c["t0"] for c in self.calls if c["ok"] for _ in c["ids"]]

    def kernel_share(self, flop_key, bytes_key, *cats):
        """Percent of the roofline: the least time the counted work needs (operations
        at the peak or bytes at the memory's rate, whichever is longer) over the
        device time of the kernels of ``cats``; None where none ran."""
        t = self.trace.category_s(*cats)
        work = sum(c[flop_key] for c in self.counts)
        if t <= 0 or work <= 0:
            return None
        bound = max(work / self.peak_flops, sum(c[bytes_key] for c in self.counts) / self.peak_bytes)
        return 100.0 * bound / t


def _merge(base, over):
    out = dict(base)
    for k, v in (over or {}).items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def _sample(rng, calls, pool, k):
    """Up to ``k`` finished calls drawn by ``rng``, one of them holding the largest photo."""
    done = [i for i, c in enumerate(calls) if c["ok"]]
    if not done:
        return []
    pick = list(rng.choice(done, size=min(k, len(done)), replace=False))
    size = {i: max(pool[j].size for j in calls[i]["ids"]) for i in done}
    largest = max(size.values())
    if all(size[i] < largest for i in pick):
        pick[0] = int(rng.choice([i for i in done if size[i] == largest]))
    return sorted(int(i) for i in pick)


def run(cell, seed, seconds, traced, device="cuda", t_start=None, registry=None,
        cfg_override=None, mix_override=None, fault=None, numbers_out=None, min_calls=0, log=print):
    """One run of ``cell``; see the module docstring. ``fault(program, side)``
    returns what the window calls in the program's place (a control, or the timed
    path broken underneath; ``side`` holds ``cfg``, ``state``, ``device`` and
    ``entry``); the overrides shrink a configuration or a mix for a run on the CPU;
    ``numbers_out`` receives every number the comparison computed; ``min_calls``
    keeps the window open until that many calls have finished (readings of a
    slow control)."""
    t_start = time.perf_counter() if t_start is None else t_start
    reg = registry or Registry()
    wl = reg.workload(cell)
    cfg = _merge(reg.config(wl["config"]), cfg_override)
    mix = _merge(reg.traffic(wl["traffic"]), mix_override)
    if mix.get("loop", "closed") != "closed":
        raise ValueError(f"mix {wl['traffic']!r}: loop {mix['loop']!r}; the window drives a closed loop only")
    gen = reg.generator(mix["generator"])
    entry = reg.entry(wl["entry"])
    dev = torch.device(device)

    marks = [("start", t_start)]

    def mark(what):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        marks.append((what, time.perf_counter()))

    mark("imports")
    pool = gen.pool(mix, seed, dev)
    mark("inputs")
    state = entry.prepare(cfg, pool, seed, dev, log)
    mark("weights")
    program = entry.Program(cfg, state, dev, pool)
    mark("program built")
    state = {k: v.cpu() if torch.is_tensor(v) else v for k, v in state.items()}   # off the card
    if fault is not None:
        program = fault(program, SimpleNamespace(cfg=cfg, state=state, device=dev, entry=entry))
    batch = int(mix.get("batch", 1))
    shapes = {}
    for i, p in enumerate(pool):
        shapes.setdefault(p.shape, []).append(i)
    for ids in shapes.values():                        # one call at each of the cell's shapes
        program([pool[j] for j in ids[:batch]])
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    mark("warm calls")
    out = Run(cell, cfg, seconds)
    out.setup_s = marks[-1][1] - t_start
    log("set-up s: " + ", ".join(f"{w} {t - t0:.2f}" for (_, t0), (w, t) in zip(marks, marks[1:])),
        file=sys.stderr)

    answers, calls = {}, gen.calls(mix, seed, pool)
    n_calls = int(wl["trace_calls"]) if traced else None

    def one_call(ids):
        rec = {"ids": ids, "ok": True, "t0": time.perf_counter()}
        try:
            answers[len(out.calls)] = program([pool[j] for j in ids])
        except Exception as exc:                        # a failed request counts, the run goes on
            rec["ok"] = False
            log(f"call {len(out.calls)} failed: {exc!r}", file=sys.stderr)
        rec["t1"] = time.perf_counter()
        out.calls.append(rec)

    w0 = time.perf_counter()
    if traced:
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        with profile(activities=acts) as prof:
            with record_function(trace.WINDOW_SPAN):
                for _ in range(n_calls):
                    one_call(next(calls))
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            out.trace = trace.Summary(trace.load_events(path))
        finally:
            os.remove(path)
    else:
        while time.perf_counter() - w0 < seconds or len(out.calls) < min_calls:
            one_call(next(calls))
    out.window_s = out.calls[-1]["t1"] - w0
    shapes = [entry.model_shape(pool[j]) for c in out.calls if c["ok"] for j in c["ids"]]
    count = getattr(entry, "count", flop_count.lookup)
    per_shape = {hw: count(wl["config"], cfg, *hw, stored=cfg_override is None) for hw in set(shapes)}
    out.counts = [per_shape[hw] for hw in shapes]
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    del program
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    rng = np.random.default_rng([int(seed), 2])
    picked = _sample(rng, out.calls, pool, int(wl["sample_calls"]))
    answer = entry.reference(cfg, state, dev)
    got, want = [], []
    for i in picked:
        want += answer([pool[j] for j in out.calls[i]["ids"]])
        got += list(answers[i])
    del answer
    judge = getattr(entry, "compare", compare.worst)
    numbers = judge(got, want) if picked else dict.fromkeys(wl["limits"], math.inf)
    if numbers_out is not None:
        numbers_out.update(numbers)
    limits = wl["limits"]
    failed = sum(len(c["ids"]) for c in out.calls if not c["ok"])
    correct = failed == 0 and all(numbers.get(k, math.inf) <= limits[k] for k in limits)

    metrics = {}
    for m in reg.metrics_of(cell, traced):
        v = reg.metric(m["name"]).read(out)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    result = {
        "correct": bool(correct),
        "attempted": sum(len(c["ids"]) for c in out.calls),
        "failed": failed,
        "metrics": metrics,
        "device": {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": 1, "memory_peak_bytes": int(peak)},
    }
    if traced:
        result["device"].update(busy_s=out.trace.busy_s, window_s=out.trace.window_s)
        result["breakdown"] = out.trace.breakdown()
    log(f"compared {len(got)} answers of calls {picked}: {numbers}", file=sys.stderr)
    result["limits"] = {k: {"value": numbers.get(k, math.inf), "limit": limits[k]} for k in limits}
    return result
