"""The arithmetic of the metric readers; each ``metrics/<name>.py`` names one of these.

A reader takes the run (``harness/bench.py: Run``) and returns a number, or None
when the run holds nothing for it to read (the metric is then left out): a trace
with no device activity, or no counted image."""

from __future__ import annotations

import numpy as np


def setup_s(run):
    return run.setup_s


def img_per_s(run):
    """Images completed in the window over the window's seconds (its last call ends it)."""
    return run.images / run.window_s if run.window_s and run.images else None


def latency_p95_ms(run):
    """95th percentile of every request's latency in the window (linear interpolation)."""
    lat = run.latencies_s()
    return float(np.percentile(lat, 95)) * 1e3 if lat else None


def _traced(run):
    return bool(run.counts) and run.trace.busy_s > 0


def mfu(run):
    """Percent of the compute dtype's peak: the frozen count of the images the
    traced window completed over the window's seconds."""
    if not _traced(run):
        return None
    return 100.0 * sum(c["flop"] for c in run.counts) / (run.trace.window_s * run.peak_flops)


def idle_share(run):
    if not _traced(run):
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)


def launches_per_img(run):
    return run.trace.launches / len(run.counts) if _traced(run) else None


def attn_roofline(run):
    return run.kernel_share("attn_flop", "attn_bytes", "attention (this repo)")


def dcn_roofline(run):
    return run.kernel_share("dcn_flop", "dcn_bytes", "dcn (this repo)")


def conv_ms_per_img(run):
    if not _traced(run):
        return None
    return 1e3 * run.trace.category_s("conv / gemm (library)") / len(run.counts)


def norm_eltwise_ms_per_img(run):
    if not _traced(run):
        return None
    return 1e3 * run.trace.category_s("group norm", "elementwise / casts") / len(run.counts)
