"""Shared helpers for tests/test_torch_*.py (the PyTorch port held against the
JAX package on the CPU).

Inputs and weights are made with numpy from a seed and handed to both sides:
``random_params`` fills a flax module's parameter tree (shapes from
``jax.eval_shape``, so nothing is compiled for the init) with values that
exercise every parameter -- zero-initialized heads included -- and
``glare_tpu_torch.convert`` carries them into the port's ``state_dict``.
"""

from __future__ import annotations

import jax
import numpy as np
import torch


def _fill(path, shape, rng):
    name = path[-1]
    if name == "kernel":
        fan_in = int(np.prod(shape[:-1]))
        scale = 1.0 / np.sqrt(fan_in)
        if "conv_offset" in path:
            scale *= 0.5  # tempered offset heads: offsets of a few pixels, not chaos
        return rng.standard_normal(shape) * scale
    if name == "scale":
        return 1.0 + 0.1 * rng.standard_normal(shape)
    if name == "bias":
        if "conv_offset" in path:
            return 1.5 * rng.standard_normal(shape)  # offsets beyond +-2 px exist
        return 0.1 * rng.standard_normal(shape)
    if name == "logs":
        return 0.1 * rng.standard_normal(shape)
    if name == "weight" and len(shape) == 2:      # invertible 1x1: well-conditioned
        return np.eye(shape[0]) + 0.1 * rng.standard_normal(shape)
    if name == "weight":                          # DCN weight, HWIO
        return rng.standard_normal(shape) / np.sqrt(int(np.prod(shape[:-1])))
    if name == "embedding":
        return rng.standard_normal(shape)
    if name == "w":
        return np.full(shape, -0.8) + 0.1 * rng.standard_normal(shape)
    raise KeyError(f"no fill rule for parameter {'/'.join(path)} {shape}")


def fill_tree(shapes, rng, path=()):
    if isinstance(shapes, dict) or hasattr(shapes, "items"):
        return {k: fill_tree(v, rng, path + (k,)) for k, v in sorted(shapes.items())}
    return np.asarray(_fill(path, tuple(shapes.shape), rng), np.float32)


def random_params(module, rng, *args, method=None, **kwargs):
    """Seeded numpy parameter tree with the shapes of ``module.init(...)``."""
    shapes = jax.eval_shape(
        lambda: module.init(jax.random.PRNGKey(0), *args, method=method, **kwargs))["params"]
    return fill_tree(shapes, rng)


def nchw(x_nhwc, dtype=torch.float32):
    """numpy NHWC -> torch NCHW in channels_last memory."""
    t = torch.tensor(np.asarray(x_nhwc)).to(dtype)
    return t.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


def nhwc(t_nchw):
    """torch NCHW -> numpy NHWC float32."""
    return t_nchw.detach().float().permute(0, 2, 3, 1).contiguous().numpy()


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-12))


def need_gpu():
    """Skip the calling test unless a CUDA device is present (decided when the
    test runs, never at import)."""
    import pytest

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode "
                    "(chip_smoke.py holds them against the plain versions on the card)")
