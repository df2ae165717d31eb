"""Port's foundation layers vs the JAX package with carried weights (CPU, f32).

Tolerance 1e-4 relative to the largest output: both sides are float32; they
differ in the order of the convolutions' sums and in GroupNorm's variance
formula.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glare_tpu.nn import layers as jl
from glare_tpu_torch import convert
from glare_tpu_torch.nn import layers as tl

from torch_port_util import nchw, nhwc, random_params, rel_err


@pytest.fixture(autouse=True)
def _no_grad():
    with torch.no_grad():
        yield


def _x(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _apply(jmod, params, x):
    return np.asarray(jax.jit(lambda p, a: jmod.apply({"params": p}, a))(params, jnp.asarray(x)))


def _sd(put, params):
    sd = {}
    put(sd, "m", params)
    return {k[2:]: v for k, v in sd.items()}


def test_swish():
    x = _x(0, (3, 5))
    np.testing.assert_allclose(tl.swish(torch.from_numpy(x)).numpy(),
                               np.asarray(jl.swish(jnp.asarray(x))), atol=1e-6)


@pytest.mark.parametrize("k,stride,pad,jpad", [(3, 1, 1, 1), (1, 1, 0, 0), (3, 2, 0, "VALID")])
def test_conv(k, stride, pad, jpad):
    x = _x(1, (2, 9, 8, 6))
    jmod = jl.Conv(10, (k, k), strides=(stride, stride), padding=jpad)
    params = random_params(jmod, np.random.default_rng(1), jnp.asarray(x))
    mod = tl.Conv(6, 10, k, stride=stride, padding=pad)
    mod.load_state_dict(_sd(convert._put_conv, params))
    assert rel_err(nhwc(mod(nchw(x))), _apply(jmod, params, x)) < 1e-4


def test_conv_seeded_init_bounds_and_zero_init():
    g = torch.Generator().manual_seed(0)
    mod = tl.seed_init_(tl.Conv(8, 4, 3, padding=1), g)
    bound = 1.0 / np.sqrt(8 * 9)
    assert float(mod.weight.abs().max()) <= bound and float(mod.bias.abs().max()) <= bound
    assert float(mod.weight.std()) > 0.4 * bound
    z = tl.seed_init_(tl.Conv(8, 4, 3, padding=1, zero_init=True), g)
    assert float(z.weight.abs().max()) == 0.0 and float(z.bias.abs().max()) == 0.0
    again = tl.seed_init_(tl.Conv(8, 4, 3, padding=1), torch.Generator().manual_seed(0))
    assert torch.equal(again.weight, mod.weight)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_groupnorm32(dtype):
    x = _x(2, (2, 5, 7, 64)) * 3.0 + 1.0
    jmod = jl.GroupNorm32()
    params = random_params(jmod, np.random.default_rng(2), jnp.asarray(x))
    mod = tl.GroupNorm32(64)
    mod.load_state_dict({"weight": torch.from_numpy(params["GroupNorm_0"]["scale"]),
                         "bias": torch.from_numpy(params["GroupNorm_0"]["bias"])})
    jx = jnp.asarray(x).astype(dtype)
    want = np.asarray(jmod.apply({"params": params}, jx).astype(jnp.float32))
    got = mod(nchw(x, getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    # bf16: statistics are f32 on both sides, only the result is rounded (2^-8)
    assert rel_err(nhwc(got), want) < (1e-4 if dtype == "float32" else 2 ** -7)


def test_upsample_downsample():
    x = _x(3, (1, 6, 5, 8))
    for jmod, mod, put in [
        (jl.Upsample(), tl.Upsample(8), lambda sd, n, p: convert._put_conv(sd, n + ".conv", p["conv"])),
        (jl.Downsample(), tl.Downsample(8), lambda sd, n, p: convert._put_conv(sd, n + ".conv", p["conv"])),
    ]:
        params = random_params(jmod, np.random.default_rng(3), jnp.asarray(x))
        mod.load_state_dict(_sd(put, params))
        want = _apply(jmod, params, x)
        got = nhwc(mod(nchw(x)))
        assert got.shape == want.shape and rel_err(got, want) < 1e-4


@pytest.mark.parametrize("out_ch", [None, 64])
def test_resnet_block(out_ch):
    x = _x(4, (2, 6, 6, 32))
    jmod = jl.ResnetBlock(out_channels=out_ch)
    params = random_params(jmod, np.random.default_rng(4), jnp.asarray(x))
    mod = tl.ResnetBlock(32, out_ch)
    mod.load_state_dict(_sd(convert._put_resblock, params))
    assert rel_err(nhwc(mod(nchw(x))), _apply(jmod, params, x)) < 1e-4


def test_attn_block_bf16_dense_path():
    """bf16 network: both sides store the [n, n] scores and probabilities in bf16
    (three roundings of 2^-8 before the PV product): 3e-2 of the largest output."""
    x = _x(5, (1, 5, 6, 32))
    jmod = jl.AttnBlock(dtype=jnp.bfloat16)
    params = random_params(jmod, np.random.default_rng(5), jnp.asarray(x))
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(x).astype(jnp.bfloat16))
                      .astype(jnp.float32))
    mod = tl.AttnBlock(32)
    mod.load_state_dict(_sd(convert._put_attn, params))
    tl.cast_convs_(mod, torch.bfloat16)
    got = mod(nchw(x, torch.bfloat16))
    assert got.dtype == torch.bfloat16 and mod.norm.weight.dtype == torch.float32
    assert rel_err(nhwc(got), want) < 3e-2
