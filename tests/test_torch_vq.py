"""Port's codebook retrieval vs the JAX package (CPU).

Indices must be EXACTLY equal: the same float32 inputs, an argmin over
distances whose gaps on these seeded inputs are far above rounding; exact ties
(duplicated codes) must go to the lowest index in all three implementations.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glare_tpu.ops import vq as jvq
from glare_tpu_torch.ops import vq as tvq

from torch_port_util import need_gpu


def _data(seed, n, k, d=3):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, d)).astype(np.float32),
            rng.standard_normal((k, d)).astype(np.float32))


def _near_tie():
    z, e = _data(5, 130, 256)
    e[200] = e[7]          # exact duplicate: the lowest index must win
    e[131] = e[130]
    z[:40] = e[7]
    z[40:80] = e[130]
    z[80:100] = 0.5 * (e[3] + e[4]) + 1e-3 * (e[3] - e[4])  # just on e[3]'s side
    return z, e


@pytest.mark.parametrize("case", ["random", "near_tie"])
def test_ref_matches_jax_ref(case):
    z, e = _data(0, 257, 512) if case == "random" else _near_tie()
    got = tvq.nearest_code(torch.from_numpy(z), torch.from_numpy(e))
    want = np.asarray(jvq.nearest_code_ref(jnp.asarray(z), jnp.asarray(e)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    if case == "near_tie":
        assert (got[:40] == 7).all() and (got[40:80] == 130).all()


@pytest.mark.parametrize("case", ["random", "near_tie"])
def test_ref_matches_pallas_interpret(case, monkeypatch):
    from jax.experimental import pallas as pl

    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    z, e = _data(1, 300, 1024) if case == "random" else _near_tie()
    got = tvq.nearest_code_ref(torch.from_numpy(z), torch.from_numpy(e), chunk=128).numpy()
    want = np.asarray(jvq.nearest_code_pallas(jnp.asarray(z), jnp.asarray(e),
                                              block_n=128, block_k=128))
    np.testing.assert_array_equal(got, want)


def test_matches_naive_float64():
    z, e = _data(2, 100, 333, d=7)
    d = ((z[:, None, :].astype(np.float64) - e[None].astype(np.float64)) ** 2).sum(-1)
    got = tvq.nearest_code(torch.from_numpy(z), torch.from_numpy(e)).numpy()
    np.testing.assert_array_equal(got, d.argmin(1))


def test_cuda_wrapper_refuses_cpu_tensors():
    z, e = _data(3, 4, 8)
    with pytest.raises(ValueError):
        tvq.nearest_code_cuda(torch.from_numpy(z), torch.from_numpy(e))
    assert tvq.launches == 0


@pytest.mark.gpu
def test_kernel_matches_ref_on_gpu():
    need_gpu()
    z, e = _near_tie()
    zt, et = torch.from_numpy(z).cuda(), torch.from_numpy(e).cuda()
    before = tvq.launches
    got = tvq.nearest_code(zt, et)
    assert tvq.launches == before + 1
    assert (got.cpu() == tvq.nearest_code_ref(zt, et).cpu()).all()
