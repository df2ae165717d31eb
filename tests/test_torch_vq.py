"""Port's codebook retrieval vs the JAX package (CPU).

Indices must be EXACTLY equal: the same float32 inputs, an argmin over
distances whose gaps on these seeded inputs are far above rounding; exact ties
(duplicated codes) must go to the lowest index in all three implementations,
also where the duplicates sit on the boundaries of the CUDA kernel's 16
codebook slices (``ops.vq.layout`` reports them on the GPU). Tokens also come
in bf16 and in the layouts ``VectorQuantizer2`` hands over. The small cases
share one shape (130 tokens, 256 codes), so the Pallas kernel is traced in
interpret mode once for all of them.
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


def _split_dups():
    """Duplicates across the kernel's slices of a 256-code book (16 slices of
    16): each slice's first code copies the previous slice's last, the upper
    half copies codes of the lower, the last code the first."""
    z, e = _data(6, 130, 256)
    per = 16
    for s in range(1, 16):
        e[s * per] = e[s * per - 1]
    e[130:138] = e[2:10]
    e[255] = e[0]
    z[:15] = e[[s * per for s in range(1, 16)]]
    z[15:23] = e[130:138]
    z[23] = e[255]
    return z, e


def _quantizer_input(z_flat, b):
    """What VectorQuantizer2 hands to nearest_code for an NCHW latent holding
    the 130 tokens ``z_flat`` (B = b): at B = 1 a strided view, strides
    (1, H*W); at B = 2 the contiguous copy that its reshape makes."""
    from glare_tpu_torch.modules.quantize import VectorQuantizer2

    lat = torch.from_numpy(z_flat.reshape(b, 10 // b, 13, 3)).permute(0, 3, 1, 2).contiguous()
    vq = VectorQuantizer2(n_e=4, e_dim=3)
    seen = []
    orig = tvq.nearest_code
    tvq.nearest_code = lambda z, e: seen.append(z) or orig(z, e)
    try:
        vq(lat)
    finally:
        tvq.nearest_code = orig
    return seen[0]


def _case(name, seed_data):
    """-> (tokens as the port gets them, the same values as float32 numpy, codes)."""
    if name == "random":
        z, e = seed_data
        return torch.from_numpy(z), z, e
    z, e = {"near_tie": _near_tie, "split_dups": _split_dups}.get(name, lambda: _data(7, 130, 256))()
    if name == "bf16_z":
        zt = torch.from_numpy(z).to(torch.bfloat16)
        return zt, zt.float().numpy(), e
    if name.startswith("quantizer_b"):
        zt = _quantizer_input(z, int(name[-1]))
        assert zt.is_contiguous() == (name == "quantizer_b2")
        return zt, z, e
    return torch.from_numpy(z), z, e


CASES = ["random", "near_tie", "split_dups", "bf16_z", "quantizer_b1", "quantizer_b2"]


@pytest.mark.parametrize("case", CASES)
def test_ref_matches_jax_ref(case):
    zt, z, e = _case(case, _data(0, 257, 512))
    got = tvq.nearest_code(zt, torch.from_numpy(e))
    want = np.asarray(jvq.nearest_code_ref(jnp.asarray(z), jnp.asarray(e)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    if case == "near_tie":
        assert (got[:40] == 7).all() and (got[40:80] == 130).all()
    if case == "split_dups":
        np.testing.assert_array_equal(got[:15].numpy(), np.arange(15) * 16 + 15)
        np.testing.assert_array_equal(got[15:24].numpy(), [2, 3, 4, 5, 6, 7, 8, 9, 0])


@pytest.mark.parametrize("case", CASES)
def test_ref_matches_pallas_interpret(case, monkeypatch):
    from jax.experimental import pallas as pl

    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    zt, z, e = _case(case, _data(1, 300, 1024))
    got = tvq.nearest_code_ref(zt, torch.from_numpy(e), chunk=128).numpy()
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
    zt, et = torch.from_numpy(z), torch.from_numpy(e)
    # inputs the kernel takes, but on the CPU
    for zz, ee in [(zt, et), (zt.to(torch.bfloat16), et),
                   (torch.from_numpy(_data(3, 4, 1, d=6)[0])[:, ::2], et),
                   (zt.t().contiguous().t(), et.t().contiguous().t())]:
        with pytest.raises(ValueError, match="needs CUDA tensors"):
            tvq.nearest_code_cuda(zz, ee)
    # dtypes and shapes it does not take
    for zz, ee, msg in [(zt.half(), et, "float32 or bfloat16"), (zt.double(), et, "float32 or bfloat16"),
                        (zt, et.to(torch.int32), "float32 or bfloat16"),
                        (zt, et.to(torch.bfloat16), "float32 codebook"),
                        (zt[:, 0], et, r"expected z \[N, D\]"), (zt[:, :2], et, r"expected z \[N, D\]"),
                        (zt, et[None], r"expected z \[N, D\]"), (zt, et[:0], "empty codebook"),
                        (zt[:, :0], et[:, :0], "empty codebook")]:
        with pytest.raises(ValueError, match=msg):
            tvq.nearest_code_cuda(zz, ee)
    assert tvq.launches == 0


@pytest.mark.gpu
def test_kernel_matches_ref_on_gpu():
    need_gpu()
    cases = [_near_tie(), _split_dups()]
    # K = 8192: duplicates across every slice boundary of the kernel and across halves
    z, e = _data(8, 2000, 8192)
    per = tvq.layout(8192, 3)["codes_per_slice"]
    assert tvq.layout(256, 3)["codes_per_slice"] == 16   # the slices of _split_dups
    for s in range(1, 16):
        e[s * per] = e[s * per - 1]
    e[4096:4112] = e[100:116]
    e[8191] = e[0]
    z[:15] = e[[s * per for s in range(1, 16)]]
    z[15:31] = e[4096:4112]
    z[31] = e[8191]
    cases.append((z, e))
    for z, e in cases:
        zt, et = torch.from_numpy(z).cuda(), torch.from_numpy(e).cuda()
        before = tvq.launches
        got = tvq.nearest_code(zt, et)
        assert tvq.launches == before + 1
        assert (got.cpu() == tvq.nearest_code_ref(zt, et).cpu()).all()
    assert (got[:15].cpu().numpy() == np.arange(15) * per + per - 1).all()
    assert (got[15:32].cpu().numpy() == list(range(100, 116)) + [0]).all()
