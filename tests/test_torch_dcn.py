"""Port's DCNv2 op, DCNv2Pack and WarpBlock vs the JAX package (CPU).

Oracles: the JAX exact op (``ops/dcn.py``), the Pallas clamped kernel in
interpret mode (int and per-tap radii, as tests/test_dcn_pallas.py runs it) and
the numpy transcription of the reference CUDA indexing (``golden_dcn.py``, torch
layouts, so the offset-channel packing is exercised too). Tolerance 2e-4
absolute (the JAX tests' own): all sides are float32 and differ in the order of
the 9*C-term sums and of the four bilinear corners.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glare_tpu.modules.deformable_decoder import WarpBlock as JWarpBlock
from glare_tpu.ops.dcn import modulated_deform_conv as jdcn
from glare_tpu.ops.dcn_pallas import modulated_deform_conv_pallas as jdcn_pallas
from glare_tpu_torch import convert
from glare_tpu_torch.modules.deformable_decoder import DCNv2Pack, WarpBlock
from glare_tpu_torch.ops import dcn as tdcn

from golden_dcn import modulated_deform_conv_golden_fast
from torch_port_util import need_gpu, nchw, nhwc, random_params


@pytest.fixture(autouse=True)
def _no_grad():
    with torch.no_grad():
        yield

PER_TAP = ((1, 1, 2, 1, 1, 1, 1, 1, 1), (1, 1, 1, 1, 1, 2, 1, 1, 1))


def _inputs(seed, B, H, W, C, G, O, spread=3.0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, H, W, C)).astype(np.float32)
    off = (spread * rng.standard_normal((B, H, W, G, 9, 2))).astype(np.float32)
    off[:, 0, 0] = -7.5          # samples that leave the image entirely
    off[:, -1, -1] = 7.25
    off[:, 0, -1, :, :, 0] = -1.0  # exactly on the (-1, H) border
    mask = rng.uniform(0, 1, (B, H, W, G, 9)).astype(np.float32)
    w = (0.2 * rng.standard_normal((3, 3, C, O))).astype(np.float32)
    b = (0.1 * rng.standard_normal(O)).astype(np.float32)
    return x, off, mask, w, b


def _port(x, off, mask, w, b, rows_per_chunk=None, **kw):
    t = map(torch.from_numpy, (x, off, mask, w, b))
    if rows_per_chunk is not None:
        return tdcn.modulated_deform_conv_ref(*t, rows_per_chunk=rows_per_chunk, **kw).numpy()
    return tdcn.modulated_deform_conv(*t, **kw).numpy()


@pytest.mark.parametrize("shape", [(2, 7, 9, 8, 2, 6), (1, 5, 11, 12, 4, 5)])
def test_exact_matches_jax_xla_and_golden(shape):
    x, off, mask, w, b = _inputs(0, *shape)
    got = _port(x, off, mask, w, b)
    want = np.asarray(jdcn(*map(jnp.asarray, (x, off, mask, w, b))))
    np.testing.assert_allclose(got, want, atol=2e-4)
    # the plain version's row chunking (bounds its gather buffers) changes nothing
    np.testing.assert_array_equal(got, _port(x, off, mask, w, b, rows_per_chunk=3))
    B, H, W, C, G, O = shape
    gold = modulated_deform_conv_golden_fast(
        x.transpose(0, 3, 1, 2), off.reshape(B, H, W, G * 18).transpose(0, 3, 1, 2),
        mask.reshape(B, H, W, G * 9).transpose(0, 3, 1, 2), w.transpose(3, 2, 0, 1), b,
        deformable_groups=G)
    np.testing.assert_allclose(got, gold.transpose(0, 2, 3, 1), atol=2e-4)


@pytest.mark.parametrize("max_offset,G", [(2, 1), (PER_TAP, 2)], ids=["int2", "per_tap"])
def test_clamped_matches_pallas_interpret(max_offset, G):
    x, off, mask, w, b = _inputs(1, 1, 4, 12, 8, G, 8)
    got = _port(x, off, mask, w, b, max_offset=max_offset)
    want = np.asarray(jdcn_pallas(*map(jnp.asarray, (x, off, mask, w, b)), max_offset=max_offset,
                                  interpret=True, rows_per_step=2))
    np.testing.assert_allclose(got, want, atol=2e-4)
    # and the clamp is the JAX exact op on clipped offsets
    r = np.asarray(tdcn.clamp_table(max_offset, G))[None, None, None, :, :, None]
    want2 = np.asarray(jdcn(*map(jnp.asarray, (x, np.clip(off, -r, r), mask, w, b))))
    np.testing.assert_allclose(got, want2, atol=2e-4)


def test_bf16_plain_version_rounds_like_its_docstring():
    x, off, mask, w, b = _inputs(2, 1, 5, 6, 16, 4, 16)
    t = [torch.from_numpy(a) for a in (x, off, mask, w, b)]
    got = tdcn.modulated_deform_conv(t[0].to(torch.bfloat16), *t[1:], max_offset=2)
    want = tdcn.modulated_deform_conv(t[0].to(torch.bfloat16).float(), t[1], t[2],
                                      t[3].to(torch.bfloat16).float(), t[4], max_offset=2)
    assert got.dtype == torch.bfloat16
    # differs only by rounding the sampled column and the result to bf16: 2^-7 relative
    assert (got.float() - want).abs().max() < 2 ** -7 * want.abs().max() + 2 ** -7


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_warpblock_matches_jax(impl):
    """WarpBlock / DCNv2Pack with carried weights and a NON-zero conv_offset, so
    the offset-channel packing carried by ``convert`` is exercised. The JAX side
    of 'pallas' runs its XLA-dense equivalent 'chain' (same clamped semantics;
    the Pallas kernel itself is covered above in interpret mode)."""
    rng = np.random.default_rng(3)
    x_vq = rng.standard_normal((2, 6, 8, 16)).astype(np.float32)
    h = rng.standard_normal((2, 6, 8, 16)).astype(np.float32)
    jimpl = "chain" if impl == "pallas" else "xla"
    jblk = JWarpBlock(dcn_impl=jimpl, dcn_max_offset=2)
    params = random_params(jblk, rng, jnp.asarray(x_vq), jnp.asarray(h))
    want = np.asarray(jax.jit(lambda p, a, c: jblk.apply({"params": p}, a, c))(
        params, jnp.asarray(x_vq), jnp.asarray(h)))
    blk = WarpBlock(16, dcn_impl=impl, dcn_max_offset=2)
    sd = {}
    convert._put_conv(sd, "offset", params["offset"])
    convert._put_dcnpack(sd, "dcn", params["dcn"])
    blk.load_state_dict(sd)
    got = nhwc(blk(nchw(x_vq), nchw(h)))
    np.testing.assert_allclose(got, want, atol=2e-4)
    off, _ = blk.dcn.offsets_and_mask(blk.offset(torch.cat([nchw(x_vq), nchw(h)], 1)))
    n_beyond = int((off.abs().amax(-1) > 2).sum())
    assert n_beyond > 0, "test inputs must exercise the clamp"
    if impl == "pallas":
        assert blk.dcn.dcn_overflow.tolist() == [0, n_beyond]
    else:
        assert blk.dcn.dcn_overflow is None


@pytest.mark.parametrize("impl", ["chain", "hybrid", "hybrid_gather"])
def test_unported_impls_raise(impl):
    with pytest.raises(NotImplementedError, match="later slice"):
        DCNv2Pack(8, 8, impl=impl)


def test_cuda_wrapper_refuses_cpu_tensors():
    t = [torch.from_numpy(a) for a in _inputs(4, 1, 3, 3, 4, 2, 4)]
    with pytest.raises(ValueError):
        tdcn.modulated_deform_conv_cuda(*t)
    assert tdcn.launches == 0


@pytest.mark.gpu
def test_kernel_matches_ref_on_gpu():
    need_gpu()
    t = [torch.from_numpy(a).cuda() for a in _inputs(5, 2, 13, 17, 24, 4, 20)]
    before = tdcn.launches
    got = tdcn.modulated_deform_conv(*t, max_offset=PER_TAP + PER_TAP)
    assert tdcn.launches == before + 1
    want = tdcn.modulated_deform_conv_ref(*t, max_offset=PER_TAP + PER_TAP)
    assert (got - want).abs().max() < 2e-4
