"""Port's DCNv2 op, DCNv2Pack and WarpBlock vs the JAX package (CPU).

Oracles: the JAX exact op (``ops/dcn.py``), the Pallas clamped kernel in
interpret mode (int and per-tap radii, as tests/test_dcn_pallas.py runs it) and
the numpy transcription of the reference CUDA indexing (``golden_dcn.py``, torch
layouts, so the offset-channel packing is exercised too). Tolerance 2e-4
absolute (the JAX tests' own): all sides are float32 and differ in the order of
the 9*C-term sums and of the four bilinear corners.
"""

import math

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
    the Pallas kernel itself is covered above in interpret mode). The pack
    builds its clamp table once, in ``configure``, not per forward."""
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
    table = blk.dcn.clamp_radii
    assert table.tolist() == [[2.0 if impl == "pallas" else math.inf] * 9] * blk.dcn.G
    got = nhwc(blk(nchw(x_vq), nchw(h)))
    np.testing.assert_allclose(got, want, atol=2e-4)
    assert blk.dcn.clamp_radii is table
    off, _ = blk.dcn.offsets_and_mask(blk.offset(torch.cat([nchw(x_vq), nchw(h)], 1)))
    n_beyond = int((off.abs().amax(-1) > 2).sum())
    assert n_beyond > 0, "test inputs must exercise the clamp"
    if impl == "pallas":
        assert blk.dcn.dcn_overflow.tolist() == [0, n_beyond]
    else:
        assert blk.dcn.dcn_overflow is None
    per_tap = tuple(tuple(1 + (g + k) % 3 for k in range(9)) for g in range(blk.dcn.G))
    blk.dcn.configure("pallas", per_tap)          # a new table only from configure
    assert blk.dcn.clamp_radii.tolist() == [list(map(float, r)) for r in per_tap]


@pytest.mark.parametrize("impl", ["chain", "hybrid", "hybrid_gather"])
def test_unported_impls_raise(impl):
    if impl == "hybrid":  # the cascade is ported (tests/test_torch_dcn_cascade.py)
        assert DCNv2Pack(8, 8, impl=impl).impl == "hybrid"
        return
    if impl == "chain":  # ported: one clamp radius, the largest of a per-tap table
        per_tap = tuple(tuple(1 + (g + k) % 3 for k in range(9)) for g in range(4))
        pack = DCNv2Pack(8, 8, impl=impl, max_offset=per_tap)
        assert pack.impl == "chain" and bool((pack.clamp_radii == 3.0).all())
        return
    # hybrid_gather: ported (tests/test_torch_dcn_gather.py); it builds and configures,
    # a per-tap table kept for its forward to collapse, and an unknown impl raises
    per_tap = tuple(tuple(1 + (g + k) % 3 for k in range(9)) for g in range(4))
    pack = DCNv2Pack(8, 8, impl=impl, max_offset=per_tap, hybrid_capacity=0.25)
    assert (pack.impl, pack.max_offset, pack.hybrid_capacity) == (impl, per_tap, 0.25)
    pack = DCNv2Pack(8, 8, impl="xla")
    pack.configure(impl, 3, 0.5)
    assert (pack.impl, pack.max_offset, pack.hybrid_capacity) == (impl, 3, 0.5)
    with pytest.raises(ValueError, match="not one of"):
        pack.configure("gather", 2)
    assert pack.impl == impl


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


# ---- routing and the envelope of the Hopper entry (no kernel runs here) ----

def _shaped(B, H, W, C, G, O, dtype=torch.bfloat16):
    return (torch.zeros(B, H, W, C, dtype=dtype), torch.zeros(B, H, W, G, 9, 2),
            torch.ones(B, H, W, G, 9), torch.zeros(3, 3, C, O))


@pytest.mark.parametrize("shape,dtype,want", [
    ((1, 210, 310, 256, 4, 256), torch.bfloat16, "hopper"),   # warp_0 of the paths
    ((2, 420, 620, 128, 4, 128), torch.bfloat16, "hopper"),   # warp_1, batch 2
    ((1, 9, 70, 64, 2, 128), torch.bfloat16, "hopper"),       # Cg 32
    ((1, 9, 70, 256, 2, 256), torch.bfloat16, "hopper"),      # Cg 128
    ((1, 9, 70, 64, 4, 128), torch.bfloat16, "wmma"),         # Cg 16
    ((1, 210, 310, 256, 4, 256), torch.float32, "f32"),
    ((2, 13, 17, 32, 4, 48), torch.bfloat16, "wmma"),         # C not a multiple of 64
    ((1, 9, 70, 128, 4, 64), torch.bfloat16, "wmma"),         # O not 128 or 256
    ((1, 9, 70, 192, 4, 128), torch.bfloat16, "wmma"),        # Cg 48
    # the tiled float32 entry's envelope: C % 16, Cg % 8, O in (64, 128, 256)
    ((2, 256, 256, 128, 4, 128), torch.float32, "f32"),       # warp_1 of the training step
    ((1, 9, 70, 16, 2, 64), torch.float32, "f32"),            # the smallest: one K chunk, Cg 8
    ((1, 9, 70, 48, 6, 256), torch.float32, "f32"),           # Cg 8, three K chunks
    ((1, 9, 70, 24, 4, 20), torch.float32, "f32_flat"),       # C % 16
    ((1, 9, 70, 32, 8, 64), torch.float32, "f32_flat"),       # Cg 4
    ((1, 9, 70, 128, 4, 96), torch.float32, "f32_flat"),      # O not a width it serves
    ((1, 9, 70, 128, 4, 512), torch.float32, "f32_flat"),     # O above 256 (refused later by both)
], ids=lambda v: str(v).replace(" ", ""))
def test_route_choice_by_dtype_and_widths(shape, dtype, want):
    B, H, W, C, G, O = shape
    x, off, mask, w = _shaped(1, 2, 3, C, G, O, dtype)
    assert tdcn.route(x, off, w) == want
    assert tdcn.hopper_envelope(dtype, C, O, G) == (want == "hopper")
    assert tdcn.f32_envelope(dtype, C, O, G) == (want == "f32")


@pytest.mark.parametrize("shape,entry", [
    ((1, 5, 6, 32, 4, 48), "hopper"),      # C % 64
    ((1, 5, 6, 128, 4, 64), "hopper"),     # O
    ((1, 5, 6, 192, 4, 128), "hopper"),    # Cg 48
    ((1, 5, 6, 64, 4, 128), "hopper"),     # Cg 16
    ((1, 5, 6, 128, 4, 128), "f32"),       # bf16 inputs on the float32 entry
    ((1, 5, 6, 24, 4, 20), "wmma"),        # C, O not multiples of 16
    ((1, 5, 6, 128, 4, 128), "tensor"),    # no such entry
    # float32 inputs outside the tiled f32 entry's envelope, bf16 on the flat one
    ((1, 5, 6, 24, 4, 64, torch.float32), "f32"),     # C % 16
    ((1, 5, 6, 32, 8, 64, torch.float32), "f32"),     # Cg 4
    ((1, 5, 6, 128, 4, 96, torch.float32), "f32"),    # O
    ((1, 5, 6, 128, 4, 128), "f32_flat"),             # bf16 inputs on the flat float32 entry
    ((1, 5, 6, 128, 4, 128, torch.float32), "hopper"),  # float32 inputs on a bf16 entry
])
def test_wrappers_refuse_shapes_outside_the_envelope(shape, entry):
    """Refused before any device work, the launch counters untouched."""
    B, H, W, C, G, O, *dtype = shape
    t = _shaped(B, H, W, C, G, O, *dtype)
    before = (tdcn.launches, tdcn.cascade_launches, tdcn.select_launches,
              dict(tdcn.launches_by_entry), dict(tdcn.cascade_launches_by_entry))
    with pytest.raises(ValueError, match="does not take|multiples of 16"):
        tdcn.modulated_deform_conv_cuda(*t, max_offset=2, entry=entry)
    with pytest.raises(ValueError, match="does not take|multiples of 16"):
        tdcn.modulated_deform_conv_cascade_cuda(*t, entry=entry)
    assert before == (tdcn.launches, tdcn.cascade_launches, tdcn.select_launches,
                      dict(tdcn.launches_by_entry), dict(tdcn.cascade_launches_by_entry))


def test_row_radius_table_is_the_selection():
    """cascade_row_radius (the selection kernel's plain version): R_tail on the
    rows of the selected blocks, R elsewhere, the same counters."""
    rng = np.random.default_rng(8)
    off = rng.uniform(-2, 2, (2, 37, 4, 2, 9, 2)).astype(np.float32)
    off[0, 3, 1, 0, 4, 0] = 2.5
    off[1, 30, 2, 1, 7, 1] = -9.0
    t = torch.from_numpy(off)
    rows, ov = tdcn.cascade_selection(t, 2, 8, 0.125)
    rr, ov2 = tdcn.cascade_row_radius(t, 2, 8, 0.125)
    assert rr.dtype == torch.float32 and rr.shape == (2, 37)
    assert torch.equal(rr, torch.where(rows, 8.0, 2.0)) and ov2.tolist() == ov.tolist() == [0, 1]
    assert rows[0, :8].all() and rows[1, 24:32].all() and int(rows.sum()) == 16
    with pytest.raises(ValueError, match="CUDA"):
        tdcn.cascade_select_cuda(t)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 13, 17, 128, 4, 128), (1, 9, 70, 48, 6, 256), (2, 5, 21, 16, 2, 64)])
def test_f32_tiled_kernel_matches_ref_on_gpu(shape):
    """The tiled float32 entry (route f32): ragged 8 x 16 tiles, every O it
    serves, Cg 8 to 32; one launch of the entry; 2e-4 of the plain version."""
    need_gpu()
    t = [torch.from_numpy(a).cuda() for a in _inputs(9, *shape, spread=3.0)]
    assert tdcn.route(t[0], t[1], t[3]) == "f32"
    before = dict(tdcn.launches_by_entry)
    got = tdcn.modulated_deform_conv(*t, max_offset=2)
    assert tdcn.launches_by_entry == {e: n + (e == "f32") for e, n in before.items()}
    want = tdcn.modulated_deform_conv_ref(*t, max_offset=2)
    assert float((got - want).abs().max()) <= 2e-4


@pytest.mark.gpu
def test_hopper_kernel_matches_ref_on_gpu():
    need_gpu()
    t = [torch.from_numpy(a).cuda() for a in _inputs(7, 2, 13, 17, 128, 4, 128, spread=1.5)]
    t[0] = t[0].to(torch.bfloat16)
    before = dict(tdcn.launches_by_entry)
    got, ov = tdcn.modulated_deform_conv(*t, max_offset=2, return_overflow=True)
    assert tdcn.launches_by_entry["hopper"] == before["hopper"] + 1
    want, wov = tdcn.modulated_deform_conv_ref(*t, max_offset=2, return_overflow=True)
    assert ov.tolist() == wov.tolist()
    assert (got.float() - want.float()).abs().max() <= 2 ** -7 * max(1.0, float(want.float().abs().max()))
