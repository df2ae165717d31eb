"""The port's DCN cascade (``dcn_impl: hybrid``) vs the JAX package (CPU).

Oracle for outputs and counters: ``modulated_deform_conv_pallas_cascade`` in
interpret mode at ``rows_per_step=4``, on the shapes of
``tests/test_dcn_pallas.py::TestCascade`` (two images of 40 rows: 20 blocks, 22
counted, 8 slots at capacity 8/20). One interpret-mode trace costs over a minute
on one core, so the cases share ONE trace: the same shapes and static arguments,
and only the offsets differ -- inside R_tail, the 12-blocks-into-8-slots oracle,
every tap beyond R_tail, and wide random offsets that degrade to the base.
Tolerance 2e-4 absolute in float32, the JAX tests' own (order of the 9*C-term
sums and of the four bilinear corners).

Oracle for the selection rule at the shipped block sizes (16 rows, 8 from
R_tail 6 on), where interpret mode is too slow: a numpy loop over blocks.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glare_tpu.ops.dcn import modulated_deform_conv as jdcn
from glare_tpu.ops.dcn_pallas import modulated_deform_conv_pallas_cascade as jcascade
from glare_tpu_torch.modules.deformable_decoder import DCNv2Pack
from glare_tpu_torch.ops import dcn as tdcn

from torch_port_util import need_gpu


@pytest.fixture(autouse=True)
def _no_grad():
    with torch.no_grad():
        yield


def _port(x, off, m, w, b, **kw):
    t = [None if a is None else torch.from_numpy(a) for a in (x, off, m, w, b)]
    out, ov = tdcn.modulated_deform_conv_cascade(*t, return_overflow=True, **kw)
    return out.numpy(), ov.tolist()


def _jax(x, off, m, w, b, **kw):
    a = [None if v is None else jnp.asarray(v) for v in (x, off, m, w, b)]
    out, ov = jcascade(*a, interpret=True, return_overflow=True, **kw)
    return np.asarray(out), np.asarray(ov).tolist()


# ---- one trace: B=2, H=40, rows_per_step=4 -> 20 blocks (22 counted), 8 slots ----

SHAPE = (2, 40, 8, 4, 4, 1)   # B, H, W, C, O, G
KW = dict(max_offset=2, tail_offset=3, capacity_frac=8 / 20, rows_per_step=4)
CASES = ["exact_within_tail", "blocks_12_into_8_slots", "all_beyond_tail", "degrade"]


def _case(case):
    """-> ((x, off, m, w, b), expected counters, rows recomputed at R_tail [B, H])."""
    B, H, W, C, O, G = SHAPE
    rng = np.random.RandomState(5)
    x = rng.standard_normal((B, H, W, C)).astype(np.float32)
    m = rng.rand(B, H, W, G, 9).astype(np.float32)
    w = (0.2 * rng.standard_normal((3, 3, C, O))).astype(np.float32)
    b = rng.standard_normal(O).astype(np.float32)
    off = np.clip(1.5 * rng.standard_normal((B, H, W, G, 9, 2)), -2, 2).astype(np.float32)
    wide = np.clip(3.0 * rng.standard_normal((B, H, W, G, 9, 2)), -2.9, 2.9).astype(np.float32)
    tail_rows = np.zeros((B, H), bool)
    if case == "exact_within_tail":          # two out-of-band blocks, inside R_tail: both fit
        off[0, 4:6] = wide[0, 4:6]
        off[1, 13:15] = wide[1, 13:15]
        tail_rows[0, 4:8] = tail_rows[1, 12:16] = True
        want_ov = [0, 0]
    elif case == "blocks_12_into_8_slots":   # 6 blocks of each image carry one 2.5 px tap
        off[:] = 0.0
        for r in (0, 4, 8, 12, 16, 20):
            off[:, r, 3, 0, 4, 0] = 2.5      # centre tap of an inner pixel: 2 vs 2.5 px differ
            tail_rows[0, r:r + 4] = True     # flat (image, block) order: all 6 of image 0 ...
        tail_rows[1, 0:8] = True             # ... and the first 2 of image 1 find a slot
        want_ov = [4, 0]
    elif case == "all_beyond_tail":          # every tap at 5 px: 20 blocks, 8 slots
        off[:] = 5.0
        tail_rows[0, :32] = True
        want_ov = [12, B * H * W * G * 9]
    else:                                    # "degrade": wide random offsets everywhere
        off = (4.0 * rng.standard_normal((B, H, W, G, 9, 2))).astype(np.float32)
        tail_rows[0, :32] = True
        want_ov = [12, int((np.abs(off).max(-1) > 3).sum())]
    return (x, off, m, w, b), want_ov, tail_rows


@pytest.mark.parametrize("case", CASES)
def test_cascade_matches_pallas_interpret(case):
    args, want_ov, tail_rows = _case(case)
    got, ov = _port(*args, **KW)
    want, jov = _jax(*args, **KW)
    assert ov == jov == want_ov
    np.testing.assert_allclose(got, want, atol=2e-4)
    # the selection, spelled out: R_tail on the selected blocks' rows, R everywhere
    # else -- the blocks that found no slot included
    t = [torch.from_numpy(a) for a in args]
    base = tdcn.modulated_deform_conv_ref(*t, max_offset=2).numpy()
    tail = tdcn.modulated_deform_conv_ref(*t, max_offset=3).numpy()
    np.testing.assert_array_equal(got[tail_rows], tail[tail_rows])
    np.testing.assert_array_equal(got[~tail_rows], base[~tail_rows])
    exact = np.asarray(jdcn(*map(jnp.asarray, args)))
    if case == "exact_within_tail":
        # both counters zero <=> exact DCNv2
        np.testing.assert_allclose(got, exact, atol=2e-4)
        assert np.abs(base - exact).max() > 1e-2
    elif case == "blocks_12_into_8_slots":
        np.testing.assert_allclose(got[0], exact[0], atol=2e-4)
        np.testing.assert_allclose(got[1, :8], exact[1, :8], atol=2e-4)
        assert np.abs(got[1, 8:] - exact[1, 8:]).max() > 1e-3    # overflowed: clamp-R value
    else:
        assert np.isfinite(got).all()
        assert np.abs(got - exact).max() > 1e-2


# ---- the selection rule at the shipped block sizes, against a numpy loop ----

def _selection_oracle(off, R, Rt, cap, rows_per_step):
    B, H = off.shape[:2]
    rpb = min(rows_per_step, 8) if Rt >= 6 else rows_per_step
    n_rblk = -(-H // rpb) + 1                      # the extra block per image is counted
    n_blocks = B * n_rblk
    n_sel = max(1, min(n_blocks, -(-int(n_blocks * cap) // 8) * 8))
    linf = np.abs(off).max(axis=-1)
    rows = np.zeros((B, H), bool)
    n_oob = n_taken = 0
    for b in range(B):                              # flat (image, block) order
        for blk in range(n_rblk):
            r0, r1 = blk * rpb, min(H, (blk + 1) * rpb)
            if r0 < H and (linf[b, r0:r1] > R).any():
                n_oob += 1
                if n_taken < n_sel:
                    n_taken += 1
                    rows[b, r0:r1] = True
    return rows, [n_oob - n_taken, int((linf > Rt).sum())], n_sel


@pytest.mark.parametrize("B,H,R,Rt,cap,rps,p_row", [
    (1, 210, 2, 8, 0.125, 16, 0.02),   # 8-row blocks (R_tail >= 6), thin tail: fits
    (2, 210, 2, 8, 0.125, 16, 0.30),   # more out-of-band blocks than slots
    (2, 105, 2, 4, 0.125, 16, 0.10),   # 16-row blocks (R_tail < 6)
    (3, 37, 1, 5, 0.25, 16, 0.20),     # ragged last block
    (1, 50, 2, 16, 1.0, 16, 0.50),     # capacity 1.0: every block has a slot
    (2, 64, 2, 8, 1e-9, 8, 0.50),      # the minimum: one slot
])
def test_selection_rule_matches_numpy_oracle(B, H, R, Rt, cap, rps, p_row):
    rng = np.random.default_rng(B * 1000 + H)
    off = rng.uniform(-R, R, (B, H, 5, 2, 9, 2)).astype(np.float32)
    hot = rng.uniform(0, 1, (B, H)) < p_row        # rows that carry one wide tap
    off[hot, 0, 0, 0, 0] = R + 0.5
    off[:, H // 2, 1, 1, 3, 1] = -(Rt + 1.0)       # and a tap beyond R_tail
    want_rows, want_ov, n_sel = _selection_oracle(off, R, Rt, cap, rps)
    rows, ov = tdcn.cascade_selection(torch.from_numpy(off), R, Rt, cap, rps)
    assert ov.dtype == torch.int64 and ov.tolist() == want_ov
    np.testing.assert_array_equal(rows.numpy(), want_rows)
    assert tdcn.cascade_slots(B, H, tdcn.cascade_rows_per_block(Rt, rps), cap)[1] == n_sel
    if cap == 1.0:
        assert want_ov[0] == 0
    if p_row >= 0.3 and cap < 1.0:
        assert want_ov[0] > 0


def test_capacity_one_inside_tail_is_exact_dcn():
    rng = np.random.default_rng(3)
    B, H, W, C, O, G = 2, 19, 7, 8, 6, 2
    x = rng.standard_normal((B, H, W, C)).astype(np.float32)
    off = np.clip(3.0 * rng.standard_normal((B, H, W, G, 9, 2)), -7.5, 7.5).astype(np.float32)
    m = rng.uniform(0, 1, (B, H, W, G, 9)).astype(np.float32)
    w = (0.2 * rng.standard_normal((3, 3, C, O))).astype(np.float32)
    b = (0.1 * rng.standard_normal(O)).astype(np.float32)
    got, ov = _port(x, off, m, w, b, max_offset=2, tail_offset=8, capacity_frac=1.0)
    assert ov == [0, 0]
    want = np.asarray(jdcn(*map(jnp.asarray, (x, off, m, w, b))))
    np.testing.assert_allclose(got, want, atol=2e-4)


def test_pack_hybrid_reports_the_cascade_counters():
    rng = np.random.default_rng(4)
    pack = DCNv2Pack(8, 8, deformable_groups=2, impl="hybrid", max_offset=((1,) * 9, (2,) * 9),
                     hybrid_capacity=1.0, hybrid_tail_offset=2, audit_offsets=True)
    g = torch.Generator().manual_seed(0)
    pack.seeded_reset(g)
    pack.conv_offset.bias.data = torch.from_numpy(
        rng.uniform(-4, 4, pack.conv_offset.bias.shape).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((1, 8, 9, 10)).astype(np.float32))
    out = pack(x, x)
    off = pack.last_offsets
    assert off.shape == (1, 9, 10, 2, 9, 2)
    # the per-tap table collapses to its max (2); R_tail = max(2, 2 + 1) = 3
    n_beyond = int((off.abs().amax(-1) > 3).sum())
    assert n_beyond > 0 and pack.dcn_overflow.tolist() == [0, n_beyond]
    want = tdcn.modulated_deform_conv_ref(
        x.permute(0, 2, 3, 1), off, pack.offsets_and_mask(x)[1], pack.weight.permute(2, 3, 1, 0),
        pack.bias, max_offset=3)
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), want.numpy(), atol=1e-6)


def test_bad_radii_and_cpu_tensors_are_refused():
    t = [torch.zeros(1, 4, 4, 4), torch.zeros(1, 4, 4, 2, 9, 2), torch.ones(1, 4, 4, 2, 9),
         torch.zeros(3, 3, 4, 4)]
    with pytest.raises(ValueError, match="must exceed"):
        tdcn.modulated_deform_conv_cascade(*t, max_offset=4, tail_offset=4)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tdcn.modulated_deform_conv_cascade_cuda(*t)
    assert tdcn.cascade_launches == 0


@pytest.mark.gpu
def test_cascade_kernel_matches_ref_on_gpu():
    need_gpu()
    args, want_ov, _ = _case("blocks_12_into_8_slots")
    t = [torch.from_numpy(a).cuda() for a in args]
    before = (tdcn.launches, tdcn.cascade_launches)
    got, ov = tdcn.modulated_deform_conv_cascade(*t, return_overflow=True, **KW)
    assert (tdcn.launches, tdcn.cascade_launches) == (before[0], before[1] + 1)
    want, wov = tdcn.modulated_deform_conv_cascade_ref(*t, return_overflow=True, **KW)
    assert ov.tolist() == wov.tolist() == want_ov
    assert (got - want).abs().max() < 2e-4
