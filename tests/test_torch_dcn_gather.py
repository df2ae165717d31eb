"""The port's gather hybrid (``dcn_impl: hybrid_gather``) vs the JAX package (CPU).

  * ``ops/dcn.py:modulated_deform_conv_hybrid`` against JAX's
    ``modulated_deform_conv_hybrid(base="chain")`` (the base JAX takes off a
    TPU) at 12x12, C 8, G 4, R 2, capacity 0.125 (S = 128 slots of 144
    pixels): the tail under capacity (then also equal to the exact op), more
    out-of-band pixels than slots (the overflowed pixels keep their clamp-R
    value, in both packages), and a per-tap radius table (the pack collapses it
    to its largest radius, as the JAX module does). One JAX jit serves all
    three. Tolerance 1e-5 of the output's largest: float32 on both sides, sums
    in another order.
  * ``VQLLFLOWDModel.get_sr`` at 32x32 with ``dcn_impl: hybrid_gather`` against
    the JAX pipeline on the same carried weights (1e-3 of the largest pixel, the
    rule of tests/test_torch_stage3.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glare_tpu.ops.dcn import modulated_deform_conv_hybrid as jhybrid
from glare_tpu_torch import convert
from glare_tpu_torch.models import create_model
from glare_tpu_torch.modules.deformable_decoder import DCNv2Pack
from glare_tpu_torch.ops import dcn as tdcn

from test_torch_stage3 import _jax_side, _opt
from torch_port_util import rel_err

B, H, W, C, G, O = 1, 12, 12, 8, 4, 8
CAP = 0.125                # 144 pixels -> S = 128 slots
PER_TAP = tuple(tuple(1 + (g + k) % 2 for k in range(9)) for g in range(G))   # largest radius 2
TOL = 1e-5


def _inputs(seed, spread):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, H, W, C)).astype(np.float32)
    off = (spread * rng.standard_normal((B, H, W, G, 9, 2))).astype(np.float32)
    off[:, 0, 0] = -7.5            # samples that leave the image entirely
    off[:, -1, -1] = 17.25         # far beyond any clamp
    mask = rng.uniform(0, 1, (B, H, W, G, 9)).astype(np.float32)
    w = (0.2 * rng.standard_normal((3, 3, C, O))).astype(np.float32)
    b = (0.1 * rng.standard_normal(O)).astype(np.float32)
    return x, off, mask, w, b


def _jax(x, off, mask, w, b):
    return np.asarray(jhybrid(*map(jnp.asarray, (x, off, mask, w, b)), max_offset=2,
                              capacity_frac=CAP, base="chain"))


@pytest.mark.parametrize("case", ["under_capacity", "overflow", "per_tap_table"])
def test_hybrid_matches_jax(case):
    x, off, mask, w, b = _inputs(3, 3.0 if case == "overflow" else 0.45)
    t = [torch.from_numpy(a) for a in (x, off, mask, w, b)]
    selected, idx = tdcn.hybrid_selection(t[1], 2, CAP)
    n_oob = int((np.abs(off).max(-1) > 2).reshape(B * H * W, -1).any(1).sum())
    assert idx.shape == (tdcn.hybrid_slots(B * H * W, CAP),) == (128,)
    assert int(selected.sum()) == min(n_oob, 128)
    want = _jax(x, off, mask, w, b)
    if case == "per_tap_table":
        pack = DCNv2Pack(C, O, impl="hybrid_gather", max_offset=PER_TAP, hybrid_capacity=CAP)
        with torch.no_grad():
            pack.weight.copy_(t[3].permute(3, 2, 0, 1))
            pack.bias.copy_(t[4])
        pack.offsets_and_mask = lambda feat: (t[1], t[2])   # the given offsets and mask
        got = pack(t[0].permute(0, 3, 1, 2), None).permute(0, 2, 3, 1).detach().numpy()
        assert pack.dcn_overflow is None       # the JAX module sows no counter for this impl
    else:
        got = tdcn.modulated_deform_conv_hybrid(*t, max_offset=2, capacity_frac=CAP).numpy()
    assert rel_err(got, want) <= TOL
    exact = tdcn.modulated_deform_conv_ref(*t).numpy()
    clamped = tdcn.modulated_deform_conv_ref(*t, max_offset=2).numpy()
    if case == "overflow":
        assert n_oob > 128, "the case must overflow the slots"
        past = ~selected.numpy().reshape(B, H, W) & (np.abs(off).max((3, 4, 5)) > 2)
        assert past.any()
        np.testing.assert_allclose(got[past], clamped[past], rtol=0, atol=TOL * np.abs(clamped).max())
        assert rel_err(got, exact) > 1e-2
    else:
        assert 0 < n_oob < 128
        assert rel_err(got, exact) <= TOL


def test_get_sr_matches_jax():
    """Stage 3 with dcn_impl hybrid_gather (R 2, capacity 0.125) against the JAX
    pipeline, which serves it through its gather hybrid on the chain base."""
    rng = np.random.default_rng(7)
    lq = np.log(np.clip(rng.uniform(0, 0.2, (2, 32, 32, 3)) + 1e-3, 1e-3, None)).astype(np.float32)
    net_p, vq_p, jrec, _, _ = _jax_side("hybrid_gather", lq, rng, dcn_hybrid_capacity=CAP)
    opt = _opt("hybrid_gather")
    opt["network_G"]["dcn_hybrid_capacity"] = CAP
    model = create_model(opt, device="cpu")
    model.load_state_dicts(convert.flax_to_torch_stage3(net_p), convert.flax_to_torch_vqgan(vq_p))
    sr = model.get_sr(lq)
    assert sr.shape == (2, 32, 32, 3) and bool(torch.isfinite(sr).all())
    assert rel_err(sr.numpy(), jrec) < 1e-3
    assert model.last_dcn_overflow() is None   # no counter, as in JAX
    # these weights put a tap beyond 2 px in most pixels: the first S of them take the
    # exact tail, the rest keep their clamp-R value, in both packages
    stats = model.audit_dcn_offsets(lq, radii=(2,))
    assert stats["tap_max"] > 2.0 and stats["pix_frac_exceed"][2] > CAP


def test_hybrid_takes_the_jax_base_keyword():
    """``base`` picks the JAX op's clamp-R base pass (glare_tpu/ops/dcn.py:293-296):
    "chain" and "pallas" are the same function, the port's one base pass (on the
    CPU its plain version), held to JAX's "chain"; any other value raises."""
    x, off, mask, w, b = _inputs(3, 0.45)
    t = [torch.from_numpy(a) for a in (x, off, mask, w, b)]
    default = tdcn.modulated_deform_conv_hybrid(*t, max_offset=2, capacity_frac=CAP)
    want = _jax(x, off, mask, w, b)
    for base in tdcn.HYBRID_BASES:
        for fn in (tdcn.modulated_deform_conv_hybrid, tdcn.modulated_deform_conv_hybrid_ref):
            got = fn(*t, max_offset=2, capacity_frac=CAP, base=base)
            assert torch.equal(got, default), (fn.__name__, base)
        assert rel_err(got.numpy(), want) <= TOL
    for fn in (tdcn.modulated_deform_conv_hybrid, tdcn.modulated_deform_conv_hybrid_ref):
        with pytest.raises(ValueError, match="'chain' or 'pallas'"):
            fn(*t, max_offset=2, capacity_frac=CAP, base="xla")
