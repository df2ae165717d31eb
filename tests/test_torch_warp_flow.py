"""The port's flow warp (``warp_mode: flow``) vs the JAX package (CPU).

  * ``ops/warp.py:flow_warp_align`` against JAX's ``flow_warp_align`` and against
    the plain version ``flow_warp_align_ref`` at 8x8, R 2, with flows that reach
    past R (clipped) and past the border: float32 within 1e-5 of the largest
    output (sums in another order); bf16 within 2^-6 of it (both packages sum
    25 bf16 terms in bf16 and round at other places).
  * ``WarpBlock(warp_mode="flow")`` with carried weights (``flow_head``,
    ``post_conv``) against JAX's, float32, 1e-4 of the largest output.
  * ``VQLLFLOWDModel.get_sr`` at 32x32 with ``warp_mode: flow`` against the JAX
    pipeline (1e-3 of the largest pixel, the rule of tests/test_torch_stage3.py);
    ``auto_configure_dcn`` on a flow network does what the JAX model does: nothing
    for ``dcn_impl: xla``, and for a bounded impl an audit that finds no DCN
    offsets and raises ``KeyError('intermediates')`` (the JAX audit's sown
    collection is absent).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glare_tpu.models.vqllflowd_model import VQLLFLOWDModel as JModel
from glare_tpu.modules.deformable_decoder import WarpBlock as JWarpBlock
from glare_tpu.modules.vqllflow_deformable import VQLLFLOWDeformable as JNet
from glare_tpu.modules.vqmodel import VQModel as JVQModel
from glare_tpu.ops.warp import flow_warp_align as jflow
from glare_tpu_torch import convert
from glare_tpu_torch.models import create_model
from glare_tpu_torch.modules.deformable_decoder import WarpBlock
from glare_tpu_torch.ops import warp as twarp

from test_torch_stage3 import MINI, VQ, _jax_side, _opt
from torch_port_util import nchw, nhwc, random_params, rel_err


def _inputs(seed, B=2, H=8, W=8, C=8, G=4):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, H, W, C)).astype(np.float32)
    flow = (1.4 * rng.standard_normal((B, H, W, G, 2))).astype(np.float32)
    flow[:, 0, 0] = -3.3          # clipped to -2, and out of the image
    flow[:, -1, -1] = 2.75
    return x, flow


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flow_warp_align_matches_jax_and_the_plain_version(dtype):
    x, flow = _inputs(0)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    xt = torch.from_numpy(x).to(tdt)
    got = twarp.flow_warp_align(xt, torch.from_numpy(flow), max_offset=2)
    assert got.dtype == tdt and got.shape == xt.shape
    want = np.asarray(jflow(jnp.asarray(x).astype(jdt), jnp.asarray(flow), max_offset=2), np.float32)
    ref = twarp.flow_warp_align_ref(xt, torch.from_numpy(flow), max_offset=2)
    tol = 1e-5 if dtype == "float32" else 2 ** -6
    assert rel_err(got.float().numpy(), want) <= tol
    assert rel_err(got.float().numpy(), ref.float().numpy()) <= tol
    assert rel_err(x, got.float().numpy()) > 0.1, "the flow must move pixels"


def test_warpblock_flow_matches_jax():
    rng = np.random.default_rng(3)
    x_vq = rng.standard_normal((2, 6, 8, 16)).astype(np.float32)
    h = rng.standard_normal((2, 6, 8, 16)).astype(np.float32)
    jblk = JWarpBlock(warp_mode="flow")
    params = random_params(jblk, rng, jnp.asarray(x_vq), jnp.asarray(h))
    want = np.asarray(jax.jit(lambda p, a, c: jblk.apply({"params": p}, a, c))(
        params, jnp.asarray(x_vq), jnp.asarray(h)))
    blk = WarpBlock(16, warp_mode="flow")
    assert blk.dcn is None
    sd = {}
    for name in ("offset", "flow_head", "post_conv"):
        convert._put_conv(sd, name, params[name])
    blk.load_state_dict(sd)
    with torch.no_grad():
        got = nhwc(blk(nchw(x_vq), nchw(h)))
        flow = blk.flow(blk.offset(torch.cat([nchw(x_vq), nchw(h)], 1)))
    assert rel_err(got, want) <= 1e-4
    assert float(flow.abs().max()) > 0.5 and float(flow.abs().max()) <= 2.0


def test_get_sr_and_auto_configure_match_jax():
    rng = np.random.default_rng(7)
    lq = np.log(np.clip(rng.uniform(0, 0.2, (2, 32, 32, 3)) + 1e-3, 1e-3, None)).astype(np.float32)
    net_p, vq_p, jrec, _, _ = _jax_side("xla", lq, rng, warp_mode="flow")
    opt = _opt("xla")
    opt["network_G"]["warp_mode"] = "flow"
    model = create_model(opt, device="cpu")
    model.load_state_dicts(convert.flax_to_torch_stage3(net_p), convert.flax_to_torch_vqgan(vq_p))
    sr = model.get_sr(lq)
    assert sr.shape == (2, 32, 32, 3) and bool(torch.isfinite(sr).all())
    assert rel_err(sr.numpy(), jrec) < 1e-3
    assert model.last_dcn_overflow() is None

    jm = JModel.__new__(JModel)
    jm.net_hq = JVQModel(vq_backend="ref", **VQ)
    jm.params, jm.vq_variables, jm._jit_cache = net_p, {"params": vq_p}, {}
    for impl in ("xla", "pallas"):
        jm.netG = JNet(K=2, L=1, additional_flow_no_affine=2, dcn_impl=impl, dcn_max_offset=2,
                       warp_mode="flow", **MINI)
        model.netG.configure_dcn(dcn_impl=impl)
        if impl == "xla":
            assert model.auto_configure_dcn(lq) == jm.auto_configure_dcn(jnp.asarray(lq)) \
                == {"action": "none (exact xla path)"}
            continue
        with pytest.raises(KeyError, match="intermediates") as want:
            jm.auto_configure_dcn(jnp.asarray(lq))
        with pytest.raises(KeyError, match="intermediates") as got:
            model.auto_configure_dcn(lq)
        assert str(got.value) == str(want.value)
    assert model.netG.dcn_impl == "pallas"
    assert torch.equal(model.get_sr(lq), sr)      # a flow network has no DCN to re-dispatch


def test_warp_block_takes_the_flow_max_offset_field():
    """The JAX module's ``flow_max_offset`` field: the flow's bound, default 2."""
    from glare_tpu_torch.modules.deformable_decoder import WarpBlock

    assert WarpBlock(8, warp_mode="flow").flow_max_offset == 2
    warp = WarpBlock(8, warp_mode="flow", flow_max_offset=3)
    with torch.no_grad():
        warp.flow_head.bias.fill_(20.0)   # tanh saturates: every flow component at the bound
        flow = warp.flow(torch.zeros(1, 8, 4, 5))
    assert flow.shape == (1, 4, 5, 4, 2) and torch.allclose(flow, torch.full_like(flow, 3.0))
