"""The slice as a whole: the port's ``VQLLFLOWDModel.get_sr`` vs the JAX
package's three-step pipeline (latent_half -> VQModel.decode -> aft_half) with
the same carried weights, on the CPU.

Small configuration: 32x32 input, ch=32, one res-block per level, K=2, L=1,
n_embed=64, float32, for ``dcn_impl`` 'xla' (exact) and 'pallas' (clamped at 2).
The JAX side of 'pallas' runs 'chain', its XLA formulation of the same clamped
op (the Pallas kernel needs a TPU or minutes of interpret mode at this size; it
is held against the port's op in tests/test_torch_dcn.py).

Tolerance: 1e-3 relative to the largest output pixel. Both sides are float32;
the path is ~60 convolutions, 8 group norms per stage, an 8-step invertible
flow and two DCNs, and rounding differences of 1e-6 grow along it. The codebook
indices must not flip at all (checked stage-wise on the JAX latent).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glare_tpu.modules.vqllflow_deformable import VQLLFLOWDeformable as JNet
from glare_tpu.modules.vqmodel import VQModel as JVQModel
from glare_tpu_torch import convert
from glare_tpu_torch.models import create_model

from torch_port_util import fill_tree, nchw, nhwc, rel_err

MINI = dict(enc_ch=32, decoder_ch=32, enc_num_res_blocks=1, dec_num_res_blocks=1)
VQ = dict(ch=32, n_embed=64, num_res_blocks=1)


def _opt(dcn_impl):
    return {
        "model": "VQLLFLOWD", "is_train": False,
        "network_G": {"which_model_G": "VQLLFLOWDeformable", "dcn_impl": dcn_impl,
                      "dcn_max_offset": 2,
                      "flow": {"K": 2, "L": 1, "additionalFlowNoAffine": 2}, **MINI},
        "network_VQGAN": {"type": "VQModel", **VQ},
        "train": {"manual_seed": 1},
    }


def _jax_side(dcn_impl, lq, rng):
    net = JNet(K=2, L=1, additional_flow_no_affine=2, dcn_impl=dcn_impl, dcn_max_offset=2, **MINI)
    vq = JVQModel(vq_backend="ref", **VQ)
    x = jnp.asarray(lq)

    def shapes():
        key = jax.random.PRNGKey(0)
        vq_p = vq.init(key, x)["params"]
        lat_p = net.init(key, x, method=JNet.latent_half)["params"]
        x0, enc0 = net.apply({"params": lat_p}, x, method=JNet.latent_half)
        _, _, code0 = vq.apply({"params": vq_p}, x0, method=JVQModel.decode)
        aft_p = net.init(key, x0, code0, enc0["mid_feat"], method=JNet.aft_half)["params"]
        return vq_p, {**lat_p, **aft_p}

    vq_s, net_s = jax.eval_shape(shapes)
    vq_p, net_p = fill_tree(vq_s, rng), fill_tree(net_s, rng)
    # a codebook at the latent's scale, so that many codes are in use
    vq_p["quantize"]["embedding"] = (0.5 * rng.standard_normal((64, 3))).astype(np.float32)

    @jax.jit
    def run(net_p, vq_p, x):
        lat, enc = net.apply({"params": net_p}, x, method=JNet.latent_half)
        dec, _, code = vq.apply({"params": vq_p}, lat, method=JVQModel.decode)
        rec = net.apply({"params": net_p}, lat, code, enc["mid_feat"], method=JNet.aft_half)
        return rec, lat, code

    rec, lat, code = run(net_p, vq_p, x)
    return net_p, vq_p, np.asarray(rec), np.asarray(lat), [np.asarray(c) for c in code]


@pytest.mark.parametrize("dcn_impl", ["xla", "pallas"])
def test_get_sr_matches_jax(dcn_impl):
    rng = np.random.default_rng(7)
    lq = np.log(np.clip(rng.uniform(0, 0.2, (2, 32, 32, 3)) + 1e-3, 1e-3, None)).astype(np.float32)
    net_p, vq_p, jrec, jlat, jcode = _jax_side("chain" if dcn_impl == "pallas" else "xla", lq, rng)

    model = create_model(_opt(dcn_impl), device="cpu")
    model.load_state_dicts(convert.flax_to_torch_stage3(net_p), convert.flax_to_torch_vqgan(vq_p))
    sr = model.get_sr(lq)
    assert sr.shape == (2, 32, 32, 3) and sr.dtype == torch.float32
    assert bool(torch.isfinite(sr).all())
    assert rel_err(sr.numpy(), jrec) < 1e-3

    with torch.inference_mode():
        # stage-wise on the JAX latent: zero index flips, taps at 2e-4
        lat, _ = model.netG.latent_half(nchw(lq))
        assert rel_err(nhwc(lat), jlat) < 1e-3
        _, _, code = model.net_hq.decode(nchw(jlat))
        for t, jt in zip(code, jcode):
            assert rel_err(nhwc(t), jt) < 2e-4
        assert len(set(model.net_hq.quantize.last_indices.tolist())) > 4

    ov = model.last_dcn_overflow()
    if dcn_impl == "pallas":
        assert ov is not None and ov["overflow_blocks"] == 0 and ov["taps_beyond_tail"] > 0
    else:
        assert ov is None


def test_entry_points_need_an_explicit_cpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        create_model(_opt("xla"))


def test_unported_parts_raise_with_a_pointer():
    opt = _opt("hybrid")
    with pytest.raises(NotImplementedError, match="later slice"):
        create_model(opt, device="cpu")
    opt = _opt("xla")
    opt["is_train"] = True
    opt["network_G"]["dcn_impl"] = "xla"
    with pytest.raises(NotImplementedError, match="not ported yet"):
        create_model(opt, device="cpu")
    with pytest.raises(NotImplementedError):
        create_model({**_opt("xla"), "model": "LLFlow"}, device="cpu")


def test_get_z_and_get_sr_with_z_shapes():
    model = create_model(_opt("xla"), device="cpu")
    lq = np.zeros((1, 32, 32, 3), np.float32)
    sr, z = model.get_sr_with_z(lq, heat=0.5, seed=3)
    assert sr.shape == (1, 32, 32, 3) and z.shape == (1, 4, 4, 192)
    assert float(z.std()) > 0 and float(model.get_z(0, lr_shape=lq.shape).abs().max()) == 0
