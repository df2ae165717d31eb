"""The slice as a whole: the port's ``VQLLFLOWDModel.get_sr`` vs the JAX
package's three-step pipeline (latent_half -> VQModel.decode -> aft_half) with
the same carried weights, on the CPU.

Small configuration: 32x32 input, ch=32, one res-block per level, K=2, L=1,
n_embed=64, float32, for ``dcn_impl`` 'xla' (exact), 'pallas' (clamped at 2) and
'hybrid' (the cascade); the gather hybrid and ``warp_mode: flow`` are held the
same way in tests/test_torch_dcn_gather.py and tests/test_torch_warp_flow.py. The JAX side of 'pallas' runs 'chain', its XLA
formulation of the same clamped op (the Pallas kernel needs a TPU or minutes of
interpret mode at this size; it is held against the port's op in
tests/test_torch_dcn.py). The JAX side of 'hybrid' runs 'xla': the Mosaic cascade
cannot run on the CPU in reasonable time at this size, so the port's cascade is
configured with capacity 1.0 and R_tail 16, above every offset of these weights
-- then both its counters are zero and it IS exact DCNv2 (the cascade itself is
held against the Pallas one in tests/test_torch_dcn_cascade.py).

Tolerance: 1e-3 relative to the largest output pixel. Both sides are float32;
the path is ~60 convolutions, 8 group norms per stage, an 8-step invertible
flow and two DCNs, and rounding differences of 1e-6 grow along it. The codebook
indices must not flip at all (checked stage-wise on the JAX latent).
"""

import os

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
                      "dcn_max_offset": 2, "dcn_hybrid_capacity": 1.0,
                      "dcn_hybrid_tail_offset": 16,
                      "flow": {"K": 2, "L": 1, "additionalFlowNoAffine": 2}, **MINI},
        "network_VQGAN": {"type": "VQModel", **VQ},
        "train": {"manual_seed": 1},
    }


def _jax_side(dcn_impl, lq, rng, **knobs):
    """``knobs``: further VQLLFLOWDeformable fields (``warp_mode``, ``dcn_hybrid_capacity``)."""
    net = JNet(K=2, L=1, additional_flow_no_affine=2, dcn_impl=dcn_impl, dcn_max_offset=2, **MINI,
               **knobs)
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


@pytest.mark.parametrize("dcn_impl", ["xla", "pallas", "hybrid"])
def test_get_sr_matches_jax(dcn_impl):
    """'hybrid' is held against JAX 'xla' with capacity 1.0 and every offset
    inside R_tail, where the cascade is exact DCNv2 (see the module docstring)."""
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
    elif dcn_impl == "hybrid":
        assert ov == {"overflow_blocks": 0, "taps_beyond_tail": 0}
        model.netG.configure_dcn(dcn_hybrid_capacity=1 / 64, dcn_hybrid_tail_offset=3)
        sr2 = model.get_sr(lq)
        ov = model.last_dcn_overflow()
        assert ov["overflow_blocks"] > 0 and ov["taps_beyond_tail"] > 0
        assert rel_err(sr2.numpy(), jrec) > 1e-3
    else:
        assert ov is None


def test_entry_points_need_an_explicit_cpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        create_model(_opt("xla"))


def test_unported_parts_raise_with_a_pointer():
    # ported since: the gather hybrid and the flow warp (tests/test_torch_dcn_gather.py,
    # tests/test_torch_warp_flow.py); an unknown impl or warp mode raises
    gather = create_model(_opt("hybrid_gather"), device="cpu")
    assert [p.impl for p in gather.netG.deformable_decoder.dcn_packs()] == ["hybrid_gather"] * 2
    flow_opt = _opt("xla")
    flow_opt["network_G"]["warp_mode"] = "flow"
    flow = create_model(flow_opt, device="cpu")
    assert flow.netG.deformable_decoder.dcn_packs() == []
    for knob, bad in (("dcn_impl", "hybrid_gather2"), ("warp_mode", "optical")):
        bad_opt = _opt("xla")
        bad_opt["network_G"][knob] = bad
        with pytest.raises(ValueError, match=bad):
            create_model(bad_opt, device="cpu")
    opt = _opt("xla")
    opt["is_train"] = True
    opt["train"] = {"manual_seed": 1, "lr_G": 5e-5, "mixed_precision": True}
    # ported since: bf16 training (float32 parameters, bf16 compute), the cascade, the
    # chain op, stage-3 training, the stage-2 model build and stage-2 training
    mixed = create_model(opt, device="cpu")
    assert mixed.dtype == torch.bfloat16 and hasattr(mixed, "optimizer")
    assert all(p.dtype == torch.float32 for p in mixed.netG.parameters())
    assert mixed.netG.deformable_decoder.conv_in.dtype == torch.bfloat16
    assert create_model(_opt("hybrid"), device="cpu").netG.dcn_impl == "hybrid"
    assert create_model(_opt("chain"), device="cpu").netG.dcn_impl == "chain"
    del opt["train"]["mixed_precision"]
    assert hasattr(create_model(opt, device="cpu"), "optimizer")
    stage2 = {**_opt("xla"), "model": "LLFlow"}
    stage2["network_G"] = {**stage2["network_G"], "which_model_G": "LLFlowVQGAN2"}
    assert type(create_model(stage2, device="cpu")).__name__ == "LLFlowModel"
    trainer = create_model({**stage2, "is_train": True, "train": {"manual_seed": 1, "lr_G": 5e-4}},
                           device="cpu")
    assert type(trainer).__name__ == "LLFlowModel" and hasattr(trainer, "optimizer")


def test_get_z_and_get_sr_with_z_shapes():
    model = create_model(_opt("xla"), device="cpu")
    lq = np.zeros((1, 32, 32, 3), np.float32)
    sr, z = model.get_sr_with_z(lq, heat=0.5, seed=3)
    assert sr.shape == (1, 32, 32, 3) and z.shape == (1, 4, 4, 192)
    assert float(z.std()) > 0 and float(model.get_z(0, lr_shape=lq.shape).abs().max()) == 0


def test_load_and_network_description(tmp_path):
    """``load()`` (glare_tpu/models/vqllflowd_model.py:662): the ``{iter}_G`` beside
    the newest resume state, strictly, else ``path.pretrain_model_G``, never strictly
    (a stage-2 file lacks the AFT decoder); ``get_network_description``."""
    src = create_model({**_opt("xla"), "train": {"manual_seed": 5}}, device="cpu")
    sd = src.netG.state_dict()
    pre = str(tmp_path / "stage2_G.pth")
    torch.save({k: v for k, v in sd.items() if not k.startswith("deformable_decoder.")}, pre)
    model = create_model({**_opt("xla"), "path": {"pretrain_model_G": pre, "strict_load": True}},
                         device="cpu")
    aft0 = {k: v.clone() for k, v in model.netG.deformable_decoder.state_dict().items()}
    model.load()
    got = model.netG.state_dict()
    assert all(torch.equal(got[k], v) for k, v in sd.items() if not k.startswith("deformable_decoder."))
    assert all(torch.equal(model.netG.deformable_decoder.state_dict()[k], v) for k, v in aft0.items())
    os.makedirs(tmp_path / "training_state")
    os.makedirs(tmp_path / "models")
    (tmp_path / "training_state" / "5.state").write_bytes(b"")
    torch.save({k: v for k, v in sd.items() if k != "deformable_decoder.residual_conv.bias"},
               str(tmp_path / "models" / "5_G.pth"))
    model.opt["path"].update({"resume_state": "auto", "training_state": str(tmp_path / "training_state")})
    with pytest.raises(RuntimeError, match="residual_conv.bias"):
        model.load()   # the resume model is loaded strictly
    torch.save(sd, str(tmp_path / "models" / "5_G.pth"))
    model.load()
    assert all(torch.equal(model.netG.state_dict()[k], v) for k, v in sd.items())
    assert model.get_network_description() == (
        "VQLLFLOWDModel", sum(p.numel() for p in model.netG.parameters()))


def test_infer_unpaired_cli_on_an_odd_sized_png(tmp_path, monkeypatch):
    """``python -m glare_tpu_torch.cli.infer_unpaired --opt CONF --device cpu`` on a
    37x29 PNG (reflect-padded to 48x32): the file is written under
    ``results/<conf>/unpaired/``, of the input's shape, equal to ``enhance_image``."""
    import sys

    import cv2
    import yaml

    from glare_tpu_torch.cli import infer_unpaired
    from glare_tpu_torch.cli.infer_paired import load_model
    from glare_tpu_torch.utils.imgproc import imread

    weights = str(tmp_path / "net_G.pth")
    torch.save(create_model(_opt("pallas"), device="cpu").netG.state_dict(), weights)
    os.makedirs(tmp_path / "photos")
    rng = np.random.default_rng(8)
    src = str(tmp_path / "photos" / "odd.png")
    cv2.imwrite(src, rng.integers(0, 90, (29, 37, 3), dtype=np.uint8))
    conf = tmp_path / "mini_unpaired.yml"
    conf.write_text(yaml.safe_dump({**_opt("pallas"), "name": "mini", "model_path": weights,
                                    "dataroot_unpaired": str(tmp_path / "photos"),
                                    "datasets": {"train": {"quant": 32, "log_low": True}}}))
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(sys, "argv", ["infer_unpaired", "--opt", str(conf), "--device", "cpu"])
    infer_unpaired.main()
    out = imread(str(tmp_path / "results" / "mini_unpaired" / "unpaired" / "odd.png"))
    assert out.shape == (29, 37, 3) and out.dtype == np.uint8
    model, opt = load_model(str(conf), device="cpu")
    assert np.array_equal(out, infer_unpaired.enhance_image(model, imread(src), apply_log=True))
    assert out.std() > 0
