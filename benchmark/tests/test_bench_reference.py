"""The frozen reference against the port on the CPU, at miniature widths, on one
seeded state_dict (the port's kernels take their plain versions here), and the
frozen operation counts against a recount."""


import pytest
import torch

from benchmark.flops import count as flop_count
from benchmark.harness import weights
from benchmark.harness.bench import _merge
from benchmark.harness.program import build_model
from benchmark.harness.registry import Registry
from benchmark.reference import glare

from conftest import BIG_SEED, MINI


@pytest.mark.parametrize("config", ["glare-lol-stage3", "glare-lol-stage2"])
def test_reference_equals_the_port_in_float32(config):
    cfg = _merge(Registry().config(config), MINI)
    cfg.pop("inference_dtype", None)                      # both sides float32: the arithmetic is the same
    cfg["served_bf16"] = []
    state = weights.make_state(cfg, BIG_SEED, "cpu")
    ref = glare.Reference(cfg)
    ref.load_state_dict(state)
    x = torch.log(torch.rand(2, 3, 44, 60, generator=torch.Generator().manual_seed(1)) * 0.2 + 1e-3)
    if "offset_targets" in cfg:
        stats = weights.fit_offset_heads(cfg, ref, x, BIG_SEED, state)
        assert stats["warp_0"]["p50"] == pytest.approx(cfg["offset_targets"]["warp_0"]["p50"], rel=0.1)
        assert stats["warp_0"]["frac_beyond_2"] > 0.01
    model, _ = build_model(cfg, state, torch.device("cpu"))
    lq = x.permute(0, 2, 3, 1).numpy()
    y = model.get_sr(lq) if ref.stage == 3 else model.decode_latent(model.get_sr(lq))
    want = glare.run(ref, x)
    err = float((y.permute(0, 3, 1, 2) - want).norm() / want.norm())
    assert err < 1e-5, err                                 # float32 rounding in another order only
    for mode in ("tf32", "bf16", "fp8"):                   # the reduced modes do change the answer
        low = glare.run(ref, x, mode)
        assert float((low - want).norm() / want.norm()) > 100 * err
        assert not torch.equal(glare.run(ref, x, {"flow": mode}), want)


def test_weights_repeat_by_seed_and_bf16_tensors_hold_bf16_values():
    cfg = _merge(Registry().config("glare-lol-stage3"), MINI)
    a = weights.make_state(cfg, BIG_SEED, "cpu")
    b = weights.make_state(cfg, BIG_SEED, "cpu")
    c = weights.make_state(cfg, BIG_SEED + 1, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["netG.RRDB.encoder.conv_in.weight"], c["netG.RRDB.encoder.conv_in.weight"])
    for k in ("netG.RRDB.encoder.conv_in.weight", "net_hq.decoder.conv_out.bias",
              "netG.deformable_decoder.residual_conv.weight"):
        assert torch.equal(a[k], a[k].bfloat16().float())
    w = a["netG.flowUpsamplerNet.layers.0.invconv.weight"]
    assert torch.allclose(w @ w.t(), torch.eye(3), atol=1e-5)


def test_the_frozen_counts_are_the_reference_recounted_at_every_cell_shape():
    stored = flop_count.load()
    assert flop_count.all_counts() == stored
    # the 620x420 protocol image: the program's own audit reads 13.16 TFLOP
    assert stored["glare-lol-stage3/420x620"]["flop"] / 1e12 == pytest.approx(13.16, abs=0.005)
