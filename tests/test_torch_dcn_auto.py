"""Checkpoint-aware DCN dispatch of the port vs the JAX model (CPU).

  * ``audit_dcn_offsets``: same carried weights, same input (32x32, the small
    widths of tests/test_torch_stage3.py) -> the same stats dict. Maxima and
    percentiles within 1e-4 relative (float32 rounding along ~60 layers); tap
    and pixel fractions within one tap / pixel of the warp (an offset that
    sits on a radius may fall on either side); row-block fractions exact.
  * ``auto_configure_dcn``: given THE SAME stats (``audit_dcn_offsets`` is
    patched on both models, as tests/test_dcn_auto.py does) the port makes the
    choice the JAX model makes on a TPU (``jax.default_backend`` is patched to
    "tpu" in these tests only): kept, plain wide clamp, per-tap radii, cascade,
    and beyond the cascade's menu the gather hybrid.
  * the CLI's overflow loop on a batch that overflows: ends exact, or warns.
"""

import copy

import jax
import numpy as np
import pytest
import torch

from glare_tpu.models.vqllflowd_model import VQLLFLOWDModel as JModel
from glare_tpu.modules.vqllflow_deformable import VQLLFLOWDeformable as JNet
from glare_tpu.modules.vqmodel import VQModel as JVQModel
from glare_tpu_torch import convert
from glare_tpu_torch.cli.infer_paired import audit_on_sample, enhance_exact
from glare_tpu_torch.models import create_model
from glare_tpu_torch.models.vqllflowd_model import temper_offset_heads

from test_torch_stage3 import MINI, VQ, _jax_side, _opt

RADII = (1, 2, 4, 8, 16)


def _jax_model(dcn_impl="pallas", **knobs):
    """A JAX VQLLFLOWDModel shell around the small network (no init, no optimizer)."""
    jm = JModel.__new__(JModel)
    jm.netG = JNet(K=2, L=1, additional_flow_no_affine=2, dcn_impl=dcn_impl,
                   **{"dcn_max_offset": 2, **knobs}, **MINI)
    jm.net_hq = JVQModel(vq_backend="ref", **VQ)
    jm._jit_cache = {}
    return jm


def _lq(seed, batch=2):
    rng = np.random.default_rng(seed)
    return np.log(np.clip(rng.uniform(0, 0.2, (batch, 32, 32, 3)) + 1e-3, 1e-3, None)) \
        .astype(np.float32)


# ------------------------------------------------------------------ audit --

def _compare_stats(got, want, n_taps, path=""):
    assert type(got) is type(want), path
    if isinstance(want, dict):
        assert list(got) == list(want), path
        for k in want:
            _compare_stats(got[k], want[k], n_taps, f"{path}/{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _compare_stats(g, w, n_taps, f"{path}[{i}]")
    elif "rowblk" in path:
        assert got == want, path
    elif "frac" in path:
        assert abs(got - want) <= 1.0 / n_taps + 1e-12, (path, got, want)
    else:
        assert abs(got - want) <= 1e-4 * max(abs(want), 1e-3), (path, got, want)


def test_audit_matches_jax():
    rng = np.random.default_rng(7)
    lq = _lq(7)
    net_p, vq_p, *_ = _jax_side("xla", lq, rng)
    jm = _jax_model("chain")
    jm.params, jm.vq_variables = net_p, {"params": vq_p}
    want = jm.audit_dcn_offsets(jax.numpy.asarray(lq), radii=(1, 2, 3, 4, 8))

    model = create_model(_opt("pallas"), device="cpu")
    model.load_state_dicts(convert.flax_to_torch_stage3(net_p), convert.flax_to_torch_vqgan(vq_p))
    got = model.audit_dcn_offsets(lq, radii=(1, 2, 3, 4, 8))
    assert sorted(got["warps"]) == ["warp_0", "warp_1"]
    assert set(got["warps"]["warp_0"]["rowblk_frac_exceed_by_rpb"]) == {8, 16}
    assert got["tap_max"] > 2.0, "the weights must push offsets beyond the clamp"
    # the fewest taps / pixels any fraction is taken over: warp_0's pixels (2 x 16 x 16)
    _compare_stats(got, want, n_taps=2 * 16 * 16)
    # the audit leaves no trace: packs stop keeping offsets, the counters are untouched
    for w in model.netG.deformable_decoder.warp:
        assert w.dcn.audit_offsets is False and w.dcn.last_offsets is None
    assert model.last_dcn_overflow() is None


# -------------------------------------------------------------- decisions --

def _warp_stats(tap_max, blk_frac, tail_frac=None, per_gk=None):
    """Fabricated per-warp stats: uniform fractions at every radius below tap_max."""
    ws = {
        "tap_p99": tap_max * 0.9,
        "tap_max": tap_max,
        "tap_frac_exceed": {r: ((0.05 if tail_frac is None else tail_frac) if r < tap_max else 0.0)
                            for r in RADII},
        "pix_frac_exceed": {r: (0.1 if r < tap_max else 0.0) for r in RADII},
        "rowblk_frac_exceed_by_rpb": {
            rpb: {r: (blk_frac if r < tap_max else 0.0) for r in RADII} for rpb in (8, 16)},
    }
    if per_gk is not None:
        ws["per_gk_max"] = per_gk
    return ws


def _tap_specific(peak):
    t = [[0.3] * 9 for _ in range(4)]
    t[1][4] = peak
    t[2][7] = 0.8
    return t


WARPS = {
    "in_band": _warp_stats(1.6, blk_frac=0.0),
    "wide_everywhere": _warp_stats(5.0, blk_frac=1.0),
    "thin_tail": _warp_stats(6.4, blk_frac=0.02),
    "tap_specific": _warp_stats(6.4, blk_frac=0.5, per_gk=_tap_specific(6.4)),
    "beyond_menu": _warp_stats(20.0, blk_frac=0.3),
}


def _stats(w0, w1):
    zero = {r: 0.0 for r in RADII}
    return {"tap_p99": 1.0, "tap_max": 6.4, "tap_frac_exceed": dict(zero),
            "pix_frac_exceed": dict(zero), "rowblk_frac_exceed": dict(zero),
            "rowblk_frac_exceed_by_rpb": {rpb: dict(zero) for rpb in (8, 16)},
            "warps": {"warp_0": copy.deepcopy(WARPS[w0]), "warp_1": copy.deepcopy(WARPS[w1])}}


@pytest.mark.parametrize("w0,w1,impl,want_impl", [
    ("in_band", "in_band", "pallas", "pallas"),                       # kept
    ("wide_everywhere", "in_band", "pallas", "pallas"),               # plain wide clamp, per warp
    ("tap_specific", "in_band", "pallas", "pallas"),                  # per-tap radii
    ("thin_tail", "in_band", "pallas", ("hybrid", "pallas")),         # cascade for one warp
    ("thin_tail", "thin_tail", "hybrid", "hybrid"),                   # cascade retuned
    ("wide_everywhere", "tap_specific", "hybrid", "pallas"),          # cascade is the wrong shape
])
def test_decisions_match_jax_given_the_same_stats(monkeypatch, w0, w1, impl, want_impl):
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    jm = _jax_model(impl)
    monkeypatch.setattr(jm, "audit_dcn_offsets", lambda lq, radii=None: _stats(w0, w1))
    want = jm.auto_configure_dcn(np.zeros((1, 32, 32, 3), np.float32))

    model = create_model({**_opt(impl), "network_G": {
        **_opt(impl)["network_G"], "dcn_hybrid_capacity": 0.125, "dcn_hybrid_tail_offset": 8}},
        device="cpu")
    monkeypatch.setattr(model, "audit_dcn_offsets", lambda lq, radii=None: _stats(w0, w1))
    got = model.auto_configure_dcn(np.zeros((1, 32, 32, 3), np.float32))

    assert got["action"] == want["action"]
    assert got["decisions"] == want["decisions"]
    for knob in ("dcn_impl", "dcn_max_offset", "dcn_hybrid_capacity", "dcn_hybrid_tail_offset"):
        assert getattr(model.netG, knob) == getattr(jm.netG, knob), knob
    assert model.netG.dcn_impl == want_impl
    # the packs were re-dispatched in place, and the reconfigured model runs
    packs = [w.dcn for w in model.netG.deformable_decoder.warp]
    for w, name in enumerate(("warp_0", "warp_1")):
        d = got["decisions"][name]
        assert (packs[w].impl, packs[w].max_offset) == (d["impl"], d["R"])
        assert (packs[w].hybrid_capacity, packs[w].hybrid_tail_offset) == (d["cap"], d["r_tail"])
    if (w0, w1) == ("in_band", "in_band"):
        assert got["action"].startswith("kept")
    if w0 == "tap_specific":
        assert isinstance(got["decisions"]["warp_0"]["R"], tuple)
        assert got["decisions"]["warp_0"]["R"][1][4] == 8
    assert bool(torch.isfinite(model.get_sr(_lq(0, 1))).all())


def test_beyond_the_cascade_menu_raises_where_jax_takes_the_gather_hybrid(monkeypatch):
    """Beyond the 16 px menu JAX takes the gather hybrid; the port makes the same
    decision (it no longer raises), reconfigures the pack and serves. A warp
    already on the gather hybrid is retuned the same way."""
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    zero = np.zeros((1, 32, 32, 3), np.float32)
    for impl in ("pallas", "hybrid_gather"):
        jm = _jax_model(impl)
        monkeypatch.setattr(jm, "audit_dcn_offsets",
                            lambda lq, radii=None: _stats("beyond_menu", "in_band"))
        want = jm.auto_configure_dcn(zero)
        model = create_model({**_opt(impl), "network_G": {
            **_opt(impl)["network_G"], "dcn_hybrid_capacity": 0.125, "dcn_hybrid_tail_offset": 8}},
            device="cpu")
        monkeypatch.setattr(model, "audit_dcn_offsets",
                            lambda lq, radii=None: _stats("beyond_menu", "in_band"))
        got = model.auto_configure_dcn(zero)
        assert want["decisions"]["warp_0"]["impl"] == "hybrid_gather"
        assert got["decisions"] == want["decisions"] and got["action"] == want["action"]
        for knob in ("dcn_impl", "dcn_max_offset", "dcn_hybrid_capacity", "dcn_hybrid_tail_offset"):
            assert getattr(model.netG, knob) == getattr(jm.netG, knob), knob
        d = got["decisions"]["warp_0"]
        assert (d["R"], d["cap"]) == (2, 4.0 * 0.1)       # capacity_margin x the pixel tail
        pack = model.netG.deformable_decoder.dcn_packs()[0]
        assert (pack.impl, pack.max_offset, pack.hybrid_capacity) == ("hybrid_gather", 2, d["cap"])
        sr = model.get_sr(_lq(0, 1))
        assert bool(torch.isfinite(sr).all())
        assert model.last_dcn_overflow() is not None      # warp_1's clamped pack still counts


def test_exact_impl_needs_no_audit():
    model = create_model(_opt("xla"), device="cpu")
    assert model.auto_configure_dcn(_lq(0, 1)) == {"action": "none (exact xla path)"}


# ------------------------------------------------------------ the CLI loop --

def _pair(impl, **knobs):
    """The model under test and an exact ('xla') model with the same weights."""
    opt = _opt(impl)
    opt["network_G"].update(knobs)
    model, exact = create_model(opt, device="cpu"), create_model(_opt("xla"), device="cpu")
    for m in (model, exact):
        temper_offset_heads(m.netG, seed=3, std=0.3)
        with torch.no_grad():  # biases of a few pixels: most taps beyond the 2 px clamp
            for w in m.netG.deformable_decoder.warp:
                w.dcn.conv_offset.bias.mul_(6.0)
    return model, exact


@pytest.mark.parametrize("impl,knobs", [
    ("hybrid", {"dcn_hybrid_capacity": 1 / 64, "dcn_hybrid_tail_offset": 3}),
    ("pallas", {}),
])
def test_enhance_exact_resolves_an_overflowing_batch(capsys, impl, knobs):
    model, exact = _pair(impl, **knobs)
    lq = _lq(11)
    model.get_sr(lq)
    first = model.last_dcn_overflow()
    assert first["taps_beyond_tail"] > 0, "the batch must overflow as configured"
    if impl == "hybrid":
        assert first["overflow_blocks"] > 0
    sr, ov = enhance_exact(model, lq, tag="batch0")
    out = capsys.readouterr().out
    want = exact.get_sr(lq)
    if ov["overflow_blocks"] or ov["taps_beyond_tail"]:
        assert "WARNING: DCN cascade overflow" in out     # nothing left to raise
    else:
        assert "WARNING" not in out
        assert float((sr - want).abs().max()) <= 1e-5 * float(want.abs().max())
    if impl == "hybrid":
        assert "re-dispatching with" in out
        assert model.netG.dcn_hybrid_capacity > 1 / 64
    else:
        assert "re-audited on the offending batch" in out
    # a second batch under the upgraded configuration needs no further change
    sr2, ov2 = enhance_exact(model, lq, tag="batch1")
    assert ov2 == ov and torch.equal(sr2, sr)


def test_start_up_audit_respects_dcn_auto(capsys):
    model, _ = _pair("pallas")
    lq = _lq(12, 3)
    assert audit_on_sample(model, {"network_G": {"dcn_auto": False}}, list(lq)) is None
    assert model.netG.dcn_impl == "pallas" and model.netG.dcn_max_offset == 2
    odd = np.zeros((16, 32, 3), np.float32)    # another shape: left out of the sample
    stats = audit_on_sample(model, {"network_G": {}}, [lq[0], odd, lq[1], lq[2], lq[2]])
    assert "DCN offset audit (3 images)" in capsys.readouterr().out
    assert stats["action"].startswith("reconfigured")
    model.get_sr(lq)
    assert model.last_dcn_overflow() in (None, {"overflow_blocks": 0, "taps_beyond_tail": 0})
