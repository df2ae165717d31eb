"""The port's evaluation metrics vs the JAX package (CPU).

  * ``utils/matlab_functions.py`` and ``utils/niqe.py`` (the port's copies) against
    the JAX package's modules on the same seeded images, within 1e-10 relative;
    NIQE with pristine parameters fitted in the test (``fit_niqe_params``).
  * ``utils/lpips.py`` against JAX's ``load_lpips()`` on the same seeded npz
    (``$GLARE_LPIPS_NPZ``) at 64x64, within 1e-5 relative (float32 convolutions
    summed in another order); ``Measure`` reports NaN, with one warning,
    without weights, and needs an explicit CPU without a GPU.
  * ``measure_dirs`` / ``python -m glare_tpu_torch.measure`` on two folders of
    tiny PNGs, against JAX's ``measure_dirs``.
  * ``sr/metrics_fid.py`` (``compute_stats``, ``frechet_distance``,
    ``calculate_fid``) against JAX within 1e-10 relative.
  * ``utils/metrics.py`` without ``cv2``: SSIM within 1e-9 of JAX's (cv2's
    ``filter2D``); ``gray_mean_adjust`` within 1e-6 of the largest value (the JAX
    package's cv2 gray means are float32, the port's float64).
"""

import logging
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter

from glare_tpu import measure as jmeasure
from glare_tpu.sr import metrics_fid as jfid
from glare_tpu.utils import lpips_jax, matlab_functions as jmf, metrics as jmetrics, niqe as jniqe
from glare_tpu_torch import measure as tmeasure
from glare_tpu_torch.sr import metrics as tsr_metrics
from glare_tpu_torch.sr import metrics_fid as tfid
from glare_tpu_torch.utils import lpips as tlpips, matlab_functions as tmf, metrics as tmetrics
from glare_tpu_torch.utils import niqe as tniqe

_CHS = (64, 192, 384, 256, 256)
_CONV = ((3, 11), (64, 5), (192, 3), (384, 3), (256, 3))   # (in channels, kernel) of each tap


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-300))


def _natural_like(rng, h=192, w=192):
    """Smooth 1/f-ish field in [0, 255] gray levels (tests/test_niqe.py's recipe)."""
    img = 0.7 * gaussian_filter(rng.rand(h, w), 6.0) + 0.3 * gaussian_filter(rng.rand(h, w), 1.5)
    img = (img - img.min()) / (img.max() - img.min() + 1e-9)
    return np.round(img * 255.0)


def test_matlab_functions_match_jax():
    rng = np.random.RandomState(0)
    img = rng.rand(23, 31, 3).astype(np.float32)
    u8 = (img * 255).round().astype(np.uint8)
    for fn in ("rgb2ycbcr", "bgr2ycbcr"):
        for a in (img, u8):
            for y_only in (False, True):
                got = getattr(tmf, fn)(a, y_only=y_only)
                want = getattr(jmf, fn)(a, y_only=y_only)
                assert got.dtype == want.dtype and _rel(got, want) <= 1e-10, (fn, a.dtype, y_only)
    assert _rel(tmf.ycbcr2rgb(tmf.rgb2ycbcr(img)), jmf.ycbcr2rgb(jmf.rgb2ycbcr(img))) <= 1e-10
    for a, scale in ((img, 0.5), (img, 1.7), (u8, 0.37), (img[..., 0], 2.0)):
        got, want = tmf.imresize(a, scale), jmf.imresize(a, scale)
        assert got.shape == want.shape and _rel(got, want) <= 1e-10, (a.shape, scale)


def test_niqe_matches_jax_with_fitted_parameters(tmp_path):
    corpus = [_natural_like(rng) for rng in [np.random.RandomState(42)] for _ in range(4)]
    pris = tniqe.fit_niqe_params(corpus)
    jpris = jniqe.fit_niqe_params(corpus)
    assert _rel(pris[0], jpris[0]) <= 1e-10 and _rel(pris[1], jpris[1]) <= 1e-10
    gray = _natural_like(np.random.RandomState(8), 200, 216)
    bgr = np.stack([gray, 0.9 * gray, gray], axis=-1).astype(np.uint8)
    for kw in ({}, {"crop_border": 4}, {"convert_to": "gray"}):
        got = tsr_metrics.calculate_niqe(bgr, pris_params=pris, **kw)
        want = jniqe.calculate_niqe(bgr, pris_params=jpris, **kw)
        assert np.isfinite(got) and abs(got - want) <= 1e-10 * abs(want), kw
    path = str(tmp_path / "pris.npz")
    np.savez(path, mu_pris_param=pris[0], cov_pris_param=pris[1])
    assert all(np.array_equal(a, b) for a, b in zip(tniqe.load_niqe_params(path), pris))


def _seeded_lpips_npz(path, seed=5):
    """Random weights in the layout tools/convert_torch_lpips.py writes."""
    rng = np.random.default_rng(seed)
    data = {}
    for i, (cout, (cin, k)) in enumerate(zip(_CHS, _CONV)):
        data[f"conv_{i}.weight"] = (rng.standard_normal((cout, cin, k, k)) / np.sqrt(cin * k * k)).astype(np.float32)
        data[f"conv_{i}.bias"] = (0.1 * rng.standard_normal(cout)).astype(np.float32)
        data[f"lin_{i}.weight"] = np.abs(rng.standard_normal(cout)).astype(np.float32) / cout
    np.savez(path, **data)
    return path


def test_lpips_matches_jax_and_measure_reports_nan_without_weights(tmp_path, monkeypatch, caplog):
    monkeypatch.setattr(tlpips, "probe_lpips_cache", lambda: None)
    monkeypatch.delenv("GLARE_LPIPS_NPZ", raising=False)
    # a training CLI run earlier in the same process leaves "base" unpropagated
    # (setup_logger); caplog reads records through the root logger
    monkeypatch.setattr(logging.getLogger("base"), "propagate", True)
    m = tmeasure.Measure(device="cpu")
    rng = np.random.default_rng(1)
    a = rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)
    b = np.clip(a.astype(int) + rng.integers(-40, 40, a.shape), 0, 255).astype(np.uint8)
    with caplog.at_level(logging.WARNING, logger="base"):
        assert np.isnan(m.lpips(a, b)) and np.isnan(m.lpips(b, a))
    assert sum("LPIPS weights unavailable" in r.getMessage() for r in caplog.records) == 1

    monkeypatch.setenv("GLARE_LPIPS_NPZ", _seeded_lpips_npz(str(tmp_path / "lpips.npz")))
    jfn = lpips_jax.load_lpips()
    net = tlpips.load_lpips("cpu")
    assert net is not None and all(p.dtype == torch.float32 for p in net.parameters())
    ta, tb = tmeasure.t(a), tmeasure.t(b)
    with torch.no_grad():
        got = float(net(torch.cat([ta, tb]), torch.cat([tb, ta])))
    want = float(jfn(jnp.asarray(np.concatenate([jmeasure.t(a), jmeasure.t(b)])),
                     jnp.asarray(np.concatenate([jmeasure.t(b), jmeasure.t(a)]))))
    assert got > 0 and abs(got - want) <= 1e-5 * abs(want)
    m = tmeasure.Measure(device="cpu")
    psnr, ssim, lp = m.measure(a, b)
    assert abs(lp - float(jfn(jnp.asarray(jmeasure.t(a)), jnp.asarray(jmeasure.t(b))))) <= 1e-5 * lp
    assert psnr == jmetrics.calculate_psnr(a, b) and abs(ssim - jmetrics.calculate_ssim(a, b)) <= 1e-9
    assert float(m.lpips(a, a)) == 0.0


def test_measure_needs_an_explicit_cpu_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmeasure.Measure()


def test_measure_takes_the_jax_use_gpu_keyword(tmp_path):
    """``use_gpu`` (glare_tpu/measure.py; cli/infer_paired.py passes False): False is
    the CPU, True the card; with ``device`` as well it raises."""
    assert tmeasure.Measure(use_gpu=False).device == torch.device("cpu")
    assert tmeasure.Measure("alex", False).device == torch.device("cpu")   # JAX's positional order
    if torch.cuda.is_available():
        assert tmeasure.Measure(use_gpu=True).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tmeasure.Measure(use_gpu=True)
    with pytest.raises(ValueError, match="not both"):
        tmeasure.Measure(use_gpu=False, device="cpu")
    with pytest.raises(ValueError, match="not both"):
        tmeasure.measure_dirs(str(tmp_path), str(tmp_path), use_gpu=False, device="cpu")


def test_measure_dirs_on_two_png_folders(tmp_path, monkeypatch, capsys):
    cv2 = pytest.importorskip("cv2")
    monkeypatch.setenv("GLARE_LPIPS_NPZ", _seeded_lpips_npz(str(tmp_path / "lpips.npz")))
    rng = np.random.default_rng(2)
    for d in ("a", "b/sub"):
        os.makedirs(tmp_path / d)
    for i in range(2):
        img = rng.integers(0, 256, (40, 48, 3), dtype=np.uint8)
        cv2.imwrite(str(tmp_path / "a" / f"{i}.png"), img)
        cv2.imwrite(str(tmp_path / "b" / "sub" / f"{i}.png"), np.clip(img.astype(int) + 9, 0, 255).astype(np.uint8))
    want = jmeasure.measure_dirs(str(tmp_path / "a"), str(tmp_path / "b"))
    got = tmeasure.main(["-dirA", str(tmp_path / "a"), "-dirB", str(tmp_path / "b"), "-v",
                         "--device", "cpu"])
    assert "Final Result:" in capsys.readouterr().out
    assert [r["name"] for r in got] == [r["name"] for r in want] == ["0.png", "1.png"]
    for g, w in zip(got, want):
        assert g["psnr"] == w["psnr"] and abs(g["ssim"] - w["ssim"]) <= 1e-9
        assert abs(g["lpips"] - w["lpips"]) <= 1e-5 * w["lpips"]
    # the JAX call's keyword
    assert tmeasure.measure_dirs(str(tmp_path / "a"), str(tmp_path / "b"), use_gpu=False) == got


def test_fid_matches_jax():
    rng = np.random.default_rng(4)
    f1 = rng.standard_normal((40, 6))
    f2 = 0.8 * rng.standard_normal((50, 6)) + 0.3
    for a, b in (zip(tfid.compute_stats(f1), jfid.compute_stats(f1))):
        assert _rel(a, b) <= 1e-10
    got = tsr_metrics.build_metric("calculate_fid")(f1, f2)
    want = jfid.calculate_fid(f1, f2)
    assert got > 0 and abs(got - want) <= 1e-10 * want
    stats = (tfid.compute_stats(f1), tfid.compute_stats(f2))
    assert abs(tfid.frechet_distance(*stats[0], *stats[1]) - want) <= 1e-10 * want
    assert abs(tfid.calculate_fid(stats[0], stats[1]) - want) <= 1e-10 * want
    with pytest.raises(NotImplementedError, match="InceptionV3"):
        tfid.calculate_fid(None, imgs1=np.zeros((2, 8, 8, 3)), imgs2=np.zeros((2, 8, 8, 3)))


def test_protocol_metrics_need_no_cv2(monkeypatch):
    rng = np.random.RandomState(3)
    a = rng.randint(0, 256, (45, 61, 3), np.uint8)
    b = np.clip(a.astype(int) + rng.randint(-12, 12, a.shape), 0, 255).astype(np.uint8)
    restored, target = rng.uniform(0, 1, (45, 61, 3)), rng.uniform(0, 1, (45, 61, 3))
    want_ssim = jmetrics.calculate_ssim(a, b)
    want_adj = jmetrics.gray_mean_adjust(restored, target)
    monkeypatch.setitem(sys.modules, "cv2", None)          # any import of cv2 now fails
    assert abs(tmetrics.calculate_ssim(a, b) - want_ssim) <= 1e-9
    got_adj = tmetrics.gray_mean_adjust(restored, target)
    assert np.abs(got_adj - want_adj).max() <= 1e-6 * np.abs(want_adj).max()


def test_paired_cli_step_writes_the_lpips_column(tmp_path, monkeypatch):
    """``cli/infer_paired.py``'s per-image step on arrays: the padded output cropped,
    gray-mean adjusted, and PSNR / SSIM / LPIPS as the JAX CLI computes them; the
    LPIPS column is NaN with the JAX CLI's note without weights."""
    from glare_tpu_torch.cli import infer_paired

    monkeypatch.setattr(tlpips, "probe_lpips_cache", lambda: None)
    monkeypatch.delenv("GLARE_LPIPS_NPZ", raising=False)
    rng = np.random.default_rng(6)
    hr = rng.integers(0, 256, (64, 72, 3), dtype=np.uint8)
    sr = rng.uniform(0, 1.1, (84, 92, 3)).astype(np.float32)     # the model's padded output
    out, meas = infer_paired.measure_output(sr, 64, hr, tmeasure.Measure(device="cpu"))
    assert list(meas) == ["PSNR", "SSIM", "LPIPS"] and np.isnan(meas["LPIPS"])
    assert "LPIPS: NaN (weights missing; set GLARE_LPIPS_NPZ)" in infer_paired.format_measurements(meas)
    target = hr.astype(np.float64) / 255.0
    restored = jmetrics.gray_mean_adjust(np.clip(sr[:64, 20:], 0, 1), target)
    # the gray means are float64 here, float32 in JAX's cv2: the adjusted images differ by
    # ~1e-7, enough for a pixel on a rounding edge to take the other uint8 level in SSIM
    assert out.shape == hr.shape and abs(meas["PSNR"] - jmetrics.PSNR(target, restored)) <= 1e-5
    assert abs(meas["SSIM"] - jmetrics.calculate_ssim(jmetrics.img_as_ubyte(target),
                                                       jmetrics.img_as_ubyte(restored))) <= 1e-3
    monkeypatch.setenv("GLARE_LPIPS_NPZ", _seeded_lpips_npz(str(tmp_path / "lpips.npz")))
    _, meas = infer_paired.measure_output(sr, 64, hr, tmeasure.Measure(device="cpu"))
    assert np.isfinite(meas["LPIPS"]) and meas["LPIPS"] > 0
    lr_t, h = infer_paired.prep(hr // 8, {"datasets": {"train": {"log_low": True}}})
    assert lr_t.shape == (84, 92, 3) and h == 64 and lr_t.dtype == np.float32
