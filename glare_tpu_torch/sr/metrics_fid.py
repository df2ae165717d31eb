"""FID — Frechet Inception Distance machinery
(reference: defor_cuda_ext/basicsr/metrics/{calculate_fid_folder,
calculate_stylegan2_fid}.py, which import a never-vendored
basicsr.metrics.fid and are non-functional as shipped; SURVEY.md §2.2).

This is the working equivalent of the math those CLIs delegate to:
``compute_stats`` (mu/sigma of a feature matrix), ``frechet_distance``
(the FID formula with a numerically-guarded matrix sqrt), and
``calculate_fid`` accepting either raw feature matrices or precomputed
(mu, sigma) stats — exactly the stats-file workflow the reference CLIs
implement. Feature *extraction* needs pretrained InceptionV3 (unavailable
offline; no package here provides it): pass any ``extractor`` callable, or
precompute features/stats elsewhere. Everything is host-side numpy and
scipy: FID is an offline eval metric. The port's own copy of
``glare_tpu/sr/metrics_fid.py``.
"""

from __future__ import annotations

import numpy as np
from scipy import linalg

from .registry import METRIC_REGISTRY


def compute_stats(features):
    """features [N, D] -> (mu [D], sigma [D, D])."""
    feats = np.asarray(features, np.float64)
    assert feats.ndim == 2 and feats.shape[0] > 1, feats.shape
    mu = feats.mean(axis=0)
    sigma = np.cov(feats, rowvar=False)
    return mu, sigma


def frechet_distance(mu1, sigma1, mu2, sigma2, eps=1e-6):
    """||mu1-mu2||^2 + Tr(s1 + s2 - 2 sqrt(s1 s2)), with the standard
    jitter retry and imaginary-part guard (pytorch-fid convention)."""
    mu1 = np.atleast_1d(np.asarray(mu1, np.float64))
    mu2 = np.atleast_1d(np.asarray(mu2, np.float64))
    sigma1 = np.atleast_2d(np.asarray(sigma1, np.float64))
    sigma2 = np.atleast_2d(np.asarray(sigma2, np.float64))
    diff = mu1 - mu2

    covmean, _ = linalg.sqrtm(sigma1 @ sigma2, disp=False)
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean, _ = linalg.sqrtm(
            (sigma1 + offset) @ (sigma2 + offset), disp=False)
    if np.iscomplexobj(covmean):
        if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
            raise ValueError(
                f"sqrtm produced large imaginary component "
                f"{np.max(np.abs(covmean.imag))}")
        covmean = covmean.real
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2)
                 - 2.0 * np.trace(covmean))


def _as_stats(x):
    if isinstance(x, tuple) and len(x) == 2:
        return np.asarray(x[0], np.float64), np.asarray(x[1], np.float64)
    x = np.asarray(x)
    if x.ndim == 2:
        # any bare 2-D array is a feature matrix [N, D]; precomputed stats
        # must come in as a (mu, sigma) tuple (the stats-file workflow)
        return compute_stats(x)
    raise ValueError(f"expected features [N, D] or (mu, sigma), got {x.shape}")


@METRIC_REGISTRY.register()
def calculate_fid(feats1, feats2=None, extractor=None, imgs1=None,
                  imgs2=None, **_):
    """FID between two feature sets / stats.

    feats1/feats2: [N, D] feature matrices or (mu, sigma) tuples — the
    stats-file workflow of the reference CLIs. Alternatively pass raw
    imgs1/imgs2 plus an ``extractor`` callable (images -> [N, D]).
    """
    if imgs1 is not None or imgs2 is not None:
        if extractor is None:
            raise NotImplementedError(
                "FID from raw images needs a pretrained InceptionV3 "
                "extractor, unavailable offline (no package here provides "
                "one; the reference's CLIs import a never-vendored "
                "basicsr.metrics.fid and are equally non-functional as "
                "shipped). Pass extractor=, or precompute features/stats "
                "and call calculate_fid(feats1, feats2)."
            )
        feats1 = extractor(imgs1)
        feats2 = extractor(imgs2)
    if feats2 is None:
        raise ValueError("calculate_fid needs two feature sets / stats")
    mu1, s1 = _as_stats(feats1)
    mu2, s2 = _as_stats(feats2)
    return frechet_distance(mu1, s1, mu2, s2)
