"""The comparison that decides ``correct``: the program's answers against the reference's.

Each answer is an image. Per answer, with ``d = |program - reference| / rms``
over all its values and ``rms`` the reference's root mean square:

    median_err     median(d): the error of the typical value, which the precision
                   of the arithmetic sets and a few codebook picks that rounding
                   moves to a neighbouring code (a local change) do not
    share_off_10   the share of values with d above 0.1: how much of the image a
                   fault or a lowered precision moves, where the median cannot see
                   it (a region under half of the image)

The number compared for each is the worst over the sampled answers. A missing,
misshapen or non-finite answer reads infinity.
"""

from __future__ import annotations

import math

import numpy as np

NUMBERS = ("median_err", "share_off_10")


def errors(answer, ref):
    if answer is None:
        return dict.fromkeys(NUMBERS, math.inf)
    a = np.asarray(answer, np.float64)
    r = np.asarray(ref, np.float64)
    if a.shape != r.shape or not np.isfinite(a).all():
        return dict.fromkeys(NUMBERS, math.inf)
    d = np.abs(a - r) / max(float(np.sqrt(np.mean(r * r))), 1e-30)
    return {"median_err": float(np.median(d)), "share_off_10": float(np.mean(d > 0.1))}


def worst(answers, refs):
    """{number: its worst value over the answers} (infinity when there are none)."""
    rows = [errors(a, r) for a, r in zip(answers, refs)]
    return {k: max((row[k] for row in rows), default=math.inf) for k in NUMBERS}
