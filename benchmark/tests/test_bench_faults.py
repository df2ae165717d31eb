"""``correct`` has to come out false when the answers are wrong.

On the CPU, at miniature widths and sizes and in float32 (so that a sound run
reads near zero and a fault's reading is its own), a whole run of each cell is
driven (the look for a card is skipped) with the timed path broken underneath: the
answers returned unchanged from the inputs, half of a batch's answers left out
(the other half's in their place), one answer altered where it is produced, a
quarter of one answer altered (where the cell compares a number that a region
reaches). And each control that the cell names under
``caught``, the reference computed below the configuration's precision in the
program's place (``benchmark/control.py``), has to come out not correct. The
same controls at the cell's own size are the ``gpu`` case."""

import functools

import numpy as np
import pytest

from benchmark.control import readings
from benchmark.harness import bench
from benchmark.harness.registry import Registry

from conftest import BIG_SEED, MINI, MINI_MIX

CELLS = [w["name"] for w in Registry().spec()["workloads"]]
MINI_F32 = dict(MINI, inference_dtype="float32")
REGIONAL = {"share_off_10"}       # the numbers that a fault in a region reaches


def _shaped(photo, like):
    img = photo if like.dtype == np.uint8 else photo / 255.0
    h, w, _ = img.shape
    img = np.pad(img, [(0, max(0, like.shape[0] - h)), (0, max(0, like.shape[1] - w)), (0, 0)], "edge")
    return img[:like.shape[0], :like.shape[1]].astype(like.dtype)


def unchanged(program, side):
    def call(photos):
        return [_shaped(p, a) for p, a in zip(photos, program(photos))]
    return call


def half_batch(program, side):
    def call(photos):
        answers = program(photos)
        n = len(answers)
        return answers[:n - n // 2] + answers[:n // 2]
    return call


def _brighter(a, rows=None, cols=None):
    out = a.copy()
    if a.dtype == np.uint8:
        out[rows, cols] = np.minimum(a[rows, cols].astype(np.int32) + 51, 255).astype(np.uint8)
    else:
        out[rows, cols] = a[rows, cols] + 0.2
    return out


def altered(program, side):
    def call(photos):
        answers = program(photos)
        answers[0] = _brighter(answers[0], slice(None), slice(None))
        return answers
    return call


def quarter(program, side):
    def call(photos):
        answers = program(photos)
        h, w = answers[-1].shape[:2]
        answers[-1] = _brighter(answers[-1], slice(h // 2, None), slice(w // 2, None))
        return answers
    return call


FAULTS = {"unchanged": unchanged, "half_batch": half_batch, "altered": altered, "quarter": quarter}


@functools.lru_cache(maxsize=None)
def _sound(cell):
    return _run(cell)


def _run(cell, fault=None):
    return bench.run(cell, BIG_SEED, 0.5, False, device="cpu", cfg_override=MINI_F32,
                     mix_override=MINI_MIX[cell], fault=fault, log=lambda *a, **k: None)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_timed_path_is_not_correct(cell, fault):
    if fault == "half_batch" and MINI_MIX[cell].get("batch", 1) == 1:
        pytest.skip("a batch of one has no half to leave out")
    if fault == "quarter" and not REGIONAL & set(Registry().workload(cell)["limits"]):
        pytest.skip("the cell compares no number that a fault in a quarter of an image reaches")
    sound = _sound(cell)
    broken = _run(cell, FAULTS[fault])
    assert broken["correct"] is False
    assert any(v["value"] > max(v["limit"], 3 * sound["limits"][k]["value"])
               for k, v in broken["limits"].items())


@pytest.mark.parametrize("cell", CELLS)
def test_the_controls_read_above_the_limits_on_the_cpu(cell):
    wl = Registry().workload(cell)
    program, *controls = readings(cell, [BIG_SEED], "cpu", ["program", *wl["caught"]], cfg_override=MINI,
                                  mix_override=MINI_MIX[cell])
    # at miniature widths the separation is smaller than at the cell's (the gpu case)
    for row in controls:
        assert row["correct"] is False
        assert any(row["numbers"][k] > max(limit, 2 * program["numbers"][k])
                   for k, limit in wl["limits"].items()), (program, row)


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_the_controls_fail_and_the_program_passes_at_the_cell_size(cell, cuda):
    caught = Registry().workload(cell)["caught"]
    for r in readings(cell, [BIG_SEED + k for k in range(3)], cuda, ["program", *caught]):
        assert r["correct"] is (r["side"] == "program"), r
