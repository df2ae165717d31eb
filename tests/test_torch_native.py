"""The port's C++ host data-path core (``glare_tpu_torch/data/native.py``, source
``glare_tpu_torch/csrc/glare_native.cpp``) against its numpy plain version and
against the JAX package's ``glare_tpu.data.native``, on the same uint8 inputs.

Bars: bit-equal to the plain version (``utils.imgproc.preprocess_padded`` and the
numpy slicing of a crop) everywhere; bit-equal to the JAX core where both compute
the same floats (/255, reflect pad, crop, flips, quarter turns). With the log
transform the JAX core takes C's ``logf`` (built with ``-march=native``, which
may vectorise it), which differs from numpy's float32 log by a few ulp for some
bytes; the port takes numpy's values (its table is the plain version's), so
there the two cores agree at the JAX core's own bar against numpy (1e-6
absolute, tests/test_native.py).

The JAX core is built into a temporary directory (its ``_LIB`` redirected), so
``native/libglare_native.so`` is not touched.
"""

import numpy as np
import pytest

from glare_tpu.data import native as jnative
from glare_tpu_torch.data import native
from glare_tpu_torch.utils.imgproc import preprocess_padded as plain_preprocess


@pytest.fixture(scope="module")
def jax_core(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    mp.setattr(jnative, "_LIB", str(tmp_path_factory.mktemp("jax_native") / "libglare_native.so"))
    mp.setattr(jnative, "_lib", None)
    mp.setattr(jnative, "_tried", False)
    if jnative.load() is None:
        mp.undo()
        pytest.fail("the JAX native core did not build (g++ missing?)")
    yield jnative
    mp.undo()


def _bits(a):
    return np.ascontiguousarray(a, np.float32).view(np.int32)


def test_version_and_build_dir():
    lib = native.load()
    assert lib.glare_native_version() == native.VERSION
    assert "build" in native.lib_path() and native.lib_path().endswith(".so")


@pytest.mark.parametrize("apply_log", [False, True])
def test_preprocess_padded_bit_equal_to_plain_and_jax(jax_core, apply_log):
    img = np.random.RandomState(1).randint(0, 256, (48, 62, 3), np.uint8)
    got = native.preprocess_padded(img, bottom=20, left=20, apply_log=apply_log)
    want = plain_preprocess(img, bottom=20, left=20, apply_log=apply_log)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    jax_out = jax_core.preprocess_padded(img, bottom=20, left=20, apply_log=apply_log)
    if apply_log:
        np.testing.assert_allclose(got, jax_out, atol=1e-6, rtol=0)
    else:
        np.testing.assert_array_equal(_bits(got), _bits(jax_out))


def test_value_table_covers_every_byte(jax_core):
    """All 256 bytes: the port's table is the plain version's bit for bit; the JAX
    core's logf table agrees within 1e-6 (and exactly without the log)."""
    every = np.arange(256, dtype=np.uint8).reshape(16, 16, 1)
    for apply_log in (False, True):
        got = native.u8_to_f32(every, apply_log=apply_log)
        want = plain_preprocess(every, apply_log=apply_log)
        np.testing.assert_array_equal(_bits(got), _bits(want))
        jax_out = jax_core.u8_to_f32(every, apply_log=apply_log)
        np.testing.assert_allclose(got, jax_out, atol=1e-6, rtol=0)
        if not apply_log:
            np.testing.assert_array_equal(_bits(got), _bits(jax_out))


def test_preprocess_into_preallocated_batch(jax_core):
    img = np.random.RandomState(2).randint(0, 256, (10, 12, 3), np.uint8)
    batch = np.zeros((2, 14, 16, 3), np.float32)
    native.preprocess_padded(img, 2, 2, 2, 2, apply_log=False, out=batch[1])
    np.testing.assert_array_equal(_bits(batch[1]), _bits(plain_preprocess(img, 2, 2, 2, 2)))
    assert batch[0].max() == 0
    with pytest.raises(ValueError):
        native.preprocess_padded(img, 2, 2, 2, 2, out=np.zeros((14, 15, 3), np.float32))
    with pytest.raises(ValueError):   # a pad as wide as the image is not numpy's one reflection
        native.preprocess_padded(img, top=10)


@pytest.mark.parametrize("hflip", [False, True])
@pytest.mark.parametrize("vflip", [False, True])
@pytest.mark.parametrize("rot90", [0, 1, 3])
def test_crop_augment_bit_equal_to_numpy_and_jax(jax_core, hflip, vflip, rot90):
    img = plain_preprocess(np.random.RandomState(3).randint(0, 256, (20, 24, 3), np.uint8), apply_log=True)
    got = native.crop_augment(img, 4, 5, 8, 10, hflip, vflip, rot90)
    x = img[4:12, 5:15]
    if hflip:
        x = x[:, ::-1]
    if vflip:
        x = x[::-1]
    if rot90:
        x = np.rot90(x, rot90, axes=(0, 1))
    np.testing.assert_array_equal(_bits(got), _bits(np.ascontiguousarray(x)))
    np.testing.assert_array_equal(_bits(got), _bits(jax_core.crop_augment(img, 4, 5, 8, 10, hflip, vflip, rot90)))


def test_cli_prep_goes_through_native(monkeypatch):
    from glare_tpu_torch.cli import infer_paired

    calls = []
    real = native.preprocess_padded

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(infer_paired, "preprocess_padded", counted)
    img = np.random.RandomState(5).randint(0, 256, (40, 60, 3), np.uint8)
    x, h = infer_paired.prep(img, {"datasets": {"train": {"log_low": True}}})
    assert calls == [1] and h == 40 and x.shape == (60, 80, 3)
    np.testing.assert_array_equal(_bits(x), _bits(plain_preprocess(img, bottom=20, left=20, apply_log=True)))


def test_failed_build_raises(tmp_path, monkeypatch):
    """No quiet numpy fallback: a source that does not compile raises."""
    bad = tmp_path / "glare_native.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", str(bad))
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.preprocess_padded(np.zeros((4, 4, 3), np.uint8))
