"""ctypes bindings for the C++ host data-path core (counterpart of
``glare_tpu/data/native.py``; source ``glare_tpu_torch/csrc/glare_native.cpp``).

The library is built on first use with ``g++ -O3 -shared -fPIC -std=c++17`` into
``build/glare_tpu_torch/glare_native-<hash>.so`` (git-ignored; the hash covers
the source and the flags, so an edit rebuilds). It fuses the preprocessing chain
of the inference CLI (uint8 -> float32 / 255, the log transform, reflect pad,
NHWC batch assembly) and the training crop's flips and quarter turns into single
C++ passes.

The byte -> float32 table is computed here by the plain numpy version
(``utils.imgproc.preprocess_padded`` over the 256 byte values) and handed to the
C++ loops, so every entry is bit-equal to numpy; ``logf`` in C++ and numpy's
float32 log disagree in the last bits for some bytes.

Unlike the JAX package, the port keeps no quiet numpy fallback: a failed build
raises (``RuntimeError`` with the compiler's output). The numpy functions of
``utils/imgproc.py`` stay the plain versions the tests hold these against.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading

import numpy as np

from ..ops._build import CSRC_DIR, build_dir
from ..utils.imgproc import preprocess_padded as _plain_preprocess

SRC = os.path.join(CSRC_DIR, "glare_native.cpp")
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
VERSION = 2

_lock = threading.Lock()
_lib = None


def lib_path() -> str:
    h = hashlib.sha256()
    with open(SRC, "rb") as f:
        h.update(f.read())
    h.update(" ".join(CXX_FLAGS).encode())
    return os.path.join(build_dir(), f"glare_native-{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the source if its library is missing -> the library's path. Raises
    RuntimeError when there is no C++ compiler or the compile fails."""
    out = lib_path()
    if os.path.exists(out):
        return out
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("glare_tpu_torch.data.native: no C++ compiler (g++) on PATH; the port "
                           "keeps no numpy fallback on the CLI's path")
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.run([cxx, *CXX_FLAGS, SRC, "-o", tmp], capture_output=True, text=True)
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"g++ failed for {SRC} (exit {proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """The library (built on first use), with the argument types set."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            p = ctypes.c_void_p
            lib.u8_to_f32_lut.argtypes = [p, p, ctypes.c_int64, p]
            lib.preprocess_into_batch.argtypes = [p, p] + [ctypes.c_int] * 7 + [p]
            lib.crop_augment_f32.argtypes = [p, p] + [ctypes.c_int] * 9
            for fn in (lib.u8_to_f32_lut, lib.preprocess_into_batch, lib.crop_augment_f32):
                fn.restype = None
            lib.glare_native_version.argtypes, lib.glare_native_version.restype = [], ctypes.c_int
            if lib.glare_native_version() != VERSION:
                raise RuntimeError(f"glare_native: library version {lib.glare_native_version()} != {VERSION}")
            _lib = lib
        return _lib


@functools.lru_cache(maxsize=8)
def value_table(apply_log=False, eps=1e-3):
    """The 256 float32 values the plain version gives the bytes 0..255."""
    table = _plain_preprocess(np.arange(256, dtype=np.uint8).reshape(1, 256, 1), apply_log=apply_log, eps=eps)
    table = np.ascontiguousarray(table.reshape(256), np.float32)
    table.flags.writeable = False
    return table


def _ptr(a):
    return a.ctypes.data


def u8_to_f32(img_u8, apply_log=False, eps=1e-3):
    """uint8 array -> float32 / 255 (+ the log transform)."""
    img_u8 = np.ascontiguousarray(img_u8, np.uint8)
    out = np.empty(img_u8.shape, np.float32)
    load().u8_to_f32_lut(_ptr(img_u8), _ptr(out), img_u8.size, _ptr(value_table(bool(apply_log), float(eps))))
    return out


def _check_pads(h, w, top, bottom, left, right):
    if min(top, bottom, left, right) < 0 or max(top, bottom) >= h or max(left, right) >= w:
        raise ValueError(f"reflect pads ({top}, {bottom}, {left}, {right}) must lie in [0, size) of {h}x{w}")


def preprocess_padded(img_u8, top=0, bottom=0, left=0, right=0, apply_log=False, eps=1e-3, out=None):
    """Fused uint8 HWC -> reflect-padded float32 HWC (optionally log-domain): the
    plain ``utils.imgproc.preprocess_padded``, bit for bit. ``out`` may be a
    preallocated C-contiguous [H+pad, W+pad, C] float32 slot (a batch row)."""
    img_u8 = np.ascontiguousarray(img_u8, np.uint8)
    h, w, c = img_u8.shape
    _check_pads(h, w, top, bottom, left, right)
    shape = (h + top + bottom, w + left + right, c)
    if out is None:
        out = np.empty(shape, np.float32)
    if out.shape != shape or out.dtype != np.float32 or not out.flags["C_CONTIGUOUS"]:
        raise ValueError(f"out must be a C-contiguous float32 array of shape {shape}")
    load().preprocess_into_batch(_ptr(img_u8), _ptr(out), h, w, c, top, bottom, left, right,
                                 _ptr(value_table(bool(apply_log), float(eps))))
    return out


def crop_augment(img_f32, top, left, hc, wc, hflip=False, vflip=False, rot90=0):
    """Fused crop + flips + rot90 (quarter turns in {0, 1, 3}) of HWC float32."""
    if rot90 not in (0, 1, 3):
        raise ValueError(f"rot90 must be 0, 1 or 3, not {rot90}")
    img_f32 = np.ascontiguousarray(img_f32, np.float32)
    h, w, c = img_f32.shape
    if top < 0 or left < 0 or top + hc > h or left + wc > w:
        raise ValueError(f"crop ({top}, {left}, {hc}, {wc}) outside {h}x{w}")
    out = np.empty((wc, hc, c) if rot90 else (hc, wc, c), np.float32)
    load().crop_augment_f32(_ptr(img_f32), _ptr(out), w, c, top, left, hc, wc,
                            int(hflip), int(vflip), int(rot90))
    return out
