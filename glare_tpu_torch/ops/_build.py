"""Builds and loads the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` has a plain C interface (no PyTorch headers, so a
build takes seconds) and becomes its own shared library:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/glare_tpu_torch/<name>-<hash>.so csrc/<name>.cu

The first :func:`load` builds EVERY source, one ``nvcc`` process per file,
all started together; later calls reuse the libraries. The file name
carries a hash of the source, of every header under ``csrc/`` (``*.cuh``,
e.g. ``dcn_tap.cuh``, which ``dcn_fwd.cu`` and ``dcn_bwd.cu`` share) and of
the flags, so an edit rebuilds. Libraries
are loaded with ``ctypes``; the caller sets ``argtypes`` (``c_void_p`` for
every pointer and for the stream).

The build directory is ``build/glare_tpu_torch/`` beside the package
(git-ignored).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

CSRC_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict = {}
build_seconds = 0.0   # wall time the last build_all() spent compiling
build_log: dict = {}  # name -> nvcc output (ptxas register/shared-memory report)


def build_dir() -> str:
    root = os.path.dirname(os.path.dirname(CSRC_DIR))
    d = os.path.join(root, "build", "glare_tpu_torch")
    os.makedirs(d, exist_ok=True)
    return d


def find_nvcc() -> str:
    cands = [shutil.which("nvcc")]
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"), "/usr/local/cuda"):
        if home:
            cands.append(os.path.join(home, "bin", "nvcc"))
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError(
        "nvcc not found (looked on PATH, $CUDA_HOME, /usr/local/cuda): the CUDA "
        "kernels of glare_tpu_torch are compiled on the machine that runs them")


def sources() -> dict:
    return {
        os.path.splitext(f)[0]: os.path.join(CSRC_DIR, f)
        for f in sorted(os.listdir(CSRC_DIR)) if f.endswith(".cu")
    }


def headers() -> list:
    return [os.path.join(CSRC_DIR, f) for f in sorted(os.listdir(CSRC_DIR)) if f.endswith(".cuh")]


def nvcc_command(src: str, out: str) -> list:
    """The nvcc command that builds ``src`` (a source under ``csrc/`` or a copy
    elsewhere that includes its headers) into the shared library ``out``."""
    return [find_nvcc(), *NVCC_FLAGS, "-I", CSRC_DIR, "-o", out, src]


def _lib_path(name: str, src: str) -> str:
    h = hashlib.sha256()
    for path in [src, *headers()]:
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(build_dir(), f"{name}-{h.hexdigest()[:16]}.so")


def build_all() -> dict:
    """Compile every stale source in parallel; returns {name: library path}.
    Raises RuntimeError with nvcc's output if any compile fails."""
    global build_seconds
    paths = {name: _lib_path(name, src) for name, src in sources().items()}
    todo = {n: p for n, p in paths.items() if not os.path.exists(p)}
    if not todo:
        return paths
    t0 = time.time()
    procs = {}
    for name, out in todo.items():
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = nvcc_command(sources()[name], tmp)
        procs[name] = (tmp, out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failures = []
    for name, (tmp, out, proc) in procs.items():
        log, _ = proc.communicate()
        build_log[name] = log
        if proc.returncode != 0:
            failures.append(f"--- nvcc failed for csrc/{name}.cu (exit {proc.returncode}) ---\n{log}")
            if os.path.exists(tmp):
                os.remove(tmp)
        else:
            os.replace(tmp, out)
    build_seconds = time.time() - t0
    if failures:
        raise RuntimeError("\n".join(failures))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The shared library built from ``csrc/<name>.cu`` (built on first use)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(build_all()[name])
            _libs[name] = lib
        return lib


def on_card(t) -> bool:
    """Whether a wrapper launches its kernel for tensor ``t`` (else it takes the
    plain version): ``t`` lies on a CUDA device. One predicate for every
    wrapper, so that the CPU tests can stub it to reach the launch-side rules."""
    return t.is_cuda


def needs_grad(*tensors) -> bool:
    """Whether autograd would differentiate through these inputs (None ignored)."""
    import torch

    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


def refuse_grad(op: str, *tensors) -> None:
    """The launch-side autograd rule of a kernel without a backward: with grad
    enabled, an input that requires grad would get an output filled through
    ``ctypes``, cut from the graph without an error. Raise instead, naming the
    op. (The DCN forward has a backward: ``ops.dcn.ModulatedDeformConvFunction``.)"""
    if needs_grad(*tensors):
        raise RuntimeError(
            f"{op}: an input requires grad, but this CUDA kernel has no backward and its "
            "output would carry none; call it under torch.no_grad() / inference_mode(), "
            "or detach the inputs")


def check(err: int, what: str) -> None:
    """Raise if a kernel's C entry returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error code {err} "
                           "(see cudaError_t; 1 = invalid value, e.g. too much shared memory)")
