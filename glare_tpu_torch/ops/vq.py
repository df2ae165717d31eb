"""Codebook retrieval (nearest-neighbour vector quantization).

Counterpart of ``glare_tpu/ops/vq.py``. Three functions:

  * :func:`nearest_code_ref` -- plain PyTorch version (CPU path, oracle).
  * :func:`nearest_code_cuda` -- the hand-written kernel ``csrc/vq_argmin.cu``
    (replaces the Pallas ``_vq_kernel``): distances never reach device memory.
  * :func:`nearest_code` -- dispatch by where the tensor lies: a CUDA tensor
    launches the kernel (or raises), a CPU tensor takes the plain version.

Both return int32 indices ``[N]``; ties go to the lowest index. Both use the
same expression, ``|e|^2 - 2 z.e`` with the per-token ``|z|^2`` dropped (it
does not move the argmin), so near-ties round alike.

What bounds the kernel on an H100: float32 operations, ``N*K*(D+1)`` FMAs;
bytes are negligible. Design notes are in the CUDA source.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

launches = 0  # +1 per kernel launch, nowhere else


def _augment(codebook: torch.Tensor) -> torch.Tensor:
    """[K, D] -> [K, D+1] rows (-2 e, |e|^2) in float32."""
    e = codebook.float()
    return torch.cat([-2.0 * e, (e * e).sum(dim=1, keepdim=True)], dim=1).contiguous()


def nearest_code_ref(z_flat: torch.Tensor, codebook: torch.Tensor,
                     chunk: int = 8192) -> torch.Tensor:
    """z_flat [N, D], codebook [K, D] -> int32 [N]; plain PyTorch."""
    w = _augment(codebook)
    z = z_flat.float()
    z1 = torch.cat([z, torch.ones_like(z[:, :1])], dim=1)
    out = []
    for i in range(0, max(z1.shape[0], 1), chunk):  # bound the [chunk, K] matrix
        d = z1[i:i + chunk] @ w.t()
        out.append(torch.argmin(d, dim=1))
    return torch.cat(out).to(torch.int32)


_lib = None


def _kernel():
    global _lib
    if _lib is None:
        lib = _build.load("vq_argmin")
        lib.vq_argmin_f32.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        lib.vq_argmin_f32.restype = ctypes.c_int
        _lib = lib
    return _lib


def nearest_code_cuda(z_flat: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    global launches
    if not (z_flat.is_cuda and codebook.is_cuda):
        raise ValueError("nearest_code_cuda needs CUDA tensors")
    if z_flat.dim() != 2 or codebook.dim() != 2 or z_flat.shape[1] != codebook.shape[1]:
        raise ValueError(f"expected z [N, D] and codebook [K, D], got "
                         f"{tuple(z_flat.shape)} and {tuple(codebook.shape)}")
    if codebook.shape[0] < 1:
        raise ValueError("empty codebook")
    z = z_flat.float().contiguous()
    w = _augment(codebook)
    n, d = z.shape
    idx = torch.empty(n, dtype=torch.int32, device=z.device)
    if n == 0:
        return idx
    with torch.cuda.device(z.device):
        err = _kernel().vq_argmin_f32(z.data_ptr(), w.data_ptr(), idx.data_ptr(), n, d,
                                      w.shape[0], torch.cuda.current_stream().cuda_stream)
    _build.check(err, "vq_argmin_f32")
    launches += 1
    return idx


def nearest_code(z_flat: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Kernel for a CUDA tensor, plain version for a CPU tensor."""
    if z_flat.is_cuda:
        return nearest_code_cuda(z_flat, codebook)
    return nearest_code_ref(z_flat, codebook)
