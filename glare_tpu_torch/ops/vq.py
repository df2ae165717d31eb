"""Codebook retrieval (nearest-neighbour vector quantization).

Counterpart of ``glare_tpu/ops/vq.py``. Three functions:

  * :func:`nearest_code_ref` -- plain PyTorch version (CPU path, oracle).
  * :func:`nearest_code_cuda` -- the hand-written kernel ``csrc/vq_argmin.cu``
    (replaces the Pallas ``_vq_kernel``): distances never reach device memory.
    One launch; it reads the token matrix in the caller's dtype (float32 or
    bf16) and strides and the raw float32 codebook, and allocates only the
    output.
  * :func:`nearest_code` -- dispatch by where the tensor lies: a CUDA tensor
    launches the kernel (or raises), a CPU tensor takes the plain version.

Both return int32 indices ``[N]``; ties go to the lowest index. Both use the
same expression, ``|e|^2 - 2 z.e`` with the per-token ``|z|^2`` dropped (it
does not move the argmin). The kernel computes ``|e|^2`` itself; it sums
``|e|^2`` and ``[z, 1] . [-2e, |e|^2]`` in the order the plain version's torch
ops take on the card, so near-ties round alike.

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
        ll, i = ctypes.c_longlong, ctypes.c_int
        lib.vq_argmin.argtypes = [ctypes.c_void_p, i, ll, ll, ctypes.c_void_p, ll, ll,
                                  ctypes.c_void_p, i, i, i, ctypes.c_void_p]
        lib.vq_argmin.restype = ctypes.c_int
        lib.vq_argmin_layout.argtypes = [i, i, ctypes.c_void_p]
        lib.vq_argmin_layout.restype = None
        _lib = lib
    return _lib


def layout(k: int, d: int) -> dict:
    """The compiled kernel's layout for K codes of width D (needs the GPU
    build): its ``slices`` warps walk the codebook slices ``[s * p, (s + 1) *
    p)``, p = ``codes_per_slice``, for the same ``tokens_per_cta`` tokens and
    merge them."""
    out = (ctypes.c_int * 6)()
    _kernel().vq_argmin_layout(k, d, out)
    return dict(zip(("slices", "codes_per_slice", "codes_per_chunk", "tokens_per_cta",
                     "threads", "smem_bytes"), list(out)))


def nearest_code_cuda(z_flat: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """z_flat [N, D] (float32 or bf16), codebook [K, D] (float32), any strides,
    on one GPU -> int32 [N]. One kernel launch, no copy of either input."""
    global launches
    if z_flat.dim() != 2 or codebook.dim() != 2 or z_flat.shape[1] != codebook.shape[1]:
        raise ValueError(f"expected z [N, D] and codebook [K, D], got "
                         f"{tuple(z_flat.shape)} and {tuple(codebook.shape)}")
    if codebook.shape[0] < 1 or z_flat.shape[1] < 1:
        raise ValueError(f"empty codebook or code width: {tuple(codebook.shape)}")
    if max(z_flat.shape[0], codebook.shape[0]) >= 2 ** 31:
        raise ValueError(f"more than 2^31 - 1 tokens or codes: {tuple(z_flat.shape)}, "
                         f"{tuple(codebook.shape)}")
    if z_flat.dtype not in (torch.float32, torch.bfloat16) or codebook.dtype != torch.float32:
        raise ValueError(f"nearest_code_cuda takes float32 or bfloat16 tokens and a float32 "
                         f"codebook, got {z_flat.dtype} and {codebook.dtype}")
    if not (z_flat.is_cuda and codebook.is_cuda) or z_flat.device != codebook.device:
        raise ValueError("nearest_code_cuda needs CUDA tensors on one device")
    n, d = z_flat.shape
    idx = torch.empty(n, dtype=torch.int32, device=z_flat.device)
    if n == 0:
        return idx
    with torch.cuda.device(z_flat.device):
        err = _kernel().vq_argmin(
            z_flat.data_ptr(), int(z_flat.dtype == torch.bfloat16), *z_flat.stride(),
            codebook.data_ptr(), *codebook.stride(),
            idx.data_ptr(), n, d, codebook.shape[0], torch.cuda.current_stream().cuda_stream)
    _build.check(err, "vq_argmin")
    launches += 1
    return idx


def nearest_code(z_flat: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Kernel for a CUDA tensor, plain version for a CPU tensor."""
    # No autograd rule here, in either package: the result is integer indices,
    # through which no gradient flows; the straight-through estimator is
    # modules/quantize.py's business.
    if _build.on_card(z_flat):
        return nearest_code_cuda(z_flat, codebook)
    return nearest_code_ref(z_flat, codebook)
