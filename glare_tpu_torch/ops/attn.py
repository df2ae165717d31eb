"""Fused single-head attention, forward only.

Counterpart of ``glare_tpu/ops/attn_pallas.py``. Layout as there: q, k, v are
``[B, N, C]`` (the natural reshape of a channels-last feature map), the result
is ``[B, N, C]`` in q's dtype.

  * :func:`flash_attention_nhc_ref` -- plain PyTorch: a key-tiled online
    softmax in float32 with the kernel's cast points (scale*log2(e) folded
    into q in f32 then cast back, exp2, probabilities cast to v's dtype before
    the PV product, keys >= ``n_true`` masked to -1e30).
  * :func:`flash_attention_nhc_cuda` -- the hand-written kernel
    ``csrc/attn_fused.cu`` (replaces the Pallas ``_kernel`` / ``_kernel_pipe``).
  * :func:`flash_attention_nhc` -- dispatch by where the tensors lie: CUDA
    tensors launch the kernel (or raise), CPU tensors take the plain version.

What bounds the kernel on an H100: tensor-core operations, ``4*B*N*N*C`` FLOP;
the design notes are in the CUDA source.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build

launches = 0  # +1 per kernel launch, nowhere else

_NEG_INF = -1e30
_LOG2E = 1.4426950408889634


def _scale_q(q: torch.Tensor) -> torch.Tensor:
    scale = float(q.shape[-1]) ** -0.5 * _LOG2E
    return (q.float() * scale).to(q.dtype)


def flash_attention_nhc_ref(q, k, v, n_true: Optional[int] = None, bk: int = 1024):
    """Plain PyTorch online softmax; see module docstring."""
    b, n, c = q.shape
    n_true = n if n_true is None else int(n_true)
    qs = _scale_q(q).float()
    m = torch.full((b, n, 1), _NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, n, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, n, c), dtype=torch.float32, device=q.device)
    for j0 in range(0, n_true, bk):
        j1 = min(j0 + bk, n)
        s = qs @ k[:, j0:j1].float().transpose(1, 2)
        if j1 > n_true:
            dead = torch.arange(j0, j1, device=q.device) >= n_true
            s = s.masked_fill(dead[None, None, :], _NEG_INF)
        m_new = torch.maximum(m, s.max(dim=-1, keepdim=True).values)
        corr = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + p.to(v.dtype).float() @ v[:, j0:j1].float()
        m = m_new
    return (acc / l).to(q.dtype)


_lib = None


def _kernel():
    global _lib
    if _lib is None:
        lib = _build.load("attn_fused")
        for fn in (lib.attn_fused_bf16, lib.attn_fused_f32):
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def flash_attention_nhc_cuda(q, k, v, n_true: Optional[int] = None):
    global launches
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("flash_attention_nhc_cuda needs CUDA tensors")
    if q.dim() != 3 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q, k, v must share one [B, N, C] shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"q, k, v must all be bfloat16 or all float32, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    b, n, c = q.shape
    n_true = n if n_true is None else int(n_true)
    if not 1 <= n_true <= n:
        raise ValueError(f"n_true={n_true} outside [1, {n}]")
    if c > 512 or (q.dtype == torch.bfloat16 and c % 16 != 0):
        raise ValueError(f"head dimension {c} not supported by the kernel "
                         "(at most 512; a multiple of 16 for bfloat16)")
    qs = _scale_q(q).contiguous()
    k = k.contiguous()
    v = v.contiguous()
    out = torch.empty_like(qs)
    lib = _kernel()
    fn = lib.attn_fused_bf16 if q.dtype == torch.bfloat16 else lib.attn_fused_f32
    with torch.cuda.device(q.device):
        err = fn(qs.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, n, n_true, c,
                 torch.cuda.current_stream().cuda_stream)
    _build.check(err, fn.__name__)
    launches += 1
    return out


def flash_attention_nhc(q, k, v, *, n_true: Optional[int] = None, pipeline: bool = False):
    """softmax(q k^T / sqrt(C)) v for ``[B, N, C]`` single-head inputs.

    ``n_true``: callers that carry padded tokens pass the real token count;
    keys/values beyond it are masked, padded query rows compute garbage and
    stay in the output for the caller to slice. ``pipeline`` is accepted for
    parity with the JAX entry (there it picks a software-pipelined schedule
    of the same function); the one CUDA kernel serves both.
    """
    del pipeline
    if q.is_cuda:
        return flash_attention_nhc_cuda(q, k, v, n_true=n_true)
    return flash_attention_nhc_ref(q, k, v, n_true=n_true)
