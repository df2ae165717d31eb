"""Modulated deformable convolution (DCNv2) forward, 3x3 / stride 1 / pad 1.

Counterpart of ``glare_tpu/ops/dcn.py`` (exact op) and
``glare_tpu/ops/dcn_pallas.py`` (clamped-offset kernel). Layouts as there:

  x      [B, H, W, C]
  offset [B, H, W, G, K, 2]   (dy, dx) per deformable group g, tap k (K = 9)
  mask   [B, H, W, G, K]      (already sigmoid-ed by the caller)
  weight [3, 3, C, O]         (HWIO)
  out    [B, H, W, O]

``max_offset``: ``None`` (no clamp: the exact op), an int R (offsets clamped to
+-R) or a ``[G][K]`` nested tuple of per-tap radii. Border semantics are those
of the reference CUDA extension: a sample whose position falls outside
(-1, H) x (-1, W) contributes zero; each bilinear corner outside the image is
zero. The contraction uses the weight flattened as ``[K, G, Cg, O] -> [9*C, O]``
(row ``k*C + g*Cg + cg``) in both the kernel and the plain version.

  * :func:`modulated_deform_conv_ref` -- plain PyTorch by gathers.
  * :func:`modulated_deform_conv_cuda` -- the hand-written kernel
    ``csrc/dcn_fwd.cu`` (replaces the Pallas ``_kernel_core``): gather +
    modulation + the ``[9*C -> O]`` contraction in one kernel.
  * :func:`modulated_deform_conv` -- dispatch by where the tensors lie: CUDA
    tensors launch the kernel (or raise), CPU tensors take the plain version.

Numerics shared by both: sampling in float32, the sampled column rounded once
to x's dtype, products accumulated in float32, bias added in float32, result
cast to x's dtype.

What bounds the kernel on an H100: the contraction, ``2*B*H*W*9*C*O`` FLOP,
about level with the bytes of x, offset, mask and out; design notes are in
the CUDA source.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build

launches = 0  # +1 per kernel launch, nowhere else

_KY = (-1, -1, -1, 0, 0, 0, 1, 1, 1)
_KX = (-1, 0, 1, -1, 0, 1, -1, 0, 1)


def clamp_table(max_offset, G: int, K: int = 9) -> torch.Tensor:
    """``max_offset`` (None | int | [G][K]) -> float32 [G, K] radii, inf = no clamp."""
    if max_offset is None:
        return torch.full((G, K), math.inf, dtype=torch.float32)
    if isinstance(max_offset, (tuple, list)):
        t = torch.tensor([[float(r) for r in row] for row in max_offset], dtype=torch.float32)
        if t.shape != (G, K):
            raise ValueError(f"per-tap max_offset must be [{G}][{K}], got {tuple(t.shape)}")
        return t
    return torch.full((G, K), float(max_offset), dtype=torch.float32)


def _check(x, offset, mask, weight):
    if x.dim() != 4:
        raise ValueError(f"x must be [B, H, W, C], got {tuple(x.shape)}")
    B, H, W, C = x.shape
    if weight.dim() != 4 or tuple(weight.shape[:3]) != (3, 3, C):
        raise ValueError(f"weight must be [3, 3, {C}, O], got {tuple(weight.shape)}")
    if offset.dim() != 6 or tuple(offset.shape[:3]) != (B, H, W) or tuple(offset.shape[4:]) != (9, 2):
        raise ValueError(f"offset must be [B, H, W, G, 9, 2], got {tuple(offset.shape)}")
    G = offset.shape[3]
    if tuple(mask.shape) != (B, H, W, G, 9):
        raise ValueError(f"mask must be {(B, H, W, G, 9)}, got {tuple(mask.shape)}")
    if C % G != 0:
        raise ValueError(f"C={C} not divisible by G={G}")
    return B, H, W, C, weight.shape[3], G


def modulated_deform_conv_ref(x, offset, mask, weight, bias=None, max_offset=None,
                              rows_per_chunk=None):
    """Plain PyTorch DCNv2 forward; see module docstring. Output rows are
    processed in chunks to bound the gathered ``[rows, W, G, K, Cg]`` buffers."""
    B, H, W, C, O, G = _check(x, offset, mask, weight)
    K, Cg = 9, C // G
    dev = x.device
    r = clamp_table(max_offset, G, K).to(dev)[None, None, None, :, :, None]
    off = torch.minimum(torch.maximum(offset.float(), -r), r)
    ky = torch.tensor(_KY, dtype=torch.float32, device=dev)
    kx = torch.tensor(_KX, dtype=torch.float32, device=dev)
    xg = x.reshape(B, H * W, G, Cg).permute(0, 2, 1, 3)          # [B, G, HW, Cg]
    w2 = weight.reshape(K * C, O).to(x.dtype).float()
    if rows_per_chunk is None:
        rows_per_chunk = max(1, (1 << 24) // max(1, B * W * K * C))
    ww = torch.arange(W, dtype=torch.float32, device=dev).view(1, 1, W, 1, 1)
    outs = []
    for h0 in range(0, H, rows_per_chunk):
        h1 = min(H, h0 + rows_per_chunk)
        R = h1 - h0
        hh = torch.arange(h0, h1, dtype=torch.float32, device=dev).view(1, R, 1, 1, 1)
        py = hh + ky + off[:, h0:h1, ..., 0]                       # [B, R, W, G, K]
        px = ww + kx + off[:, h0:h1, ..., 1]
        in_range = (py > -1.0) & (py < H) & (px > -1.0) & (px < W)
        y0 = torch.floor(py)
        x0 = torch.floor(px)
        ly, lx = py - y0, px - x0
        hy, hx = 1.0 - ly, 1.0 - lx

        def corner(yi, xi, wgt):
            valid = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W) & in_range
            lin = (yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)).long()
            idx = lin.permute(0, 3, 1, 2, 4).reshape(B, G, R * W * K, 1)
            vals = torch.gather(xg, 2, idx.expand(B, G, R * W * K, Cg)).float()
            wv = (wgt * valid.to(wgt.dtype)).permute(0, 3, 1, 2, 4).reshape(B, G, R * W * K, 1)
            return vals * wv

        samp = corner(y0, x0, hy * hx)
        samp = samp + corner(y0, x0 + 1, hy * lx)
        samp = samp + corner(y0 + 1, x0, ly * hx)
        samp = samp + corner(y0 + 1, x0 + 1, ly * lx)
        m = mask[:, h0:h1].float().permute(0, 3, 1, 2, 4).reshape(B, G, R * W * K, 1)
        samp = samp * m                                            # [B, G, R*W*K, Cg]
        col = samp.reshape(B, G, R * W, K, Cg).permute(0, 2, 3, 1, 4).reshape(B * R * W, K * C)
        o = col.to(x.dtype).float() @ w2
        if bias is not None:
            o = o + bias.float()
        outs.append(o.reshape(B, R, W, O))
    return torch.cat(outs, dim=1).to(x.dtype)


_lib = None


def _kernel():
    global _lib
    if _lib is None:
        lib = _build.load("dcn_fwd")
        lib.dcn_fwd.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        lib.dcn_fwd.restype = ctypes.c_int
        _lib = lib
    return _lib


def modulated_deform_conv_cuda(x, offset, mask, weight, bias=None, max_offset=None):
    global launches
    if not (x.is_cuda and offset.is_cuda and mask.is_cuda and weight.is_cuda):
        raise ValueError("modulated_deform_conv_cuda needs CUDA tensors")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"x must be bfloat16 or float32, got {x.dtype}")
    B, H, W, C, O, G = _check(x, offset, mask, weight)
    if O > 256:
        raise ValueError(f"O={O} not supported by the kernel (at most 256)")
    if x.dtype == torch.bfloat16 and (C % 16 != 0 or O % 16 != 0):
        raise ValueError(f"bfloat16 needs C and O to be multiples of 16, got C={C}, O={O}")
    x = x.contiguous()
    offset = offset.float().contiguous()
    mask = mask.float().contiguous()
    w2 = weight.reshape(9 * C, O).to(x.dtype).contiguous()
    if w2.data_ptr() % 32 != 0:  # wmma reads the weight in place: 32-byte aligned
        w2 = w2.clone()
    b = None if bias is None else bias.float().contiguous()
    radii = clamp_table(max_offset, G).to(x.device).contiguous()
    out = torch.empty((B, H, W, O), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = _kernel().dcn_fwd(
            x.data_ptr(), offset.data_ptr(), mask.data_ptr(), w2.data_ptr(),
            None if b is None else b.data_ptr(), radii.data_ptr(), out.data_ptr(),
            B, H, W, C, O, G, int(x.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "dcn_fwd")
    launches += 1
    return out


def modulated_deform_conv(x, offset, mask, weight, bias=None, max_offset=None):
    """DCNv2 forward: the kernel for CUDA tensors, the plain version on the CPU."""
    if x.is_cuda:
        return modulated_deform_conv_cuda(x, offset, mask, weight, bias, max_offset)
    return modulated_deform_conv_ref(x, offset, mask, weight, bias, max_offset)
