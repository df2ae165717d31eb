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

The cascade (counterpart of ``modulated_deform_conv_pallas_cascade``; used by
``dcn_impl: hybrid``): a base result with every offset clamped to +-R, and the
row blocks that hold a tap beyond R -- the first ``n_sel`` of them in flat
``(image, block)`` order -- recomputed whole at the wide clamp +-R_tail. Exact
DCNv2 while no tap exceeds R_tail and the out-of-band blocks fit the slots; the
two counters ``[blocks that did not fit, taps beyond R_tail]`` say when not.

  * :func:`cascade_selection` -- which blocks are selected, and the counters:
    plain torch ops on the device, no host sync.
  * :func:`modulated_deform_conv_cascade_ref` -- plain version: two calls of the
    plain op (clamp R, clamp R_tail) joined by ``torch.where`` on the selection.
  * :func:`modulated_deform_conv_cascade_cuda` -- entry ``dcn_cascade_fwd`` of
    ``csrc/dcn_fwd.cu``: ONE pass that clamps each pixel's taps at its image
    row's radius (R_tail on rows of selected blocks, R elsewhere). On the TPU
    the tail is a second, compacted launch because a pass costs (2R+1)^2 there;
    a gather costs the same at any radius, so one pass does the same function
    for the work of a plain one.
  * :func:`modulated_deform_conv_cascade` -- dispatch as above.

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

launches = 0          # +1 per launch of dcn_fwd, nowhere else
cascade_launches = 0  # +1 per launch of dcn_cascade_fwd, nowhere else

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
        lib.dcn_cascade_fwd.argtypes = lib.dcn_fwd.argtypes
        lib.dcn_cascade_fwd.restype = ctypes.c_int
        _lib = lib
    return _lib


def _launch(entry, x, offset, mask, weight, bias, radii):
    """Check, make contiguous, allocate the output and call one C entry of
    ``dcn_fwd.cu``; ``radii`` is that entry's float32 clamp table on the device."""
    if not (x.is_cuda and offset.is_cuda and mask.is_cuda and weight.is_cuda):
        raise ValueError(f"{entry} needs CUDA tensors")
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
    out = torch.empty((B, H, W, O), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = getattr(_kernel(), entry)(
            x.data_ptr(), offset.data_ptr(), mask.data_ptr(), w2.data_ptr(),
            None if b is None else b.data_ptr(), radii.data_ptr(), out.data_ptr(),
            B, H, W, C, O, G, int(x.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, entry)
    return out


def modulated_deform_conv_cuda(x, offset, mask, weight, bias=None, max_offset=None):
    global launches
    radii = clamp_table(max_offset, offset.shape[3]).to(x.device).contiguous()
    out = _launch("dcn_fwd", x, offset, mask, weight, bias, radii)
    launches += 1
    return out


def modulated_deform_conv(x, offset, mask, weight, bias=None, max_offset=None):
    """DCNv2 forward: the kernel for CUDA tensors, the plain version on the CPU."""
    if x.is_cuda:
        return modulated_deform_conv_cuda(x, offset, mask, weight, bias, max_offset)
    return modulated_deform_conv_ref(x, offset, mask, weight, bias, max_offset)


# ------------------------------------------------------------- the cascade --

def cascade_rows_per_block(tail_offset: int, rows_per_step: int = 16) -> int:
    """Rows of one cascade block: ``rows_per_step``, at most 8 from R_tail 6 on
    (the JAX package's ``_clamp_rpb``; it decides which blocks are selected)."""
    return min(int(rows_per_step), 8) if int(tail_offset) >= 6 else int(rows_per_step)


def cascade_slots(B: int, H: int, rows_per_block: int, capacity_frac: float):
    """-> (blocks per image, n_sel). The TPU kernel appends one spare block to
    every image and sizes its slots from that count; the port has no such block
    but counts as if it had, or the selection would differ."""
    n_rblk = -(-H // rows_per_block) + 1
    n_blocks = B * n_rblk
    n_sel = max(1, min(n_blocks, -(-int(n_blocks * capacity_frac) // 8) * 8))
    return n_rblk, n_sel


def cascade_selection(offset, max_offset=2, tail_offset=8, capacity_frac=0.125,
                      rows_per_step=16):
    """-> (row_selected bool [B, H], overflow int64 [2]) for the cascade.

    A block of ``rows_per_block`` image rows is out of band when any tap in it
    has ``max(|dy|, |dx|) > R``; the first ``n_sel`` such blocks in flat
    ``(image, block)`` order are selected. ``overflow`` is
    ``[out-of-band blocks - selected blocks, taps beyond R_tail]``. Torch ops
    on ``offset``'s device; nothing is read back."""
    R, Rt = int(max_offset), int(tail_offset)
    if Rt <= R:
        raise ValueError(f"tail_offset {Rt} must exceed max_offset {R}")
    B, H = offset.shape[:2]
    rpb = cascade_rows_per_block(Rt, rows_per_step)
    n_rblk, n_sel = cascade_slots(B, H, rpb, capacity_frac)
    linf = offset.float().abs().amax(dim=-1)                          # [B, H, W, G, K]
    oob_row = (linf > R).flatten(2).any(dim=-1)                       # [B, H]
    oob_blk = torch.nn.functional.pad(oob_row, (0, n_rblk * rpb - H)) \
        .reshape(B, n_rblk, rpb).any(dim=2).reshape(-1)               # [B * n_rblk]
    pos = torch.cumsum(oob_blk.to(torch.int64), dim=0) - 1
    selected = oob_blk & (pos < n_sel)
    row_selected = selected.reshape(B, n_rblk, 1).expand(B, n_rblk, rpb) \
        .reshape(B, n_rblk * rpb)[:, :H]
    overflow = torch.stack([oob_blk.sum() - selected.sum(), (linf > Rt).sum()])
    return row_selected, overflow


def modulated_deform_conv_cascade_ref(x, offset, mask, weight, bias=None, max_offset=2,
                                      tail_offset=8, capacity_frac=0.125, rows_per_step=16,
                                      return_overflow=False):
    """Plain PyTorch cascade: the clamp-R result everywhere, the clamp-R_tail
    result on the rows of the selected blocks."""
    row_sel, overflow = cascade_selection(offset, max_offset, tail_offset, capacity_frac,
                                          rows_per_step)
    base = modulated_deform_conv_ref(x, offset, mask, weight, bias, max_offset=int(max_offset))
    tail = modulated_deform_conv_ref(x, offset, mask, weight, bias, max_offset=int(tail_offset))
    out = torch.where(row_sel[:, :, None, None], tail, base)
    return (out, overflow) if return_overflow else out


def modulated_deform_conv_cascade_cuda(x, offset, mask, weight, bias=None, max_offset=2,
                                       tail_offset=8, capacity_frac=0.125, rows_per_step=16,
                                       return_overflow=False):
    global cascade_launches
    row_sel, overflow = cascade_selection(offset, max_offset, tail_offset, capacity_frac,
                                          rows_per_step)
    row_radius = torch.where(row_sel, float(int(tail_offset)), float(int(max_offset))) \
        .to(torch.float32).contiguous()                               # [B, H]
    out = _launch("dcn_cascade_fwd", x, offset, mask, weight, bias, row_radius)
    cascade_launches += 1
    return (out, overflow) if return_overflow else out


def modulated_deform_conv_cascade(x, offset, mask, weight, bias=None, max_offset=2,
                                  tail_offset=8, capacity_frac=0.125, rows_per_step=16,
                                  return_overflow=False):
    """The DCN cascade: the kernel for CUDA tensors, the plain version on the CPU."""
    fn = modulated_deform_conv_cascade_cuda if x.is_cuda else modulated_deform_conv_cascade_ref
    return fn(x, offset, mask, weight, bias, max_offset, tail_offset, capacity_frac,
              rows_per_step, return_overflow)
