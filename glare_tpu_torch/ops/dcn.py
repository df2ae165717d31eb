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
  * :func:`modulated_deform_conv_naive` -- the float64 loop oracle of the tests
    (no clamp, small inputs only): the reference CUDA kernel's arithmetic
    written out per output element.
  * :func:`modulated_deform_conv_cuda` -- the hand-written kernels that replace
    the Pallas ``_kernel_core``, one of four entries chosen by :func:`route`
    from dtype and widths before the launch: ``hopper`` (``csrc/dcn_hopper.cu``:
    2-D tiles, a TMA-staged halo, ``wgmma``, warp-specialised; bf16 inside
    :func:`hopper_envelope`, every launch of the model's serving paths),
    ``f32`` (``csrc/dcn_fwd.cu``'s tiled float32 kernel: 8 x 16 pixel tiles,
    register micro-tiles, cp.async weight stages; float32 inside
    :func:`f32_envelope`, the float32 training path's forward), and the first
    kernel's two entries in ``csrc/dcn_fwd.cu`` for the widths outside those
    envelopes: ``wmma`` (bf16) and ``f32_flat`` (float32). Each is gather +
    modulation + the ``[9*C -> O]`` contraction in one kernel; the ``hopper``
    entry also counts the taps beyond their clamp radius (the ``pallas``
    overflow counter).
  * :func:`modulated_deform_conv` -- dispatch by where the tensors lie: CUDA
    tensors launch a kernel (or raise), CPU tensors take the plain version.
    With grad enabled and an input that requires grad, a CUDA call goes
    through :class:`ModulatedDeformConvFunction` (float32 or bf16 x).

The backward (no Pallas counterpart: JAX takes it from XLA autodiff of its
``modulated_deform_conv_chain`` / ``modulated_deform_conv``):

  * :func:`modulated_deform_conv_backward_ref` -- plain version: autograd of
    :func:`modulated_deform_conv_ref`. It is the reference CUDA extension's
    derivative (``col2im_coord``, floor-based at integer offsets), which the
    chain op's autodiff is not at exactly integer offsets.
  * :func:`modulated_deform_conv_backward_cuda` -- per chunk of images
    grad_col = grad_out W^T, ONE launch of the gather pass of
    ``csrc/dcn_bwd.cu`` (``dcn_bwd_pass``: the masked column, grad_offset,
    grad_mask and, when x needs it, grad_x by an atomic scatter, from one
    geometry and one gather per (pixel, group, tap)), then grad_weight +=
    col^T grad_out. grad_bias = sum grad_out. In x's type: float32 (products
    in full float32), or bf16 (``dcn_bwd_pass_bf16``: the column rounded as
    the Hopper forward rounds its A block, grad_col bf16, the products on the
    tensor cores with float32 accumulation, grad_weight and every other
    gradient accumulated in float32).
  * :func:`dcn_backward_pass_ref` -- the pass's plain version: the column of
    :func:`modulated_deform_conv_ref` and autograd of ``sum(col * grad_col)``.
  * :class:`ModulatedDeformConvFunction` -- the forward kernel :func:`route`
    picks (``f32`` for float32, ``hopper`` for bf16 at the training widths)
    with that backward; the training path's DCN on the card.

The cascade (counterpart of ``modulated_deform_conv_pallas_cascade``; used by
``dcn_impl: hybrid``): a base result with every offset clamped to +-R, and the
row blocks that hold a tap beyond R -- the first ``n_sel`` of them in flat
``(image, block)`` order -- recomputed whole at the wide clamp +-R_tail. Exact
DCNv2 while no tap exceeds R_tail and the out-of-band blocks fit the slots; the
two counters ``[blocks that did not fit, taps beyond R_tail]`` say when not.

  * :func:`cascade_selection` -- which blocks are selected, and the counters:
    plain torch ops; :func:`cascade_row_radius` turns it into the per-row
    radius table. Their kernel is :func:`cascade_select_cuda` (entry
    ``dcn_cascade_select`` of ``csrc/dcn_hopper.cu``: one pass over ``offset``,
    the last CTA scans the blocks).
  * :func:`modulated_deform_conv_cascade_ref` -- plain version: two calls of the
    plain op (clamp R, clamp R_tail) joined by ``torch.where`` on the selection.
  * :func:`modulated_deform_conv_cascade_cuda` -- the selection kernel, then ONE
    pass of the entry :func:`route` picks, each pixel's taps clamped at its
    image row's radius (R_tail on rows of selected blocks, R elsewhere). On the
    TPU the tail is a second, compacted launch because a pass costs (2R+1)^2
    there; a gather costs the same at any radius, so one pass does the same
    function for the work of a plain one.
  * :func:`modulated_deform_conv_cascade` -- dispatch as above.

The gather hybrid (counterpart of ``glare_tpu/ops/dcn.py``'s
``modulated_deform_conv_hybrid``; used by ``dcn_impl: hybrid_gather``): exact
DCNv2 for unbounded offsets. A pixel is out of band when any of its G*K taps
has |dy| > R or |dx| > R; the first S of them in flat ``(b, h, w)`` order
(:func:`hybrid_selection`, S from :func:`hybrid_slots`) are computed exactly
and written over a clamp-R base pass that ran with their mask zeroed and no
bias; the bias is added last. Out-of-band pixels past the S slots keep their
clamp-R value (the JAX op's behaviour), and no counter says so.

  * :func:`modulated_deform_conv_hybrid_ref` -- plain version: the base pass by
    :func:`modulated_deform_conv_ref`.
  * :func:`modulated_deform_conv_hybrid` -- the same on the card with the base
    pass by :func:`modulated_deform_conv_cuda` (the entry :func:`route` picks:
    ``hopper`` at the serving widths); the exact tail
    (:func:`hybrid_gather_tail`) is torch gathers and one float32 product per
    chunk of slots, as the JAX op leaves it to XLA gathers.

Numerics shared by all: sampling in float32, the sampled column rounded once
to x's dtype, products accumulated in float32, bias added in float32, result
cast to x's dtype (the gather hybrid adds its bias after that cast, in x's
dtype, as the JAX op does).

What bounds the kernels on an H100: the contraction, ``2*B*H*W*9*C*O`` FLOP,
more than the bytes of x, offset, mask and out; design notes are in the CUDA
sources.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build

ENTRIES = ("hopper", "wmma", "f32", "f32_flat")
launches = 0          # +1 per launch of a DCN entry (any of the four), nowhere else
cascade_launches = 0  # +1 per launch of a cascade entry (any of the four), nowhere else
launches_by_entry = dict.fromkeys(ENTRIES, 0)          # +1 per launch of that entry
cascade_launches_by_entry = dict.fromkeys(ENTRIES, 0)  # the same, cascade entries
select_launches = 0   # +1 per launch of dcn_cascade_select, nowhere else
bwd_launches = 0      # +1 per launch of the gather pass (once per chunk of a backward), nowhere else
# +1 per launch of that instantiation of the pass: float32 / bf16, without / with grad_x
bwd_launches_by_entry = {"pass": 0, "pass_x": 0, "pass_bf16": 0, "pass_x_bf16": 0}

BWD_CHUNK_BYTES = 1 << 30  # the backward's column (in x's type): at most ~1 GB per chunk of images

HOPPER_O = (128, 256)  # the output widths the Hopper entry serves
_CB = 64               # its K chunk: 64 channels of one tap
F32_O = (64, 128, 256)  # the output widths the tiled float32 entry serves

_KY = (-1, -1, -1, 0, 0, 0, 1, 1, 1)
_KX = (-1, 0, 1, -1, 0, 1, -1, 0, 1)


def clamp_table(max_offset, G: int, K: int = 9) -> torch.Tensor:
    """``max_offset`` (None | int | [G][K] | a [G, K] tensor) -> float32 [G, K]
    radii, inf = no clamp. A tensor is returned as it is, on its device."""
    if isinstance(max_offset, torch.Tensor):
        if tuple(max_offset.shape) != (G, K):
            raise ValueError(f"clamp table must be [{G}, {K}], got {tuple(max_offset.shape)}")
        return max_offset
    if max_offset is None:
        return torch.full((G, K), math.inf, dtype=torch.float32)
    if isinstance(max_offset, (tuple, list)):
        t = torch.tensor([[float(r) for r in row] for row in max_offset], dtype=torch.float32)
        if t.shape != (G, K):
            raise ValueError(f"per-tap max_offset must be [{G}][{K}], got {tuple(t.shape)}")
        return t
    return torch.full((G, K), float(max_offset), dtype=torch.float32)


def clamp_overflow(offset, max_offset) -> torch.Tensor:
    """int64 ``[0, taps with max(|dy|, |dx|) above their radius]`` (the ``pallas``
    counter; plain version of the count the Hopper entry keeps)."""
    r = clamp_table(max_offset, offset.shape[3]).to(offset.device)
    beyond = (offset.float().abs().amax(dim=-1) > r).sum()
    return torch.stack([torch.zeros_like(beyond), beyond])


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


def _rows_per_chunk(B, W, C):
    """Image rows whose gathered ``[rows, W, G, 9, Cg]`` buffers stay near 2^24 values."""
    return max(1, (1 << 24) // max(1, B * W * 9 * C))


def _columns(x, offset, mask, max_offset, h0, h1):
    """The masked column of image rows ``[h0, h1)``: float32 ``[B * (h1 - h0) * W,
    9 * C]``, row ``(b, h, w)``, column ``k*C + g*Cg + cg`` (before any rounding to
    x's dtype). Differentiable in x, offset and mask."""
    B, H, W, C = x.shape
    G = offset.shape[3]
    K, Cg, R = 9, C // G, h1 - h0
    dev = x.device
    r = clamp_table(max_offset, G, K).to(dev)[None, None, None, :, :, None]
    off = torch.minimum(torch.maximum(offset[:, h0:h1].float(), -r), r)
    ky = torch.tensor(_KY, dtype=torch.float32, device=dev)
    kx = torch.tensor(_KX, dtype=torch.float32, device=dev)
    xg = x.reshape(B, H * W, G, Cg).permute(0, 2, 1, 3)          # [B, G, HW, Cg]
    ww = torch.arange(W, dtype=torch.float32, device=dev).view(1, 1, W, 1, 1)
    hh = torch.arange(h0, h1, dtype=torch.float32, device=dev).view(1, R, 1, 1, 1)
    py = hh + ky + off[..., 0]                                    # [B, R, W, G, K]
    px = ww + kx + off[..., 1]
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
    samp = samp * m                                               # [B, G, R*W*K, Cg]
    return samp.reshape(B, G, R * W, K, Cg).permute(0, 2, 3, 1, 4).reshape(B * R * W, K * C)


def modulated_deform_conv_ref(x, offset, mask, weight, bias=None, max_offset=None,
                              return_overflow=False, rows_per_chunk=None):
    """Plain PyTorch DCNv2 forward; see module docstring. Output rows are
    processed in chunks to bound the gathered ``[rows, W, G, K, Cg]`` buffers.
    ``return_overflow``: also :func:`clamp_overflow`."""
    B, H, W, C, O, G = _check(x, offset, mask, weight)
    w2 = weight.reshape(9 * C, O).to(x.dtype).float()
    if rows_per_chunk is None:
        rows_per_chunk = _rows_per_chunk(B, W, C)
    outs = []
    for h0 in range(0, H, rows_per_chunk):
        h1 = min(H, h0 + rows_per_chunk)
        o = _columns(x, offset, mask, max_offset, h0, h1).to(x.dtype).float() @ w2
        if bias is not None:
            o = o + bias.float()
        outs.append(o.reshape(B, h1 - h0, W, O))
    out = torch.cat(outs, dim=1).to(x.dtype)
    return (out, clamp_overflow(offset, max_offset)) if return_overflow else out


def modulated_deform_conv_naive(x, offset, mask, weight, bias=None, padding=1):
    """Exact DCNv2 by direct per-pixel loops in float64 (numpy), for tests at a few
    pixels and channels: layouts as the module's, any ``kh x kw`` weight, stride 1,
    no clamp. Takes numpy arrays or CPU tensors -> float64 tensor ``[B, H, W, O]``."""
    import numpy as np

    x, offset, mask, weight = (np.asarray(a, np.float64) for a in (x, offset, mask, weight))
    B, H, W, C = x.shape
    kh, kw, _, O = weight.shape
    G = offset.shape[3]
    Cg = C // G
    out = np.zeros((B, H, W, O))

    def sample(b, py, px, c):
        if py <= -1 or py >= H or px <= -1 or px >= W:
            return 0.0
        y0, x0 = int(np.floor(py)), int(np.floor(px))
        v = 0.0
        for dy in (0, 1):
            for dx in (0, 1):
                yy, xx = y0 + dy, x0 + dx
                if 0 <= yy < H and 0 <= xx < W:
                    v += (1 - abs(py - yy)) * (1 - abs(px - xx)) * x[b, yy, xx, c]
        return v

    for b in range(B):
        for h in range(H):
            for w in range(W):
                for o in range(O):
                    acc = 0.0
                    for i in range(kh):
                        for j in range(kw):
                            k = i * kw + j
                            for c in range(C):
                                g = c // Cg
                                py = h - padding + i + offset[b, h, w, g, k, 0]
                                px = w - padding + j + offset[b, h, w, g, k, 1]
                                acc += sample(b, py, px, c) * mask[b, h, w, g, k] * weight[i, j, c, o]
                    out[b, h, w, o] = acc
    if bias is not None:
        out = out + np.asarray(bias, np.float64)
    return torch.from_numpy(out)


def hopper_envelope(dtype, C: int, O: int, G: int) -> bool:
    """Whether the Hopper entry takes these widths (the envelope stated in
    ``csrc/dcn_hopper.cu``; 16-byte alignment is the wrapper's business)."""
    return dtype == torch.bfloat16 and G >= 1 and C % G == 0 and C % _CB == 0 \
        and (C // G) % 32 == 0 and O in HOPPER_O


def f32_envelope(dtype, C: int, O: int, G: int) -> bool:
    """Whether the tiled float32 entry takes these widths (the envelope stated in
    ``csrc/dcn_fwd.cu``: 16-channel K chunks, 8 channels of one group a sampling
    thread, O / 64 column quads a thread; 16-byte alignment is the wrapper's)."""
    return dtype == torch.float32 and G >= 1 and C % G == 0 and C % 16 == 0 \
        and (C // G) % 8 == 0 and O in F32_O


def route(x, offset, weight) -> str:
    """The kernel entry a CUDA call with these inputs takes, by dtype and widths
    alone (never by a failure): float32 inside :func:`f32_envelope` -> ``f32``,
    other float32 widths -> ``f32_flat``; bf16 inside :func:`hopper_envelope`
    -> ``hopper``, other bf16 widths -> ``wmma``. Inside its envelope an entry's
    build or launch failure raises."""
    C, O, G = x.shape[-1], weight.shape[-1], offset.shape[3]
    if x.dtype == torch.float32:
        return "f32" if f32_envelope(x.dtype, C, O, G) else "f32_flat"
    if hopper_envelope(x.dtype, C, O, G):
        return "hopper"
    return "wmma"


_libs = None


def _kernels():
    """-> (library of dcn_fwd.cu, library of dcn_hopper.cu), argtypes set."""
    global _libs
    if _libs is None:
        old, hop = _build.load("dcn_fwd"), _build.load("dcn_hopper")
        for fn in (old.dcn_fwd, old.dcn_cascade_fwd):
            fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        for fn in (hop.dcn_hopper_fwd, hop.dcn_hopper_cascade_fwd):
            fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        hop.dcn_cascade_select.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + \
            [ctypes.c_float] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        hop.dcn_cascade_select.restype = ctypes.c_int
        hop.dcn_hopper_smem_bytes.restype = ctypes.c_int
        old.dcn_f32_smem_bytes.restype = ctypes.c_int
        _libs = (old, hop)
    return _libs


def hopper_smem_bytes(O: int) -> int:
    """Dynamic shared memory a CTA of the Hopper entry asks for at O outputs."""
    return int(_kernels()[1].dcn_hopper_smem_bytes(int(O)))


def f32_smem_bytes(O: int) -> int:
    """Dynamic shared memory a CTA of the tiled float32 entry asks for at O outputs."""
    return int(_kernels()[0].dcn_f32_smem_bytes(int(O)))


def _aligned(t, n):
    return t if t.data_ptr() % n == 0 else t.clone()


def _check_entry(entry, x, offset, mask, weight):
    """Shapes, dtype and the entry's envelope; raises ValueError. -> B, H, W, C, O, G."""
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"x must be bfloat16 or float32, got {x.dtype}")
    B, H, W, C, O, G = _check(x, offset, mask, weight)
    if entry not in ENTRIES or entry.startswith("f32") != (x.dtype == torch.float32):
        raise ValueError(f"entry {entry!r} does not take {x.dtype} inputs")
    if entry == "hopper" and not hopper_envelope(x.dtype, C, O, G):
        raise ValueError(f"the hopper entry does not take C={C}, O={O}, G={G} "
                         f"(bf16, C % 64 == 0, Cg % 32 == 0, O in {HOPPER_O})")
    if entry == "f32" and not f32_envelope(x.dtype, C, O, G):
        raise ValueError(f"the f32 entry does not take C={C}, O={O}, G={G} "
                         f"(float32, C % 16 == 0, Cg % 8 == 0, O in {F32_O})")
    if O > 256:
        raise ValueError(f"O={O} not supported by the kernel (at most 256)")
    if entry == "wmma" and (C % 16 != 0 or O % 16 != 0):
        raise ValueError(f"bfloat16 needs C and O to be multiples of 16, got C={C}, O={O}")
    return B, H, W, C, O, G


_FWD_KIND = {"f32": 0, "wmma": 1, "f32_flat": 2}  # dcn_fwd's `kind` argument per entry


def _launch(entry, cascade, x, offset, mask, weight, bias, radii, count=None):
    """Check, make contiguous, allocate the output and call one C entry;
    ``radii`` is that entry's float32 clamp table on the device ([G*9], or
    [B*H] for the cascade); ``count``: an int64 the Hopper entry adds the
    taps beyond their radius to, or None."""
    B, H, W, C, O, G = _check_entry(entry, x, offset, mask, weight)
    if not (x.is_cuda and offset.is_cuda and mask.is_cuda and weight.is_cuda):
        raise ValueError("the DCN kernels need CUDA tensors")
    x = _aligned(x.contiguous(), 16)      # TMA and 16-byte gathers
    offset = offset.float().contiguous()
    mask = mask.float().contiguous()
    # TMA and cp.async read the weight at 16-byte, wmma at 32-byte alignment
    w2 = _aligned(weight.reshape(9 * C, O).to(x.dtype).contiguous(), 32)
    b = None if bias is None else _aligned(bias.float().contiguous(), 16)
    out = torch.empty((B, H, W, O), dtype=x.dtype, device=x.device)
    old, hop = _kernels()
    ptrs = [x.data_ptr(), offset.data_ptr(), mask.data_ptr(), w2.data_ptr(),
            None if b is None else b.data_ptr(), radii.data_ptr(), out.data_ptr()]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if entry == "hopper":
            fn = hop.dcn_hopper_cascade_fwd if cascade else hop.dcn_hopper_fwd
            err = fn(*ptrs, None if count is None else count.data_ptr(), B, H, W, C, O, G, stream)
        else:
            fn = old.dcn_cascade_fwd if cascade else old.dcn_fwd
            err = fn(*ptrs, B, H, W, C, O, G, _FWD_KIND[entry], stream)
    _build.check(err, fn.__name__)
    return out


def modulated_deform_conv_cuda(x, offset, mask, weight, bias=None, max_offset=None,
                               return_overflow=False, entry=None):
    """Launches the entry :func:`route` picks; ``entry`` names another one that
    takes these inputs (the first kernel, ``wmma`` or ``f32_flat``, to time it
    beside the redesign). ``return_overflow``: the Hopper entry counts in the
    kernel; the others leave it to :func:`clamp_overflow`."""
    global launches
    _build.refuse_grad("modulated_deform_conv_cuda", x, offset, mask, weight, bias)
    entry = route(x, offset, weight) if entry is None else entry
    radii = clamp_table(max_offset, offset.shape[3]).to(x.device, torch.float32).contiguous()
    count = None
    if return_overflow and entry == "hopper":
        overflow = torch.zeros(2, dtype=torch.int64, device=x.device)
        count = overflow[1:]
    out = _launch(entry, False, x, offset, mask, weight, bias, radii, count)
    launches += 1
    launches_by_entry[entry] += 1
    if not return_overflow:
        return out
    return out, (overflow if count is not None else clamp_overflow(offset, radii))


def modulated_deform_conv(x, offset, mask, weight, bias=None, max_offset=None,
                          return_overflow=False):
    """DCNv2 forward: a kernel for CUDA tensors, the plain version on the CPU.
    A CUDA call that autograd must differentiate goes through
    :class:`ModulatedDeformConvFunction`."""
    if not _build.on_card(x):
        return modulated_deform_conv_ref(x, offset, mask, weight, bias, max_offset, return_overflow)
    if not _build.needs_grad(x, offset, mask, weight, bias):
        return modulated_deform_conv_cuda(x, offset, mask, weight, bias, max_offset, return_overflow)
    radii = clamp_table(max_offset, offset.shape[3]).to(x.device, torch.float32).contiguous()
    out, overflow = ModulatedDeformConvFunction.apply(x, offset, mask, weight, bias, radii)
    return (out, overflow) if return_overflow else out


def modulated_deform_conv_chain(x, offset, mask, weight, bias=None, max_offset=2):
    """Clamped-offset DCNv2, the training formulation of the JAX package
    (``glare_tpu/ops/dcn.py:modulated_deform_conv_chain``): offsets clamped to
    one radius, ``[-max_offset, max_offset]``; 3x3, stride 1, dilation 1. It is
    :func:`modulated_deform_conv` with that uniform clamp (on the card the
    kernel, differentiable through the DCN autograd Function; on the CPU the
    plain version), which ``DCNv2Pack``'s ``'chain'`` impl runs.

    Off the integer grid its gradient is the JAX op's. At integer offsets it is
    not: the JAX op differentiates the ``jnp.abs`` / ``jnp.maximum`` of its hat
    functions there, whose slopes do not sum to the DCNv2 derivative (3.54
    against 0 on a constant image with zero offsets); this one gives the DCNv2
    derivative, as the exact op does (ROADMAP.md, reference-side caveats)."""
    return modulated_deform_conv(x, offset, mask, weight, bias, max_offset=int(max_offset))


def deform_conv(x, offset, weight, bias=None, stride=1, padding=1, dilation=1):
    """DCNv1 (no modulation): :func:`modulated_deform_conv`, exact offsets, with a
    mask of ones (``glare_tpu/ops/dcn.py:deform_conv``). The port's op is 3x3 with
    stride 1, padding 1 and dilation 1; the JAX op's other strides, paddings and
    dilations raise here."""
    if (stride, padding, dilation) != (1, 1, 1):
        raise NotImplementedError(
            f"deform_conv: stride={stride}, padding={padding}, dilation={dilation} is not "
            "ported (only 1, 1, 1, the 3x3 'same' convolution every DCN of the model uses)")
    B, H, W = x.shape[:3]
    G, K = offset.shape[3], offset.shape[4]
    mask = torch.ones((B, H, W, G, K), dtype=torch.float32, device=x.device)
    return modulated_deform_conv(x, offset, mask, weight, bias)


# ------------------------------------------------------------- the backward --

def _dcn_grad_dtype(x):
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"the DCN backward kernels take float32 or bfloat16 x, got {x.dtype}")


def modulated_deform_conv_backward_ref(grad_out, x, offset, mask, weight, bias=None,
                                       max_offset=None, need_x=True):
    """Plain version of the backward: autograd of :func:`modulated_deform_conv_ref`.
    -> (grad_x or None, grad_offset, grad_mask, grad_weight [3, 3, C, O], grad_bias [O])."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (x, offset, mask, weight)]
        b = None if bias is None else bias.detach().requires_grad_(True)
        out = modulated_deform_conv_ref(*leaves, b, max_offset=max_offset)
        wrt = leaves + ([b] if b is not None else [])
        grads = torch.autograd.grad(out, wrt, grad_out)
    gb = grads[4] if b is not None else grad_out.float().sum(dim=(0, 1, 2))
    return (grads[0] if need_x else None, grads[1], grads[2], grads[3], gb)


def dcn_backward_pass_ref(x, offset, mask, grad_col, max_offset=None, need_x=False):
    """Plain version of the backward's gather pass: from x, offset, mask, the
    clamp radii and a given ``grad_col`` ``[B*H*W, 9*C]`` (grad_out W^T), ->
    (col ``[B*H*W, 9*C]`` in x's type: the forward's masked column, grad_offset,
    grad_mask (float32), grad_x in x's type or None): the column of
    :func:`modulated_deform_conv_ref` and autograd of ``sum(col * grad_col)``."""
    B, H, W = x.shape[:3]
    with torch.enable_grad():
        xl = x.detach().requires_grad_(need_x)
        leaves = [offset.detach().float().requires_grad_(True), mask.detach().float().requires_grad_(True)]
        rows = _rows_per_chunk(B, W, x.shape[-1])
        col = torch.cat([_columns(xl, *leaves, max_offset, h0, min(H, h0 + rows)).reshape(B, -1, grad_col.shape[1])
                         for h0 in range(0, H, rows)], dim=1).reshape(B * H * W, -1)
        grads = torch.autograd.grad((col * grad_col.float()).sum(), leaves + ([xl] if need_x else []))
    return (col.detach().to(x.dtype), grads[0], grads[1], grads[2] if need_x else None)


_bwd_lib = None


def _bwd_kernels():
    global _bwd_lib
    if _bwd_lib is None:
        lib = _build.load("dcn_bwd")
        for fn in (lib.dcn_bwd_pass, lib.dcn_bwd_pass_bf16):
            fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        _bwd_lib = lib
    return _bwd_lib


def dcn_backward_pass_cuda(x, offset, mask, radii, grad_col, grad_offset, grad_mask, grad_x=None):
    """One launch of the gather pass (``dcn_bwd_pass``, ``dcn_bwd_pass_bf16`` for
    bf16 x): fills ``grad_offset`` and ``grad_mask`` (float32), adds to
    ``grad_x`` (float32) when it is given, and returns the column (x's type,
    like ``grad_col``). Every tensor contiguous on the card; ``radii`` the
    [G, 9] float32 clamp table."""
    global bwd_launches
    B, H, W, C = x.shape
    G = offset.shape[3]
    _dcn_grad_dtype(x)
    outs = [grad_offset, grad_mask] + ([] if grad_x is None else [grad_x])
    if (tuple(grad_col.shape) != (B * H * W, 9 * C) or grad_col.dtype != x.dtype
            or tuple(offset.shape) != (B, H, W, G, 9, 2) or tuple(mask.shape) != (B, H, W, G, 9)
            or tuple(radii.shape) != (G, 9) or C % G != 0
            or (grad_x is not None and tuple(grad_x.shape) != tuple(x.shape))
            or any(t.dtype != torch.float32 for t in [offset, mask, radii] + outs)
            or grad_offset.shape != offset.shape or grad_mask.shape != mask.shape):
        raise ValueError("dcn_backward_pass_cuda: shapes or dtypes the pass does not take")
    ins = [x, offset, mask, radii, grad_col] + outs
    if not all(t.is_cuda and t.is_contiguous() for t in ins):
        raise ValueError("dcn_backward_pass_cuda needs contiguous CUDA tensors")
    bf = x.dtype == torch.bfloat16
    lib = _bwd_kernels()
    fn = lib.dcn_bwd_pass_bf16 if bf else lib.dcn_bwd_pass
    col = torch.empty_like(grad_col)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), offset.data_ptr(), mask.data_ptr(), radii.data_ptr(), grad_col.data_ptr(),
                 col.data_ptr(), grad_offset.data_ptr(), grad_mask.data_ptr(),
                 None if grad_x is None else grad_x.data_ptr(), B, H, W, C, G,
                 torch.cuda.current_stream().cuda_stream)
    _build.check(err, fn.__name__)
    bwd_launches += 1
    bwd_launches_by_entry[("pass_x" if grad_x is not None else "pass") + ("_bf16" if bf else "")] += 1
    return col


def _bf16_mm_f32(a, b):
    """``a @ b`` of bf16 matrices with float32 accumulation and result: one
    tensor-core product on the card; on the CPU, which has no such call, the
    same bf16 products (exact in float32) summed in float32."""
    return torch.mm(a, b, out_dtype=torch.float32) if a.is_cuda else a.float() @ b.float()


def _backward_by_pass(grad_out, x, offset, mask, weight, radii, need_x, gather_pass):
    """The backward's chunk loop around a gather pass with the signature of
    :func:`dcn_backward_pass_cuda`; see :func:`modulated_deform_conv_backward_cuda`.
    ``offset`` and ``mask`` float32 and contiguous."""
    B, H, W, C = x.shape
    O = weight.shape[-1]
    dt = x.dtype
    w2 = weight.reshape(9 * C, O).to(dt).contiguous()
    go = grad_out.to(dt).contiguous().reshape(B * H * W, O)
    grad_offset, grad_mask = torch.empty_like(offset), torch.empty_like(mask)
    grad_x = torch.zeros(x.shape, dtype=torch.float32, device=x.device) if need_x else None
    grad_w2 = torch.zeros((9 * C, O), dtype=torch.float32, device=x.device)
    per = max(1, BWD_CHUNK_BYTES // max(1, H * W * 9 * C * x.element_size()))
    for b0 in range(0, B, per):
        b1 = min(B, b0 + per)
        rows = slice(b0 * H * W, b1 * H * W)
        gcol = go[rows] @ w2.t()
        col = gather_pass(x[b0:b1], offset[b0:b1], mask[b0:b1], radii, gcol, grad_offset[b0:b1],
                          grad_mask[b0:b1], None if grad_x is None else grad_x[b0:b1])
        del gcol
        if dt == torch.float32:
            grad_w2.addmm_(col.t(), go[rows])
        else:
            grad_w2.add_(_bf16_mm_f32(col.t(), go[rows]))
        del col
    return (None if grad_x is None else grad_x.to(dt), grad_offset, grad_mask,
            grad_w2.reshape(3, 3, C, O), go.sum(dim=0, dtype=torch.float32))


def modulated_deform_conv_backward_cuda(grad_out, x, offset, mask, weight, max_offset=None,
                                        need_x=False):
    """The DCN backward in x's type (float32 or bf16), per chunk of images
    whose column is at most ``BWD_CHUNK_BYTES``: grad_col = grad_out W^T, ONE
    launch of the gather pass (:func:`dcn_backward_pass_cuda`: the column,
    grad_offset, grad_mask and, with ``need_x``, grad_x), then grad_weight +=
    col^T grad_out. ``max_offset`` as in the forward (a [G, 9] table on the
    device is taken as it is). float32: the two products in full float32 (the
    package keeps TF32 off). bf16: grad_out and the weight rounded to bf16, the
    products on the tensor cores with float32 accumulation, grad_weight
    returned in float32. -> (grad_x in x's type or None, grad_offset,
    grad_mask, grad_weight [3, 3, C, O], grad_bias [O]; the last four float32)."""
    B, H, W, C, O, G = _check(x, offset, mask, weight)
    _dcn_grad_dtype(x)
    if tuple(grad_out.shape) != (B, H, W, O):
        raise ValueError(f"grad_out must be {(B, H, W, O)}, got {tuple(grad_out.shape)}")
    if not all(t.is_cuda for t in (grad_out, x, offset, mask, weight)):
        raise ValueError("modulated_deform_conv_backward_cuda needs CUDA tensors")
    radii = clamp_table(max_offset, G).to(x.device, torch.float32).contiguous()
    return _backward_by_pass(grad_out, _aligned(x.contiguous(), 16), offset.float().contiguous(),
                             mask.float().contiguous(), weight, radii, need_x, dcn_backward_pass_cuda)


class ModulatedDeformConvFunction(torch.autograd.Function):
    """DCNv2 on the card under autograd: the forward kernel :func:`route` picks
    (the ``f32`` entry of ``csrc/dcn_fwd.cu`` for float32 x, the ``hopper`` entry
    of ``csrc/dcn_hopper.cu`` for bf16 x at its widths) and the backward of
    ``csrc/dcn_bwd.cu`` in x's type. ``radii``: the [G, 9] float32 clamp table
    on the device. -> (out in x's type, overflow int64 [2]: ``[0, taps beyond
    their radius]``, counted by the Hopper entry itself, not differentiable and
    not kept by the Function). grad_x is computed only when x requires grad;
    every gradient leaves in its input's type (float32 master weights get
    float32 gradients)."""

    @staticmethod
    def forward(ctx, x, offset, mask, weight, bias, radii):
        _dcn_grad_dtype(x)
        out, overflow = modulated_deform_conv_cuda(x, offset, mask, weight, bias, max_offset=radii,
                                                   return_overflow=True)
        ctx.save_for_backward(x, offset, mask, weight, radii)
        ctx.has_bias = bias is not None
        ctx.mark_non_differentiable(overflow)
        return out, overflow

    @staticmethod
    def backward(ctx, grad_out, _grad_overflow):
        x, offset, mask, weight, radii = ctx.saved_tensors
        gx, goff, gm, gw, gb = modulated_deform_conv_backward_cuda(
            grad_out, x, offset, mask, weight, max_offset=radii, need_x=ctx.needs_input_grad[0])
        return (gx, goff.to(offset.dtype), gm.to(mask.dtype), gw.to(weight.dtype),
                gb if ctx.has_bias else None, None)


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


def _radii_pair(max_offset, tail_offset):
    R, Rt = int(max_offset), int(tail_offset)
    if Rt <= R:
        raise ValueError(f"tail_offset {Rt} must exceed max_offset {R}")
    return R, Rt


def cascade_selection(offset, max_offset=2, tail_offset=8, capacity_frac=0.125,
                      rows_per_step=16):
    """-> (row_selected bool [B, H], overflow int64 [2]) for the cascade.

    A block of ``rows_per_block`` image rows is out of band when any tap in it
    has ``max(|dy|, |dx|) > R``; the first ``n_sel`` such blocks in flat
    ``(image, block)`` order are selected. ``overflow`` is
    ``[out-of-band blocks - selected blocks, taps beyond R_tail]``. Torch ops
    on ``offset``'s device; nothing is read back."""
    R, Rt = _radii_pair(max_offset, tail_offset)
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


def cascade_row_radius(offset, max_offset=2, tail_offset=8, capacity_frac=0.125,
                       rows_per_step=16):
    """-> (row radius float32 [B, H]: R_tail on the rows of selected blocks, R
    elsewhere; overflow int64 [2]). Plain version of :func:`cascade_select_cuda`."""
    row_sel, overflow = cascade_selection(offset, max_offset, tail_offset, capacity_frac,
                                          rows_per_step)
    R, Rt = _radii_pair(max_offset, tail_offset)
    return torch.where(row_sel, float(Rt), float(R)).to(torch.float32), overflow


def cascade_select_cuda(offset, max_offset=2, tail_offset=8, capacity_frac=0.125,
                        rows_per_step=16):
    """:func:`cascade_row_radius` by the kernel ``dcn_cascade_select``: one read
    of ``offset``, one launch (after the zeroing of its scratch)."""
    global select_launches
    if not offset.is_cuda:
        raise ValueError("cascade_select_cuda needs a CUDA tensor")
    R, Rt = _radii_pair(max_offset, tail_offset)
    B, H, W, G = offset.shape[:4]
    rpb = cascade_rows_per_block(Rt, rows_per_step)
    n_rblk, n_sel = cascade_slots(B, H, rpb, capacity_frac)
    off = offset.float().contiguous()
    row_radius = torch.empty((B, H), dtype=torch.float32, device=offset.device)
    scratch = torch.zeros(4 + B * n_rblk, dtype=torch.int64, device=offset.device)
    with torch.cuda.device(offset.device):
        err = _kernels()[1].dcn_cascade_select(
            off.data_ptr(), row_radius.data_ptr(), scratch.data_ptr(), B, H, W * G * 9,
            float(R), float(Rt), rpb, n_rblk, n_sel, torch.cuda.current_stream().cuda_stream)
    _build.check(err, "dcn_cascade_select")
    select_launches += 1
    return row_radius, scratch[:2]


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
                                       return_overflow=False, entry=None):
    """The selection kernel, then one pass of the entry :func:`route` picks
    (``entry`` names another one that takes these inputs)."""
    global cascade_launches
    _build.refuse_grad("modulated_deform_conv_cascade_cuda (not a training op)",
                       x, offset, mask, weight, bias)
    entry = route(x, offset, weight) if entry is None else entry
    _check_entry(entry, x, offset, mask, weight)
    if not x.is_cuda:
        raise ValueError("modulated_deform_conv_cascade_cuda needs CUDA tensors")
    row_radius, overflow = cascade_select_cuda(offset, max_offset, tail_offset, capacity_frac,
                                               rows_per_step)
    out = _launch(entry, True, x, offset, mask, weight, bias, row_radius)
    cascade_launches += 1
    cascade_launches_by_entry[entry] += 1
    return (out, overflow) if return_overflow else out


def modulated_deform_conv_cascade(x, offset, mask, weight, bias=None, max_offset=2,
                                  tail_offset=8, capacity_frac=0.125, rows_per_step=16,
                                  return_overflow=False):
    """The DCN cascade: the kernels for CUDA tensors, the plain version on the CPU."""
    fn = modulated_deform_conv_cascade_cuda if _build.on_card(x) else modulated_deform_conv_cascade_ref
    return fn(x, offset, mask, weight, bias, max_offset, tail_offset, capacity_frac,
              rows_per_step, return_overflow)


# ------------------------------------------------------- the gather hybrid --

HYBRID_PIXELS_PER_CHUNK = 16384  # slots of the exact tail per chunk (the JAX op's pixels_per_chunk)


def hybrid_slots(n_pixels: int, capacity_frac: float) -> int:
    """The gather hybrid's tail slots for ``n_pixels`` (= B*H*W): ``capacity_frac``
    of them rounded up to a multiple of 128, at least 128, at most ``n_pixels``."""
    return min(n_pixels, max(128, -(-int(n_pixels * capacity_frac) // 128) * 128))


def hybrid_selection(offset, max_offset=2, capacity_frac=0.125):
    """-> (selected bool [B*H*W], idx int64 [S]) of the gather hybrid. A pixel is
    out of band when any of its G*K taps has |dy| > R or |dx| > R; slot s holds
    the flat ``(b, h, w)`` index of the s-th out-of-band pixel (a cumulative sum
    fills them in order), the first S are selected, and an unfilled slot holds
    B*H*W. Torch ops on ``offset``'s device; nothing is read back."""
    B, H, W = offset.shape[:3]
    n = B * H * W
    S = hybrid_slots(n, capacity_frac)
    oob = (offset.float().abs().amax(dim=-1) > int(max_offset)).reshape(n, -1).any(dim=1)
    pos = torch.cumsum(oob.to(torch.int64), dim=0) - 1
    selected = oob & (pos < S)
    slot = torch.where(selected, pos, torch.full_like(pos, S))
    idx = torch.full((S + 1,), n, dtype=torch.int64, device=offset.device)
    idx.scatter_(0, slot, torch.arange(n, device=offset.device))  # slot S takes the rest, dropped
    return selected, idx[:S]


def hybrid_gather_tail(x, offset, mask, weight, idx, pixels_per_chunk=HYBRID_PIXELS_PER_CHUNK):
    """Exact DCNv2 without bias at the flat pixels ``idx`` (unbounded offsets,
    the CUDA extension's border rule: zero outside (-1, H) x (-1, W) and at
    each corner outside the image) -> ``[S, O]`` in x's type. A slot holding
    B*H*W is computed at the last pixel (its value is dropped by the caller).
    Chunks of ``pixels_per_chunk`` slots bound the gathered buffers; in each,
    the sampled column is rounded to x's type and contracted in float32."""
    B, H, W, C = x.shape
    G, O = offset.shape[3], weight.shape[-1]
    K, Cg, n = 9, C // G, B * H * W
    dev = x.device
    xg = x.reshape(n, G, Cg).permute(1, 0, 2).reshape(G * n, Cg)   # group-major rows
    off = offset.reshape(n, G, K, 2)
    m = mask.reshape(n, G, K)
    w2 = weight.reshape(K * C, O).to(x.dtype).float()
    ky = torch.tensor(_KY, dtype=torch.float32, device=dev)
    kx = torch.tensor(_KX, dtype=torch.float32, device=dev)
    g_row = (torch.arange(G, device=dev) * n).view(1, G, 1)
    outs = []
    for s0 in range(0, idx.shape[0], pixels_per_chunk):
        p = idx[s0:s0 + pixels_per_chunk].clamp(max=n - 1)
        hw = p % (H * W)
        o = off[p].float()                                             # [s, G, K, 2]
        py = (hw // W).float().view(-1, 1, 1) + ky + o[..., 0]
        px = (hw % W).float().view(-1, 1, 1) + kx + o[..., 1]
        in_range = (py > -1.0) & (py < H) & (px > -1.0) & (px < W)
        y0, x0 = torch.floor(py), torch.floor(px)
        ly, lx = py - y0, px - x0
        hy, hx = 1.0 - ly, 1.0 - lx
        rows = (p - hw).view(-1, 1, 1) + g_row                         # image start of each group

        def corner(yi, xi, wgt):
            valid = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W) & in_range
            lin = (yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)).long()
            vals = xg.index_select(0, (rows + lin).reshape(-1)).float()   # [s*G*K, Cg]
            return vals * (wgt * valid.to(wgt.dtype)).reshape(-1, 1)

        samp = corner(y0, x0, hy * hx)
        samp = samp + corner(y0, x0 + 1, hy * lx)
        samp = samp + corner(y0 + 1, x0, ly * hx)
        samp = samp + corner(y0 + 1, x0 + 1, ly * lx)
        samp = samp * m[p].float().reshape(-1, 1)
        col = samp.reshape(-1, G, K, Cg).permute(0, 2, 1, 3).reshape(-1, K * C)
        outs.append((col.to(x.dtype).float() @ w2).to(x.dtype))
    return torch.cat(outs)


def _hybrid(base, x, offset, mask, weight, bias, max_offset, capacity_frac):
    B, H, W, C, O, G = _check(x, offset, mask, weight)
    R = int(max_offset)
    selected, idx = hybrid_selection(offset, R, capacity_frac)
    keep = (~selected).reshape(B, H, W, 1, 1).to(mask.dtype)
    out = base(x, offset, mask * keep, weight, None, max_offset=R)
    vals = hybrid_gather_tail(x, offset, mask, weight, idx)
    flat = torch.cat([out.reshape(B * H * W, O), out.new_zeros(1, O)])   # row B*H*W: unfilled slots
    flat.index_copy_(0, idx, vals)
    out = flat[:-1].reshape(B, H, W, O)
    return out if bias is None else out + bias.to(out.dtype)


HYBRID_BASES = ("chain", "pallas")


def _hybrid_base(base):
    """The JAX op's ``base`` picks its clamp-R base pass (the select-chain or the
    Pallas kernel); both are the same function, which the port computes one way."""
    if base not in HYBRID_BASES:
        raise ValueError(f"base {base!r}: the gather hybrid's clamp-R base pass is 'chain' or "
                         "'pallas' (one pass in the port: the kernel on the card, its plain "
                         "version on the CPU)")


def modulated_deform_conv_hybrid_ref(x, offset, mask, weight, bias=None, max_offset=2,
                                     capacity_frac=0.125, base="chain"):
    """Plain PyTorch gather hybrid: the base pass by :func:`modulated_deform_conv_ref`."""
    _hybrid_base(base)
    return _hybrid(modulated_deform_conv_ref, x, offset, mask, weight, bias, max_offset,
                   capacity_frac)


def modulated_deform_conv_hybrid(x, offset, mask, weight, bias=None, max_offset=2,
                                 capacity_frac=0.125, base="chain"):
    """The gather hybrid: for CUDA tensors the base pass is one launch of the
    kernel :func:`route` picks (:func:`modulated_deform_conv_cuda`; it raises
    rather than fall back), on the CPU the plain version. ``base``: "chain" or
    "pallas" (:data:`HYBRID_BASES`), both this base pass."""
    _hybrid_base(base)
    if not _build.on_card(x):
        return modulated_deform_conv_hybrid_ref(x, offset, mask, weight, bias, max_offset,
                                                capacity_frac)
    return _hybrid(modulated_deform_conv_cuda, x, offset, mask, weight, bias, max_offset,
                   capacity_frac)
