"""Bounded group-flow alignment of the AFT ``WarpBlock`` (``warp_mode: flow``).

Counterpart of ``glare_tpu/ops/warp.py``. Layouts as there:

  x     [B, H, W, C]
  flow  [B, H, W, G, 2]   (dy, dx) per group g of C // G channels
  out   [B, H, W, C]      x sampled bilinearly at (p + flow_g(p)), zero outside

  * :func:`flow_warp_align` -- the JAX op's formulation: the flow clipped to
    +-R, x zero-padded by R, and a select-chain over the (2R+1)^2 integer
    shifts, each shifted slice weighted by ``max(0, 1 - |d - s|)`` (computed
    in float32, cast to x's type) and summed in x's type. Plain torch ops, one
    multiply-add pass per shift; the JAX package runs the same chain in XLA,
    not in a Pallas kernel.
  * :func:`flow_warp_align_ref` -- plain version by gathers: the four bilinear
    corners of each sample, in float64, cast to x's type at the end.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _check(x, flow):
    if x.dim() != 4 or flow.dim() != 5 or tuple(flow.shape[:3]) != tuple(x.shape[:3]) \
            or flow.shape[4] != 2 or x.shape[3] % flow.shape[3] != 0:
        raise ValueError(f"x [B, H, W, C] and flow [B, H, W, G, 2] with C % G == 0, got "
                         f"{tuple(x.shape)} and {tuple(flow.shape)}")


def flow_warp_align(x, flow, max_offset=1):
    """x sampled at (p + flow) per group, bilinear, zero outside; the flow is
    clipped to +-``max_offset`` (an int R >= 1)."""
    _check(x, flow)
    B, H, W, C = x.shape
    G = flow.shape[3]
    R = int(max_offset)
    if R < 1:
        raise ValueError(f"max_offset must be at least 1, got {max_offset}")
    f = flow.float().clamp(-max_offset, max_offset)
    dy, dx = f[..., 0], f[..., 1]                                   # [B, H, W, G]
    xg = F.pad(x, (0, 0, R, R, R, R)).reshape(B, H + 2 * R, W + 2 * R, G, C // G)
    wxs = [(1.0 - (dx - sx).abs()).clamp(min=0.0) for sx in range(-R, R + 1)]
    acc = torch.zeros((B, H, W, G, C // G), dtype=x.dtype, device=x.device)
    for sy in range(-R, R + 1):
        wy = (1.0 - (dy - sy).abs()).clamp(min=0.0)
        for sx, wx in zip(range(-R, R + 1), wxs):
            w = (wy * wx).unsqueeze(-1).to(x.dtype)
            acc.addcmul_(xg[:, R + sy:R + sy + H, R + sx:R + sx + W], w)
    return acc.reshape(B, H, W, C)


def flow_warp_align_ref(x, flow, max_offset=1):
    """Plain version: the bilinear sample of each group at (p + clipped flow) by
    gathers of its four corners (a corner outside the image is zero), float64."""
    _check(x, flow)
    B, H, W, C = x.shape
    G = flow.shape[3]
    Cg = C // G
    f = flow.double().clamp(-max_offset, max_offset)
    py = torch.arange(H, dtype=torch.float64, device=x.device).view(1, H, 1, 1) + f[..., 0]
    px = torch.arange(W, dtype=torch.float64, device=x.device).view(1, 1, W, 1) + f[..., 1]
    y0, x0 = torch.floor(py), torch.floor(px)
    xg = x.double().reshape(B, H * W, G, Cg)
    out = torch.zeros((B, H * W, G, Cg), dtype=torch.float64, device=x.device)
    for yi in (y0, y0 + 1):
        for xi in (x0, x0 + 1):
            valid = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
            wgt = (1.0 - (py - yi).abs()) * (1.0 - (px - xi).abs()) * valid
            lin = (yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)).long().reshape(B, H * W, G, 1)
            out += torch.gather(xg, 1, lin.expand(B, H * W, G, Cg)) * wgt.reshape(B, H * W, G, 1)
    return out.reshape(B, H, W, C).to(x.dtype)
