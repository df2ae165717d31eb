"""The learned DCN offset distribution of a stage-3 checkpoint (counterpart of
``tools/offset_histogram.py``).

The clamped DCN paths (``pallas``, ``chain``) clamp offsets to [-R, R] (R = 2 by
default); this measures whether that is exact for given weights. It runs the
stage-3 forward (``get_sr``, the port's DCN kernels running as they do when
serving) on real or synthetic images, captures each ``DCNv2Pack``'s raw offsets
``[B, H, W, G, K, 2]`` (dy, dx) with a forward hook on its offset head, and
reports percentiles of the per-tap Linf, the fraction of taps, pixels and row
blocks beyond R in {1, 2, 4, 8}, per deformable group and per (group, tap): the
JAX tool's JSON lines, one per warp and a combined verdict line.

    python -m glare_tpu_torch.tools.offset_histogram [--ckpt NNN_G.pth]
        [--images LOLdataset/eval15/low] [--height 420 --width 620] [--n 4]
        [--dtype bfloat16] [--dcn_impl pallas] [--device cpu] [--out FILE]

Runs on ``cuda`` unless ``--device cpu`` is given. Without ``--ckpt`` the weights
are seeded (tempered offset heads); without ``--images`` the inputs are seeded
dark images. ``--out`` (optional) also writes the lines to a file.
"""

from __future__ import annotations

import argparse
import glob
import json
import os

import numpy as np
import torch

RADII = (1, 2, 4, 8)


def raw_offsets(pack, raw):
    """A ``DCNv2Pack``'s offset-head output (NCHW) -> offsets [B, H, W, G, K, 2],
    float32: the channel packing of ``DCNv2Pack.offsets_and_mask``."""
    raw = raw.float()
    B, _, H, W = raw.shape
    o1, o2, _ = torch.chunk(raw, 3, dim=1)
    return torch.cat([o1, o2], dim=1).reshape(B, pack.G, pack.K, 2, H, W).permute(0, 4, 5, 1, 2, 3)


def collect_offsets(model, lq):
    """One ``model.get_sr(lq)`` -> {warp name: offsets [B, H, W, G, K, 2] numpy}."""
    from ..modules.deformable_decoder import DCNv2Pack

    out, hooks = {}, []
    for name, mod in model.netG.named_modules():
        if isinstance(mod, DCNv2Pack):
            def hook(_, __, raw, name=name, pack=mod):
                out[name] = raw_offsets(pack, raw).cpu().numpy()
            hooks.append(mod.conv_offset.register_forward_hook(hook))
    try:
        model.get_sr(lq)
    finally:
        for h in hooks:
            h.remove()
    return out


def offset_stats(chunks):
    """chunks: list of [B, H, W, G, K, 2] raw offsets (one per audited batch).
    Returns the evidence dict: tap-Linf percentiles + out-of-band fractions at tap,
    pixel and row-block granularity (row blocks of 8 and 16 rows, the cascade's
    units), per deformable group and per (group, tap). A copy of the JAX tool's."""
    mx = np.concatenate([np.abs(c.reshape(-1, 2)).max(axis=-1) for c in chunks])
    # one partial sort for the four percentiles (the values np.percentile gives one by one)
    q = dict(zip((50, 90, 99, 99.9), (round(float(v), 4) for v in np.percentile(mx, [50, 90, 99, 99.9]))))
    pix = np.concatenate([np.abs(c).max(axis=(3, 4, 5)).reshape(-1) for c in chunks])
    blk_fr = {}
    for rpb in (8, 16):
        blks = []
        for c in chunks:
            row = np.abs(c).max(axis=(2, 3, 4, 5))  # [B, H]
            B_, H_ = row.shape
            Hb = -(-H_ // rpb) * rpb
            rowp = np.pad(row, [(0, 0), (0, Hb - H_)])
            blks.append(rowp.reshape(B_, -1, rpb).max(axis=2).reshape(-1))
        blk = np.concatenate(blks)
        blk_fr[str(rpb)] = {str(r): round(float((blk > r).mean()), 6) for r in RADII}
    G = chunks[0].shape[3]
    groups = []
    for g in range(G):
        gm = np.concatenate([np.abs(c[:, :, :, g]).max(axis=-1).reshape(-1) for c in chunks])
        groups.append({
            "max": round(float(gm.max()), 4),
            "p999": round(float(np.percentile(gm, 99.9)), 4),
            "frac_exceed": {str(r): round(float((gm > r).mean()), 6) for r in RADII},
        })
    per_gk = np.maximum.reduce([np.abs(c).max(axis=(0, 1, 2, 5)) for c in chunks])  # [G, K]
    return {
        "taps": int(mx.size),
        "p50": q[50], "p90": q[90], "p99": q[99], "p999": q[99.9],
        "max": round(float(mx.max()), 4),
        "frac_exceed": {str(r): round(float((mx > r).mean()), 6) for r in RADII},
        "pix_frac_exceed": {str(r): round(float((pix > r).mean()), 6) for r in RADII},
        "rowblk_frac_exceed_by_rpb": blk_fr,
        "per_group": groups,
        "per_gk_max": [[round(float(v), 4) for v in row] for row in per_gk],
    }


def histogram(model, batches):
    """The JAX tool's lines over ``batches`` (log-domain [B, H, W, 3] arrays or
    tensors; one ``get_sr`` each): [per-warp dicts ..., the combined "ALL" dict]."""
    return summarize([collect_offsets(model, b) for b in batches])


def summarize(collected):
    """``collect_offsets`` results, one per batch -> the JAX tool's lines."""
    per_warp = {}
    for offsets in collected:
        for name, offs in offsets.items():
            per_warp.setdefault(name, []).append(offs)
    all_chunks, lines = [], []
    for name, chunks in sorted(per_warp.items()):
        all_chunks.extend(chunks)
        lines.append({"warp": name, **offset_stats(chunks)})
    combined = offset_stats(all_chunks)
    combined["clamp2px_parity_safe"] = combined["frac_exceed"]["2"] < 1e-3
    # one capacity knob serves every DCN call: the worst warp's block fraction binds
    combined["rowblk_frac_exceed_by_rpb_worstwarp"] = {
        rpb: {str(r): max(ws["rowblk_frac_exceed_by_rpb"][rpb][str(r)] for ws in lines) for r in RADII}
        for rpb in ("8", "16")}
    return lines + [{"warp": "ALL", **combined}]


def seeded_images(n, height, width, seed=0):
    """``n`` seeded dark images in the log domain, [1, height, width, 3] each."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        base = rng.rand(height, width, 3).astype(np.float32) * 0.15
        out.append(np.log(np.clip(base + 1e-3, 1e-3, None))[None])
    return out


def folder_images(folder, n, height, width):
    """The first ``n`` PNGs of ``folder``, cropped and reflect-padded to the shape,
    in the log domain."""
    from ..utils.imgproc import imread

    out = []
    for p in sorted(glob.glob(os.path.join(folder, "*.png")))[:n]:
        img = imread(p).astype(np.float32)[:height, :width] / 255.0
        img = np.pad(img, [(0, height - img.shape[0]), (0, width - img.shape[1]), (0, 0)], mode="reflect")
        out.append(np.log(np.clip(img + 1e-3, 1e-3, None))[None])
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", default=None, help="a stage-3 state_dict (.pth)")
    ap.add_argument("--images", default=None)
    ap.add_argument("--height", type=int, default=420)
    ap.add_argument("--width", type=int, default=620)
    ap.add_argument("--n", type=int, default=4)
    ap.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    ap.add_argument("--dcn_impl", default="pallas")
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    ap.add_argument("--out", default=None, help="also write the JSON lines here")
    args = ap.parse_args(argv)

    from .flops_audit import build_stage3

    model, _ = build_stage3(args.height, args.width, args.dtype, args.dcn_impl, args.device)
    if args.ckpt:
        model.load_network(args.ckpt, strict=True)
    batches = (folder_images(args.images, args.n, args.height, args.width) if args.images
               else seeded_images(args.n, args.height, args.width))
    lines = histogram(model, batches)
    for line in lines:
        print(json.dumps(line))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.writelines(json.dumps(line) + "\n" for line in lines)
    return lines


if __name__ == "__main__":
    main()
