"""Codebook-usage histogram of a stage-1 network (counterpart of
``tools/active_codebook.py``; the working equivalent of the reference's dead
``defor_cuda_ext/basicsr/active_codebook.py``).

Runs a corpus through the port's ``VQWeightDehazeNet`` (stage 1), counts how
often each of the n_e codes is retrieved, and saves the counts as a
ceil(sqrt(n_e)) x ceil(sqrt(n_e)) usage image.

    python -m glare_tpu_torch.tools.active_codebook --opt confs/stage1_HQ_pretrain.yml \\
        [--ckpt experiments/.../net_g_N.pth] --images DIR [--limit 100] [--size 256] \\
        [--out results/visual_code_usage.png] [--device cpu]

Writes ``<out>.npz`` (the counts, the active-code count and fraction) and, when
matplotlib imports, the ``<out>`` PNG heat map. Runs on ``cuda`` unless
``--device cpu`` is given; without ``--ckpt`` the weights are seeded.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch


@torch.no_grad()
def usage_counts(net, images, n_embed):
    """``images``: [H, W, 3] float arrays in [0, 1]; ``net``: a stage-1
    ``VQWeightDehazeNet``. -> (the usage image [g, g] float64 with g =
    ceil(sqrt(n_embed)), code k at (k // g, k % g); the number of codes used)."""
    dev = next(net.parameters()).device
    dtype = next(net.parameters()).dtype
    counts = np.zeros(n_embed, np.int64)
    for img in images:
        x = torch.as_tensor(np.asarray(img, np.float32), device=dev, dtype=dtype)[None]
        x = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        idx = net.encode_and_decode(x)[5][0]
        counts += np.bincount(idx.reshape(-1).cpu().numpy().astype(np.int64), minlength=n_embed)
    grid = int(np.ceil(np.sqrt(n_embed)))
    image = np.zeros(grid * grid, np.float64)
    image[:n_embed] = counts
    return image.reshape(grid, grid), int((counts > 0).sum())


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--opt", required=True, help="stage-1 YAML conf")
    ap.add_argument("--ckpt", default=None, help="net_g checkpoint (.pth)")
    ap.add_argument("--images", required=True, help="image directory")
    ap.add_argument("--limit", type=int, default=100)
    ap.add_argument("--size", type=int, default=256, help="edge the images are resized to")
    ap.add_argument("--out", default="results/visual_code_usage.png")
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)

    import cv2

    from ..models.base_model import resolve_device
    from ..nn.layers import seed_init_
    from ..sr.archs import build_network
    from ..sr.models.base_model import BaseSRModel
    from ..sr.utils.options import ordered_yaml_load

    device = resolve_device(args.device)
    opt = ordered_yaml_load(args.opt)
    net = build_network(dict(opt["network_g"]))
    seed_init_(net, torch.Generator().manual_seed(0))
    if args.ckpt:
        BaseSRModel.load_network(net, args.ckpt, strict=False)
    net = net.to(device, memory_format=torch.channels_last).eval()

    images = []
    for name in sorted(os.listdir(args.images))[:args.limit]:
        img = cv2.imread(os.path.join(args.images, name))
        if img is None:
            continue
        img = cv2.resize(img[:, :, ::-1], (args.size, args.size), interpolation=cv2.INTER_AREA)
        images.append(img.astype(np.float32) / 255.0)

    n_embed = int(opt["network_g"]["codebook_params"][0][1])
    image, active = usage_counts(net, images, n_embed)
    frac = active / n_embed
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    np.savez(args.out + ".npz", counts=image, active_codes=active, n_embed=n_embed, active_fraction=frac)
    print(json.dumps({"images": len(images), "active_codes": active, "n_embed": n_embed,
                      "active_fraction": round(frac, 4)}))
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        plt.imshow(image)
        plt.colorbar()
        plt.title(f"codebook usage ({active}/{n_embed} active)")
        plt.savefig(args.out)
    except ImportError:
        print(f"matplotlib unavailable; counts saved to {args.out}.npz")


if __name__ == "__main__":
    main()
