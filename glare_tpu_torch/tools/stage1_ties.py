"""Probes why stage-1 HQ gradients differ between the card and the CPU by more than rounding.

    python3 glare_tpu_torch/tools/stage1_ties.py      # from the repo root; needs the GPU

Sets up the model of ``chip_smoke.py``'s ``train_stage1_path`` as that phase does
(full width, seeded weights, the codebook conditioned, four iterations on synthetic
256x256 images) and takes its 128x128 card-against-CPU crop. Prints one JSON line
for each of:

- ``loss_terms``: each loss term's generator gradient, on the card and on the CPU, in
  float64 and in float32, against the CPU's float64: per tensor the 2-norm of the
  difference over the reference's, then the root mean square and the largest over
  the tensors;
- ``max_pool_ties``: the generator's output in float64 (exactly equal neighbours,
  where the clamped synthetic image is flat) and the perceptual VGG's two max pools
  on it in float64 on both devices: windows whose largest value occurs twice, windows
  whose argmax differs, and the perceptual loss's gradient with respect to the
  output, card against CPU.
"""

from __future__ import annotations

import json
import math
import os
import sys

import torch
import torch.nn.functional as F


def _rel(a, b):
    return float((a - b).norm() / b.norm()) if float(b.norm()) > 0 else 0.0


def _summary(got, ref):
    ds = [_rel(got[n], ref[n]) for n in ref if float(ref[n].norm()) > 0]
    return {"rms": math.sqrt(sum(d * d for d in ds) / max(len(ds), 1)), "max": max(ds, default=0.0)}


def _term_grads(model, gt_nhwc, device, dtype):
    """{loss term: {generator tensor: gradient (float64, CPU)}} of one g step."""
    for m in (model.net_g, model.net_d, model.cri_perceptual):
        m.to(dtype)
    gt = model._nchw(gt_nhwc.to(device, dtype))
    _, losses, _, _ = model.g_losses(gt, gt, True)
    names, params = zip(*[(n, p) for n, p in model.net_g.named_parameters() if p.requires_grad])
    out = {}
    for term, value in losses.items():
        grads = torch.autograd.grad(value, params, retain_graph=True, allow_unused=True)
        out[term] = {n: (torch.zeros_like(p) if g is None else g).detach().double().cpu()
                     for n, p, g in zip(names, params, grads)}
    for m in (model.net_g, model.net_d, model.cri_perceptual):
        m.to(torch.float32)
    return out


def _pools(loss, pred, gt, device):
    """The perceptual loss of ``pred`` against ``gt`` on ``device`` (float64), the
    VGG written out to keep each max pool's argmax. -> (gradient w.r.t. pred,
    [argmax], [windows that tie])."""
    vgg = loss.to(device).vgg
    p = pred.to(device).clone().requires_grad_(True)
    x, y = (p - vgg.mean) / vgg.std, (gt.to(device) - vgg.mean) / vgg.std
    total, picks, ties = 0, [], []
    for name in vgg.names:
        if name.startswith("conv"):
            x, y = vgg.vgg_net[name](x), vgg.vgg_net[name](y)
        elif name.startswith("relu"):
            x, y = F.relu(x), F.relu(y)
        else:
            win = F.unfold(x.detach().flatten(0, 1)[:, None], 2, stride=2)
            top = win.max(dim=1, keepdim=True).values
            ties.append(int((((win == top).sum(1) > 1) & (top[:, 0] > 0)).sum()))
            x, idx = F.max_pool2d(x, 2, 2, return_indices=True)
            y = F.max_pool2d(y, 2, 2)
            picks.append(idx.cpu())
        if name in loss.layer_weights:
            total = total + loss.layer_weights[name] * (x - y).abs().mean()
    grad = torch.autograd.grad(total, p)[0].cpu()
    loss.to("cpu")
    return grad, picks, ties


def main():
    sys.path.insert(0, os.getcwd())
    sys.argv = sys.argv[:1]
    import chip_smoke as cs  # exits unless a GPU is there
    from glare_tpu_torch.sr.models import build_model

    model = build_model(cs.stage1_opt(), device="cuda")
    batches = [cs.s1_batch(100 + i) for i in range(5)]
    cs.condition_codebook(model, batches[0])
    model.init_ema(model.net_g)
    cs._s1_iterations(model, batches[:4], {k: 0 for k in cs.counters()},
                      {k: 0 for k in cs.dcn_ops.bwd_launches_by_entry})
    gt = batches[4]["gt"][:1, :cs.S1_CROP, :cs.S1_CROP]
    cpu = build_model(cs.stage1_opt(), device="cpu")
    for net in ("net_g", "net_d"):
        getattr(cpu, net).load_state_dict({k: v.cpu() for k, v in getattr(model, net).state_dict().items()})
    cpu.cri_perceptual.load_state_dict({k: v.cpu() for k, v in model.cri_perceptual.state_dict().items()})

    runs = {f"{where}_{bits}": _term_grads(m, gt, dev, dtype)
            for where, m, dev in (("card", model, "cuda"), ("cpu", cpu, "cpu"))
            for bits, dtype in (("float64", torch.float64), ("float32", torch.float32))}
    ref = runs["cpu_float64"]
    print(json.dumps({"loss_terms": {k: {t: _summary(v[t], ref[t]) for t in ref}
                                     for k, v in runs.items() if k != "cpu_float64"},
                      "against": "cpu_float64"}), flush=True)

    cpu.net_g.double()
    with torch.no_grad():
        gt64 = cpu._nchw(gt.cpu().double())
        pred = cpu.net_g.encode_and_decode(gt64)[0]
    equal = int(sum(((pred[..., 1:, :] == pred[..., :-1, :]).sum(), (pred[..., 1:] == pred[..., :-1]).sum())))
    loss = cpu.cri_perceptual.double()
    g_cpu, p_cpu, t_cpu = _pools(loss, pred, gt64, "cpu")
    g_card, p_card, t_card = _pools(loss, pred, gt64, "cuda")
    print(json.dumps({"max_pool_ties": {
        "output_equal_neighbours": equal, "output_values": pred.numel(),
        "windows_tied_cpu": t_cpu, "windows_tied_card": t_card,
        "argmax_differs": [int((a != b).sum()) for a, b in zip(p_cpu, p_card)],
        "perceptual_grad_card_vs_cpu_float64": _rel(g_card, g_cpu)}}), flush=True)


if __name__ == "__main__":
    main()
