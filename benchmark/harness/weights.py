"""Seeded weights, made on the device in a few large calls, and handed to both sides.

``make_state(cfg, seed, device)`` -> {name: float32 tensor} for every parameter
of the reference (whose names are the checkpoint's). Two draws of the whole
parameter count (one normal, one uniform) are cut into the tensors and scaled by
each tensor's kind (``reference.glare.init_kinds``); the scales are the
configuration's ``weights`` block:

    fan_in_uniform  U(-1/sqrt(fan_in), 1/sqrt(fan_in)), weight and bias (PyTorch's conv default)
    norm            weight 1 + norm_std * N, bias norm_std * N
    actnorm         bias actnorm_bias_std * N, logs actnorm_logs_mean + actnorm_logs_std * N
    orthogonal      Q of a QR of N (the 1x1 channel mixers)
    normal_0.05     0.05 * N (the coupling nets' normed convolutions)
    zeros_conv      coupling_out_std * N, logs 0 (the coupling nets' last convolutions)
    codebook        codebook_std * N
    mix             the module's own constant
    dcn             as fan_in_uniform, bias + dcn_bias_mean (the DCN's output mean,
                    which the AFT decoder divides by, kept away from 0)
    offset_head     as fan_in_uniform, then fitted (``fit_offset_heads``)
    output_head     fan_in_uniform * output_scale, bias output_bias + that

Tensors the configuration serves in bf16 (``served_bf16``: convolutions under
those prefixes) are rounded to bf16 values, so both sides hold the same weights.
"""

from __future__ import annotations

import math

import torch

from ..reference.glare import Conv, Reference, fan_in, init_kinds


def reference_skeleton(cfg):
    """The reference's modules with uninitialised parameters on the host: names,
    shapes and kinds (allocating untouched memory costs nothing; the meta device's
    first use costs seconds)."""
    return Reference(cfg)


def make_state(cfg, seed, device):
    w = cfg["weights"]
    model = reference_skeleton(cfg)
    kinds = init_kinds(model)
    params = dict(model.named_parameters())
    modules = dict(model.named_modules())
    total = sum(p.numel() for p in params.values())
    gen = torch.Generator(device=device).manual_seed(int(seed))
    normal = torch.randn(total, generator=gen, device=device)
    uniform = torch.rand(total, generator=gen, device=device).mul_(2.0).sub_(1.0)
    state, at, ortho = {}, 0, {}
    for name, p in params.items():
        n = p.numel()
        nrm, uni = normal[at:at + n].view(p.shape), uniform[at:at + n].view(p.shape)
        at += n
        mod_name, leaf = name.rsplit(".", 1)
        mod, kind = modules[mod_name], kinds[name]
        if kind in ("fan_in_uniform", "dcn", "offset_head", "output_head"):
            t = uni / math.sqrt(fan_in(mod.weight.shape))
            if kind == "dcn" and leaf == "bias":
                t = t + w["dcn_bias_mean"]
            if kind == "output_head":
                t = t * w["output_scale"] + (w["output_bias"] if leaf == "bias" else 0.0)
        elif kind == "norm":
            t = (1.0 if leaf == "weight" else 0.0) + w["norm_std"] * nrm
        elif kind == "actnorm":
            t = (w["actnorm_bias_std"] * nrm if leaf == "bias"
                 else w["actnorm_logs_mean"] + w["actnorm_logs_std"] * nrm)
        elif kind == "normal_0.05":
            t = 0.05 * nrm
        elif kind == "zeros_conv":
            t = torch.zeros_like(nrm) if leaf == "logs" else w["coupling_out_std"] * nrm
        elif kind == "codebook":
            t = w["codebook_std"] * nrm
        elif kind == "mix":
            t = torch.full(p.shape, mod.init_value, device=device)
        elif kind == "orthogonal":
            ortho[name] = nrm
            continue
        else:
            raise ValueError(f"unknown init kind {kind!r} of {name}")
        state[name] = t.float()
    if ortho:   # two dozen 3x3 factorisations: on the host (a solver library's start-up costs seconds)
        q, _ = torch.linalg.qr(torch.stack(list(ortho.values())).cpu())
        state.update({name: m.to(device) for name, m in zip(ortho, q)})
    round_served(cfg, model, state)
    return {k: state[k] for k in params}


def round_served(cfg, model, state):
    """Round the parameters of the convolutions that the program serves in bf16."""
    prefixes = tuple(cfg.get("served_bf16", ()))
    if not prefixes:
        return
    for mname, mod in model.named_modules():
        if isinstance(mod, Conv) and mname.startswith(prefixes):
            for leaf in ("weight", "bias"):
                k = f"{mname}.{leaf}"
                state[k] = state[k].to(torch.bfloat16).float()


def split_state(state):
    """-> (generator state_dict, VQGAN state_dict), the program's two networks."""
    g = {k[len("netG."):]: v for k, v in state.items() if k.startswith("netG.")}
    hq = {k[len("net_hq."):]: v for k, v in state.items() if k.startswith("net_hq.")}
    return g, hq


# ------------------------------------------------------------ offset heads --

def linf_taps(offsets):
    """[B, G*9*2, H, W] packed (dy, dx) -> [B, G*9, H, W] max(|dy|, |dx|)."""
    return torch.maximum(offsets[:, 0::2].abs(), offsets[:, 1::2].abs())


def offset_stats(linf):
    v = linf.flatten().float()
    if v.numel() > 1 << 24:
        v = v[torch.linspace(0, v.numel() - 1, 1 << 24, device=v.device).long()]
    q = torch.quantile(v, torch.tensor([0.5, 0.99, 0.999], device=v.device)).tolist()
    return {"p50": q[0], "p99": q[1], "p999": q[2], "max": float(linf.max()),
            "frac_beyond_2": float((linf > 2.0).float().mean())}


def fit_offset_heads(cfg, model, x, seed, state):
    """Scale and shift the two ``conv_offset`` heads so that, on input ``x``, each
    warp's offsets follow the configuration's ``offset_targets["warp_<w>"]`` (p50,
    p99, p999 of max(|dy|, |dx|) per tap).

    An offset channel c becomes ``sigma * (exp(kappa * n_c) * zhat_c)`` for
    ``kappa >= 0`` or ``sigma * (-kappa * n_c + zhat_c)`` for ``kappa < 0``:
    ``zhat_c`` the channel's input-dependent part, standardised over ``x``, and
    ``n_c`` a seeded N(0, 1) per channel. A positive ``kappa`` spreads the
    channels' scales (a heavier tail, as a trained head's channels differ); a
    negative one shifts the channels apart (a lighter tail, where the
    input-dependent part is already heavy-tailed). ``kappa`` is set by bisection
    so that p99 / p50 is the target's, then ``sigma`` so that p50 is. The heads'
    rows are rewritten in ``state`` (and in ``model``), so both sides get them.
    -> the fit and the measured stats per warp."""
    from ..reference import glare

    targets = cfg["offset_targets"]
    gen = torch.Generator(device=x.device).manual_seed(int(seed) + 7)
    stats = {}

    def quantiles(v, qs):
        linf = torch.maximum(v[0::2].abs(), v[1::2].abs()).flatten()
        return torch.quantile(linf, torch.tensor(qs, device=v.device)).tolist()

    def hook(w, warp, x_vq, h):
        prec = glare.Precision()
        head = warp.dcn.conv_offset
        n_off = head.weight.shape[0] * 2 // 3
        raw = head(warp.side(x_vq, h, prec), prec)[:, :n_off].float()
        mean = raw.mean(dim=(0, 2, 3))
        std = raw.std(dim=(0, 2, 3)).clamp(min=1e-12)
        n = torch.randn(n_off, generator=gen, device=x.device)
        flat = ((raw - mean[None, :, None, None]) / std[None, :, None, None]).permute(1, 0, 2, 3)
        flat = flat.reshape(n_off, -1)
        sub = flat[:, torch.randint(0, flat.shape[1], (8192,), generator=gen, device=x.device)]
        t = targets[f"warp_{w}"]

        def shaped(kappa):
            return torch.exp(kappa * n)[:, None] * sub if kappa >= 0 else -kappa * n[:, None] + sub

        lo, hi = -4.0, 2.0
        for _ in range(30):
            kappa = (lo + hi) / 2
            p50, p99 = quantiles(shaped(kappa), [0.5, 0.99])
            lo, hi = (kappa, hi) if p99 / p50 < t["p99"] / t["p50"] else (lo, kappa)
        kappa = (lo + hi) / 2
        sigma = t["p50"] / quantiles(shaped(kappa), [0.5])[0]
        if kappa >= 0:
            gain, shift = sigma * torch.exp(kappa * n) / std, torch.zeros_like(n)
        else:
            gain, shift = sigma / std.expand_as(n), sigma * -kappa * n
        name = f"netG.deformable_decoder.warp.{w}.dcn.conv_offset"
        with torch.no_grad():
            head.weight[:n_off] *= gain[:, None, None, None]
            head.bias[:n_off] = (head.bias[:n_off] - mean) * gain + shift
        state[f"{name}.weight"] = head.weight.detach().clone()
        state[f"{name}.bias"] = head.bias.detach().clone()
        stats[f"warp_{w}"] = {"kappa": kappa, "sigma": sigma}

    glare.run(model, x, offsets_hook=hook)
    round_served(cfg, reference_skeleton(cfg), state)
    model.load_state_dict(state)
    check = {}

    def measure(w, warp, x_vq, h):
        prec = glare.Precision()
        head = warp.dcn.conv_offset
        n_off = head.weight.shape[0] * 2 // 3
        raw = head(warp.side(x_vq, h, prec), prec)[:, :n_off]
        check[f"warp_{w}"] = offset_stats(linf_taps(raw))

    glare.run(model, x, offsets_hook=measure)
    for k in stats:
        stats[k].update(check[k])
    return stats

