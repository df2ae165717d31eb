"""Weights carried across: flax param trees -> torch ``state_dict``s.

``flax_to_torch_vqgan(params)`` and ``flax_to_torch_stage3(params)`` take nested
dicts of numpy arrays (what ``flax.serialization.to_state_dict`` or
``jax.tree_util.tree_map(np.asarray, params)`` give) and return a ``state_dict``
of torch tensors under the reference PyTorch names. They are the inverses of the
checkpoint converters in ``tools/torch2flax.py``:

  conv kernel  HWIO -> OIHW
  ``GroupNorm_0/{scale,bias}`` -> ``norm.{weight,bias}``
  actnorm ``[C]`` -> ``[1, C, 1, 1]``;  ``Conv2dZeros.logs`` ``[C]`` -> ``[C, 1, 1]``
  DCN ``conv_offset``: the JAX package orders its output channels
  ``[dy(G*K) | dx(G*K) | mask(G*K)]``, the reference packs ``cat(o1, o2)`` with
  per-group interleaved (dy, dx) pairs; the inverse channel permutation is
  applied to weight and bias.

Imports numpy and torch only.
"""

from __future__ import annotations

import re

import numpy as np
import torch


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, dtype=np.float32)))


def _conv_w(a):
    """HWIO -> OIHW."""
    return _t(np.asarray(a).transpose(3, 2, 0, 1))


def dcn_offset_permutation(G=4, K=9):
    """``perm`` with jax_channels[c] = torch_channels[perm[c]] (3*G*K channels)."""
    perm = np.zeros(3 * G * K, np.int64)
    for g in range(G):
        for k in range(K):
            perm[g * K + k] = g * 2 * K + 2 * k
            perm[G * K + g * K + k] = g * 2 * K + 2 * k + 1
            perm[2 * G * K + g * K + k] = 2 * G * K + g * K + k
    return perm


def _put_conv(sd, name, node):
    sd[f"{name}.weight"] = _conv_w(node["kernel"])
    sd[f"{name}.bias"] = _t(node["bias"])


def _put_norm(sd, name, node):
    sd[f"{name}.weight"] = _t(node["GroupNorm_0"]["scale"])
    sd[f"{name}.bias"] = _t(node["GroupNorm_0"]["bias"])


def _put_resblock(sd, name, node):
    _put_norm(sd, f"{name}.norm1", node["norm1"])
    _put_conv(sd, f"{name}.conv1", node["conv1"])
    _put_norm(sd, f"{name}.norm2", node["norm2"])
    _put_conv(sd, f"{name}.conv2", node["conv2"])
    for sc in ("nin_shortcut", "conv_shortcut"):
        if sc in node:
            _put_conv(sd, f"{name}.{sc}", node[sc])


def _put_attn(sd, name, node):
    _put_norm(sd, f"{name}.norm", node["norm"])
    for n in ("q", "k", "v", "proj_out"):
        _put_conv(sd, f"{name}.{n}", node[n])


_LEVEL_KEY = re.compile(r"^(down|up)_(\d+)_(block|attn)_(\d+)$")
_SAMPLE_KEY = re.compile(r"^(down|up)_(\d+)_(downsample|upsample)$")


def _put_ldm_trunk(sd, prefix, tree):
    """Encoder / Decoder / AFT-decoder trunk: conv_in, mid, down/up levels, norm_out."""
    for key, node in tree.items():
        m = _LEVEL_KEY.match(key)
        if m:
            side, lvl, kind, j = m.groups()
            put = _put_resblock if kind == "block" else _put_attn
            put(sd, f"{prefix}.{side}.{lvl}.{kind}.{j}", node)
            continue
        m = _SAMPLE_KEY.match(key)
        if m:
            side, lvl, kind = m.groups()
            _put_conv(sd, f"{prefix}.{side}.{lvl}.{kind}.conv", node["conv"])
            continue
        if key in ("mid_block_1", "mid_block_2"):
            _put_resblock(sd, f"{prefix}.mid.{key[4:]}", node)
        elif key == "mid_attn_1":
            _put_attn(sd, f"{prefix}.mid.attn_1", node)
        elif key == "norm_out":
            _put_norm(sd, f"{prefix}.norm_out", node)
        elif key in ("conv_in", "conv_out", "residual_conv"):
            _put_conv(sd, f"{prefix}.{key}", node)


def _put_actnorm(sd, name, node):
    sd[f"{name}.bias"] = _t(node["bias"]).reshape(1, -1, 1, 1)
    sd[f"{name}.logs"] = _t(node["logs"]).reshape(1, -1, 1, 1)


def _put_fnet(sd, name, node):
    for idx, key in ((0, "conv_in"), (2, "conv_hidden_0")):
        sd[f"{name}.{idx}.weight"] = _conv_w(node[key]["kernel"])
        _put_actnorm(sd, f"{name}.{idx}.actnorm", node[key]["actnorm"])
    z = node["conv_zeros"]
    sd[f"{name}.4.weight"] = _conv_w(z["kernel"])
    sd[f"{name}.4.bias"] = _t(z["bias"])
    sd[f"{name}.4.logs"] = _t(z["logs"]).reshape(-1, 1, 1)


def _put_flow_upsampler(sd, prefix, tree):
    for key, node in tree.items():
        i = int(key.split("_")[1])
        name = f"{prefix}.layers.{i}"
        _put_actnorm(sd, f"{name}.actnorm", node["actnorm"])
        sd[f"{name}.invconv.weight"] = _t(node["invconv"]["weight"])
        if "affine" in node:
            _put_fnet(sd, f"{name}.affine.fFeatures", node["affine"]["fFeatures"])
            _put_fnet(sd, f"{name}.affine.fAffine", node["affine"]["fAffine"])


def _put_cond_encoder(sd, prefix, tree):
    _put_ldm_trunk(sd, f"{prefix}.encoder", tree["encoder"])
    _put_conv(sd, f"{prefix}.cond_conv.0", tree["cond_conv"])
    _put_conv(sd, f"{prefix}.color_conv", tree["color_conv"])


def _put_dcnpack(sd, name, node, G=4, K=9):
    inv = np.argsort(dcn_offset_permutation(G, K))  # torch[c] = jax[inv[c]]
    co = node["conv_offset"]
    sd[f"{name}.conv_offset.weight"] = _conv_w(np.asarray(co["kernel"])[:, :, :, inv])
    sd[f"{name}.conv_offset.bias"] = _t(np.asarray(co["bias"])[inv])
    sd[f"{name}.weight"] = _conv_w(node["weight"])
    sd[f"{name}.bias"] = _t(node["bias"])


def _put_aft_decoder(sd, prefix, tree):
    _put_ldm_trunk(sd, prefix, tree)
    for w in range(2):
        _put_conv(sd, f"{prefix}.warp.{w}.offset", tree[f"warp_{w}"]["offset"])
        _put_dcnpack(sd, f"{prefix}.warp.{w}.dcn", tree[f"warp_{w}"]["dcn"])
        sd[f"{prefix}.mix.{w}.w"] = _t(tree[f"mix_{w}"]["w"]).reshape(-1)


def flax_to_torch_vqgan(params):
    """flax ``VQModel`` params -> torch ``state_dict`` (inverse of ``convert_vqgan``)."""
    sd = {}
    _put_ldm_trunk(sd, "encoder", params["encoder"])
    _put_ldm_trunk(sd, "decoder", params["decoder"])
    sd["quantize.embedding.weight"] = _t(params["quantize"]["embedding"])
    _put_conv(sd, "quant_conv", params["quant_conv"])
    _put_conv(sd, "post_quant_conv", params["post_quant_conv"])
    return sd


def flax_to_torch_stage3(params):
    """flax ``VQLLFLOWDeformable`` params -> torch ``state_dict`` (inverse of
    ``convert_stage3``)."""
    sd = {}
    _put_cond_encoder(sd, "RRDB", params["RRDB"])
    _put_flow_upsampler(sd, "flowUpsamplerNet", params["flowUpsamplerNet"])
    _put_aft_decoder(sd, "deformable_decoder", params["deformable_decoder"])
    return sd
