"""Weights carried across: flax param trees -> torch ``state_dict``s.

``flax_to_torch_vqgan(params)``, ``flax_to_torch_stage2(params)``,
``flax_to_torch_stage3(params)``, ``flax_to_torch_vgg16(params)`` (the
perceptual loss's ``VGG16Features``), ``flax_to_torch_stage1(params,
spectral=None)`` (the stage-1 ``VQWeightDehazeNet`` or ``UNetDiscriminatorSN``),
``flax_to_torch_vgg(params)`` (``sr/archs/vgg_arch.VGGFeatureExtractor``),
``flax_to_torch_swinir(params)``, ``flax_to_torch_rrdbnet(params)``,
``flax_to_torch_legacy(params, batch_stats)`` (``ColorEncoder`` and the base
layers of ``modules/legacy_archs``), ``flax_to_torch_gumbel(params)`` and
``flax_to_torch_ema(ema)`` (the two quantizer variants) and
``flax_to_torch_resblock_gn(params)`` (``nn.ResBlockGN``) take nested
dicts of numpy arrays (what ``flax.serialization.to_state_dict`` or
``jax.tree_util.tree_map(np.asarray, params)`` give) and return a ``state_dict``
of torch tensors under the reference PyTorch names. The first three are the
inverses of the checkpoint converters in ``tools/torch2flax.py`` (which has no
stage-1 converter; the stage-1 names are documented at ``flax_to_torch_stage1``):

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


def flax_to_torch_resblock_gn(params):
    """flax ``ResBlockGN`` params -> the port's ``ResBlockGN`` ``state_dict`` (the
    reference's names: ``norm1``, ``conv1``, ``norm2``, ``conv2``, ``conv_out``)."""
    sd = {}
    for norm in ("norm1", "norm2"):
        _put_norm(sd, norm, params[norm])
    for conv in ("conv1", "conv2", "conv_out"):
        if conv in params:
            _put_conv(sd, conv, params[conv])
    return sd


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
        warp = tree[f"warp_{w}"]
        _put_conv(sd, f"{prefix}.warp.{w}.offset", warp["offset"])
        if "dcn" in warp:
            _put_dcnpack(sd, f"{prefix}.warp.{w}.dcn", warp["dcn"])
        else:  # warp_mode flow: the JAX module's names (no reference checkpoint has one)
            _put_conv(sd, f"{prefix}.warp.{w}.flow_head", warp["flow_head"])
            _put_conv(sd, f"{prefix}.warp.{w}.post_conv", warp["post_conv"])
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


def flax_to_torch_stage2(params):
    """flax ``LLFlowVQGAN2`` params -> torch ``state_dict`` (inverse of
    ``convert_stage2``)."""
    sd = {}
    _put_cond_encoder(sd, "RRDB", params["RRDB"])
    _put_flow_upsampler(sd, "flowUpsamplerNet", params["flowUpsamplerNet"])
    return sd


def flax_to_torch_stage3(params):
    """flax ``VQLLFLOWDeformable`` params -> torch ``state_dict`` (inverse of
    ``convert_stage3``)."""
    sd = {}
    _put_cond_encoder(sd, "RRDB", params["RRDB"])
    _put_flow_upsampler(sd, "flowUpsamplerNet", params["flowUpsamplerNet"])
    _put_aft_decoder(sd, "deformable_decoder", params["deformable_decoder"])
    return sd


def flax_to_torch_vgg16(params):
    """flax ``VGG16Features`` params (``conv_{i}``, HWIO) -> the port's
    ``VGG16Features`` ``state_dict`` (``convs.{i}``, OIHW)."""
    sd = {}
    for i in range(7):
        _put_conv(sd, f"convs.{i}", params[f"conv_{i}"])
    return sd


# ------------------------------------------------------------------ stage 1 --

_DOWN = re.compile(r"^down_(\d+)_(conv|res1|res2)$")
_UP = re.compile(r"^up_(\d+)_(conv|res1|res2)$")
_SLOT = {"conv": 0, "res1": 1, "res2": 2}  # order inside a (conv, ResBlock, ResBlock) run


def _put_dense(sd, name, node):
    sd[f"{name}.weight"] = _t(np.asarray(node["kernel"]).T)
    sd[f"{name}.bias"] = _t(node["bias"])


def _put_layernorm(sd, name, node):
    sd[f"{name}.weight"] = _t(node["scale"])
    sd[f"{name}.bias"] = _t(node["bias"])


def _put_ridcp_resblock(sd, name, node):
    """JAX ResBlock (norm1, conv1, norm2, conv2; gn) -> ``conv.{0,2,3,5}``."""
    for norm, i in (("norm1", 0), ("norm2", 3)):
        if "GroupNorm32_0" not in node[norm]:
            raise NotImplementedError("flax_to_torch_stage1: norm_type gn only (in / none have no "
                                      "parameters; bn is not converted)")
        _put_norm(sd, f"{name}.conv.{i}.norm", node[norm]["GroupNorm32_0"])
    _put_conv(sd, f"{name}.conv.2", node["conv1"])
    _put_conv(sd, f"{name}.conv.5", node["conv2"])


def _put_rstb(sd, name, node):
    for key, blk in node["residual_group"].items():
        b = f"{name}.residual_group.blocks.{int(key.split('_')[1])}"
        _put_layernorm(sd, f"{b}.norm1", blk["norm1"])
        _put_layernorm(sd, f"{b}.norm2", blk["norm2"])
        _put_dense(sd, f"{b}.attn.qkv", blk["attn"]["qkv"])
        _put_dense(sd, f"{b}.attn.proj", blk["attn"]["proj"])
        sd[f"{b}.attn.relative_position_bias_table"] = _t(blk["attn"]["relative_position_bias_table"])
        _put_dense(sd, f"{b}.mlp.fc1", blk["mlp"]["fc1"])
        _put_dense(sd, f"{b}.mlp.fc2", blk["mlp"]["fc2"])
    if "conv" in node:
        _put_conv(sd, f"{name}.conv", node["conv"])
    else:  # 3conv: conv_0 / conv_1 / conv_2 between LeakyReLUs
        for j in range(3):
            _put_conv(sd, f"{name}.conv.{2 * j}", node[f"conv_{j}"])


def _put_stage1_block(sd, prefix, first, kind, node):
    """One of (conv, res1, res2) of a Sequential whose conv is at index ``first``."""
    put = _put_conv if kind == "conv" else _put_ridcp_resblock
    put(sd, f"{prefix}.{first + _SLOT[kind]}", node)


def flax_to_torch_stage1(params, spectral=None):
    """flax ``VQWeightDehazeNet`` params -> the port's ``state_dict``; or, for a
    tree with ``conv0`` .. ``conv9``, flax ``UNetDiscriminatorSN`` params (and
    its ``spectral`` collection's ``u``) -> the port's.

    Names (JAX -> port; the port's follow the RIDCP reference):
      multiscale_encoder/in_conv                -> multiscale_encoder.in_conv
      multiscale_encoder/down_{i}_{conv,res1,res2} -> multiscale_encoder.blocks.{i}.{0,1,2}
      multiscale_encoder/swin_layers/swin_blk_{j}  -> multiscale_encoder.swin_blks.swin_blks.{j}
          residual_group/block_{k}/{norm1,attn/{qkv,proj,relative_position_bias_table},norm2,mlp/{fc1,fc2}}
                                                -> residual_group.blocks.{k}.<same> (Dense kernel^T)
          conv | conv_{0,1,2}                   -> conv | conv.{0,2,4}
      a ResBlock's norm1 / conv1 / norm2 / conv2 -> conv.0.norm / conv.2 / conv.3.norm / conv.5
      quantize_group_{s}/{embedding, weight}    -> quantize_group.{s}.{embedding.weight, weight}
      before_quant_group_{s}                    -> before_quant_group.{s}
      after_quant_group_{s}/conv                -> after_quant_group.{s}.conv
      decoder_group_{i}/{conv,res1,res2}        -> decoder_group.{i}.block.{1,2,3}
      multiscale_decoder/up_{i}_{conv,res1,res2} -> multiscale_decoder.upsampler.{i}.{1,2,3}
      multiscale_decoder/warp_{i}/offset        -> multiscale_decoder.warp.{i}.offset
      multiscale_decoder/warp_{i}/dcn           -> multiscale_decoder.warp.{i}.dcn (the
                                                   ``conv_offset`` channels permuted as in stage 3)
      out_conv, residual_conv                   -> the same
      conv_semantic                             -> conv_semantic.0
      discriminator conv{i}/{kernel,bias}, spectral conv{i}/u -> conv{i}.{weight,bias,u}
    Conv kernels HWIO -> OIHW."""
    sd = {}
    if "conv0" in params:
        for key, node in params.items():
            _put_conv(sd, key, node)
            if spectral is not None:
                sd[f"{key}.u"] = _t(spectral[key]["u"])
        return sd
    for key, node in params.items():
        if key == "multiscale_encoder":
            for k, sub in node.items():
                m = _DOWN.match(k)
                if m:
                    _put_stage1_block(sd, f"{key}.blocks.{m.group(1)}", 0, m.group(2), sub)
                elif k == "in_conv":
                    _put_conv(sd, f"{key}.in_conv", sub)
                elif k == "swin_layers":
                    for blk, rstb in sub.items():
                        _put_rstb(sd, f"{key}.swin_blks.swin_blks.{int(blk.split('_')[-1])}", rstb)
        elif key == "multiscale_decoder":
            for k, sub in node.items():
                m = _UP.match(k)
                if m:
                    _put_stage1_block(sd, f"{key}.upsampler.{m.group(1)}", 1, m.group(2), sub)
                elif k.startswith("warp_"):
                    w = f"{key}.warp.{int(k.split('_')[1])}"
                    _put_conv(sd, f"{w}.offset", sub["offset"])
                    _put_dcnpack(sd, f"{w}.dcn", sub["dcn"])
        elif key.startswith("decoder_group_"):
            for k, sub in node.items():
                _put_stage1_block(sd, f"decoder_group.{int(key.split('_')[-1])}.block", 1, k, sub)
        elif key.startswith("quantize_group_"):
            s_ = int(key.split("_")[-1])
            sd[f"quantize_group.{s_}.embedding.weight"] = _t(node["embedding"])
            sd[f"quantize_group.{s_}.weight"] = _t(node["weight"])
        elif key.startswith("before_quant_group_"):
            _put_conv(sd, f"before_quant_group.{int(key.split('_')[-1])}", node)
        elif key.startswith("after_quant_group_"):
            _put_conv(sd, f"after_quant_group.{int(key.split('_')[-1])}.conv", node["conv"])
        elif key in ("out_conv", "residual_conv"):
            _put_conv(sd, key, node)
        elif key == "conv_semantic":
            _put_conv(sd, "conv_semantic.0", node)
        else:
            raise KeyError(f"flax_to_torch_stage1: unknown subtree {key!r}")
    return sd


def flax_to_torch_vgg(params):
    """flax ``VGGFeatureExtractor`` params (``{name: {kernel, bias}}``, optionally
    under ``"params"``) -> the port's ``{vgg_net.<name>.weight / .bias}``."""
    params = params.get("params", params)
    sd = {}
    for name, node in params.items():
        _put_conv(sd, f"vgg_net.{name}", node)
    return sd


def flax_to_torch_swinir(params):
    """flax ``SwinIR`` params -> the port's ``SwinIR`` ``state_dict`` (the
    reference's names; the inverse of ``convert_swinir``):
      conv_first, norm                  -> the same
      patch_norm                        -> patch_embed.norm
      absolute_pos_embed                -> the same
      layer_{i}                         -> layers.{i} (``_put_rstb``)
      conv_after_body | cab_conv{0,1,2} -> conv_after_body | conv_after_body.{0,2,4}
      conv_before_upsample              -> conv_before_upsample.0
      upsample/conv{n}                  -> upsample.{2n} (the pixel-shuffle Sequential)
      upsample_conv                     -> upsample.0 (pixelshuffledirect)
      conv_up1, conv_up2, conv_hr, conv_last -> the same"""
    params = params.get("params", params)
    sd = {}
    for key, node in params.items():
        if key.startswith("layer_"):
            _put_rstb(sd, f"layers.{int(key.split('_')[1])}", node)
        elif key == "patch_norm":
            _put_layernorm(sd, "patch_embed.norm", node)
        elif key == "norm":
            _put_layernorm(sd, "norm", node)
        elif key == "absolute_pos_embed":
            sd[key] = _t(node)
        elif key.startswith("cab_conv"):
            _put_conv(sd, f"conv_after_body.{2 * int(key[-1])}", node)
        elif key == "conv_before_upsample":
            _put_conv(sd, "conv_before_upsample.0", node)
        elif key == "upsample":
            for name, conv in node.items():
                _put_conv(sd, f"upsample.{2 * int(name[4:])}", conv)
        elif key == "upsample_conv":
            _put_conv(sd, "upsample.0", node)
        elif key in ("conv_first", "conv_after_body", "conv_up1", "conv_up2", "conv_hr", "conv_last"):
            _put_conv(sd, key, node)
        else:
            raise KeyError(f"flax_to_torch_swinir: unknown subtree {key!r}")
    return sd


# ------------------------------------------------------------ legacy modules --

_LEGACY_NAMES = {"mlp1": "sharedMLP.0", "mlp2": "sharedMLP.2", "cbr1": "conv_bn_relu_1",
                 "cbr2": "conv_bn_relu_2", "cbr4": "conv_bn_relu_4", "deconv2": "deconv_2",
                 "deconv41": "deconv_4_1", "deconv42": "deconv_4_2"}


def _put_deconv(sd, name, node):
    """flax ConvTranspose kernel (kh, kw, in, out), applied unflipped -> torch
    ConvTranspose2d weight (in, out, kh, kw), spatially flipped."""
    sd[f"{name}.weight"] = _t(np.asarray(node["kernel"])[::-1, ::-1].transpose(2, 3, 0, 1))
    sd[f"{name}.bias"] = _t(node["bias"])


def _put_bn(sd, name, node, stats):
    sd[f"{name}.weight"] = _t(node["scale"])
    sd[f"{name}.bias"] = _t(node["bias"])
    sd[f"{name}.running_mean"] = _t(stats["mean"])
    sd[f"{name}.running_var"] = _t(stats["var"])
    sd[f"{name}.num_batches_tracked"] = torch.tensor(0)


def _put_legacy(sd, prefix, node, stats):
    for key, sub in node.items():
        st = stats.get(key, {})
        if key == "conv" and "bn" in node:  # ConvBNRelu
            _put_conv(sd, f"{prefix}conv_bn_relu.0", sub)
        elif key == "bn":
            _put_bn(sd, f"{prefix}conv_bn_relu.1", sub, st)
        elif key == "conv" and set(node) == {"conv"} and "bias" in sub:  # Conv2D
            _put_conv(sd, f"{prefix}conv_relu.0", sub)
        elif key == "deconv":  # ConvTranspose2D
            _put_deconv(sd, f"{prefix}deconv_relu.0", sub)
        elif key == "bn1":  # ResConv: bn2 exists in the port (the reference's, unused) with defaults
            _put_bn(sd, f"{prefix}bn1", sub, st)
            n = np.asarray(sub["scale"]).shape[0]
            _put_bn(sd, f"{prefix}bn2", {"scale": np.ones(n), "bias": np.zeros(n)},
                    {"mean": np.zeros(n), "var": np.ones(n)})
        elif "kernel" in sub:  # a plain conv, with or without bias
            name = f"{prefix}{_LEGACY_NAMES.get(key, key)}"
            sd[f"{name}.weight"] = _conv_w(sub["kernel"])
            if "bias" in sub:
                sd[f"{name}.bias"] = _t(sub["bias"])
        else:
            _put_legacy(sd, f"{prefix}{_LEGACY_NAMES.get(key, key)}.", sub, st)


def flax_to_torch_legacy(params, batch_stats=None):
    """flax ``ColorEncoder`` or base-layer params (``Conv2D``, ``ConvTranspose2D``,
    ``ConvBNRelu``, ``DoubleConv``, ``ChannelAttention``, ``SpatialAttention``,
    ``CBAM``, ``ResConv``, ``MSIA``) and their ``batch_stats`` -> the port's
    ``modules/legacy_archs`` ``state_dict``:
      Conv2D conv                 -> conv_relu.0
      ConvTranspose2D deconv      -> deconv_relu.0 (kernel flipped, (in, out, kh, kw))
      ConvBNRelu conv / bn        -> conv_bn_relu.0 / conv_bn_relu.1 (+ running_mean / var)
      mlp1 / mlp2                 -> sharedMLP.0 / sharedMLP.2
      cbr{1,2,4}, deconv2, deconv4{1,2} -> conv_bn_relu_{1,2,4}, deconv_2, deconv_4_{1,2}
      ResConv bn1                 -> bn1; bn2 (unused) gets BatchNorm's defaults
    every other name as it is."""
    sd = {}
    _put_legacy(sd, "", params.get("params", params), batch_stats or {})
    return sd


def flax_to_torch_rrdbnet(params):
    """flax ``RRDBNet`` params -> the port's (the reference's names):
    trunk_{i}/RDB{k}/conv{n} -> RRDB_trunk.{i}.RDB{k}.conv{n}; conv_first,
    trunk_conv, upconv{1..5}, HRconv, conv_last as they are."""
    sd = {}
    for key, node in params.get("params", params).items():
        m = re.match(r"^trunk_(\d+)$", key)
        if m:
            for rdb, convs in node.items():
                for conv, leaf in convs.items():
                    _put_conv(sd, f"RRDB_trunk.{m.group(1)}.{rdb}.{conv}", leaf)
        else:
            _put_conv(sd, key, node)
    return sd


def flax_to_torch_gumbel(params):
    """flax ``GumbelQuantize`` params -> ``proj.{weight, bias}``, ``embed.weight``
    (the buffer ``used`` comes from the module's ``remap``)."""
    params = params.get("params", params)
    sd = {"embed.weight": _t(params["embed"])}
    _put_conv(sd, "proj", params["proj"])
    return sd


def flax_to_torch_ema(ema):
    """The flax ``EMAVectorQuantizer``'s ``ema`` collection -> the buffers
    ``embedding.{weight, cluster_size, embed_avg}``."""
    ema = ema.get("ema", ema)
    return {f"embedding.{k}": _t(ema[k]) for k in ("weight", "cluster_size", "embed_avg")}
