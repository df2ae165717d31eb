"""Network factory (counterpart of ``glare_tpu/models/networks.py``).

``define_Flow`` builds the generator named by ``network_G.which_model_G``
(the stage-2 ``LLFlowVQGAN2`` or the stage-3 ``VQLLFLOWDeformable``);
``find_vqgan`` builds the frozen VQGAN named by ``network_VQGAN.type``.
"""

from __future__ import annotations

from ..modules.llflow_vqgan2 import LLFlowVQGAN2
from ..modules.vqllflow_deformable import VQLLFLOWDeformable
from ..modules.vqmodel import VQModel
from ..utils.util import opt_get


def _flow_kwargs(opt):
    flow = opt_get(opt, ["network_G", "flow"], {}) or {}
    quant = opt_get(opt, ["datasets", "train", "quant"], 255) or 255
    return dict(
        K=flow.get("K") or 12,
        L=flow.get("L") or 2,
        additional_flow_no_affine=int(flow.get("additionalFlowNoAffine") or 0),
        hidden_channels=flow.get("hidden_channels") or 64,
        coupling=flow.get("coupling") or "CondAffineSeparatedAndCond",
        quant=float(quant),
    )


def define_Flow(opt, step=0):
    which_model = opt_get(opt, ["network_G", "which_model_G"])
    kw = _flow_kwargs(opt)
    if which_model == "VQLLFLOWDeformable":
        warp_mode = opt_get(opt, ["network_G", "warp_mode"], "dcn") or "dcn"
        # inference defaults to the exact unbounded op ('xla'); 'pallas' clamps at
        # network_G.dcn_max_offset; 'hybrid' is the cascade (clamp + wide-radius tail
        # on up to dcn_hybrid_capacity of the row blocks, exact for offsets up to
        # dcn_hybrid_tail_offset). Training defaults to 'chain': the clamped op at one
        # radius, which on the card runs the DCN autograd Function (the forward
        # kernel and csrc/dcn_bwd.cu).
        dcn_impl = opt_get(opt, ["network_G", "dcn_impl"], None) or (
            "chain" if opt.get("is_train") else "xla")
        # network_G.remat: recompute the AFT decoder's blocks in the backward (JAX's
        # default: on when training with a DCN other than the chain op)
        remat = opt_get(opt, ["network_G", "remat"],
                        bool(opt.get("is_train")) and dcn_impl != "chain")
        dcn_r = opt_get(opt, ["network_G", "dcn_max_offset"], 2) or 2
        if not isinstance(dcn_r, (tuple, list)):
            dcn_r = int(dcn_r)
        dcn_cap = float(opt_get(opt, ["network_G", "dcn_hybrid_capacity"], 0.125) or 0.125)
        dcn_tail = int(opt_get(opt, ["network_G", "dcn_hybrid_tail_offset"], 8) or 8)
        # miniaturization knobs for tests (shipped geometry when absent)
        mini = {k: int(opt_get(opt, ["network_G", k]))
                for k in ("enc_ch", "decoder_ch", "enc_num_res_blocks", "dec_num_res_blocks")
                if opt_get(opt, ["network_G", k]) is not None}
        return VQLLFLOWDeformable(warp_mode=warp_mode, dcn_impl=dcn_impl, dcn_max_offset=dcn_r,
                                  dcn_hybrid_capacity=dcn_cap, dcn_hybrid_tail_offset=dcn_tail,
                                  remat=bool(remat), **mini, **kw)
    if which_model == "LLFlowVQGAN2":
        mini = {k: int(opt_get(opt, ["network_G", k]))
                for k in ("enc_ch", "enc_num_res_blocks")
                if opt_get(opt, ["network_G", k]) is not None}
        return LLFlowVQGAN2(**mini, **kw)
    raise NotImplementedError(f"Generator model [{which_model}] not recognized")


def find_vqgan(opt):
    cfg = opt.get("network_VQGAN") or {}
    t = cfg.get("type") or "VQModel"
    if t != "VQModel":
        raise NotImplementedError(f"VQGAN type [{t}] not recognized")
    return VQModel(
        resolution=cfg.get("resolution") or 256,
        n_embed=cfg.get("n_embed") or 8192,
        embed_dim=cfg.get("embed_dim") or 3,
        z_channels=cfg.get("z_channels") or 3,
        in_channels=cfg.get("in_channels") or 3,
        out_ch=cfg.get("out_ch") or 3,
        ch=cfg.get("ch") or 128,
        ch_mult=tuple(cfg.get("ch_mult") or (1, 2, 4)),
        num_res_blocks=cfg.get("num_res_blocks") or 2,
        attn_resolutions=tuple(cfg.get("attn_resolutions") or (64,)),
    )
