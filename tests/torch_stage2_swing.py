"""The stage-2 NLL after the first updates, the port against the JAX package, on the CPU.

    env JAX_PLATFORMS=cpu python tests/torch_stage2_swing.py [--width 64] [--size 64]

The setting of ``chip_smoke.py``'s ``train_stage2_path``, cut in width for the CPU:
``confs/train_stage2_LOL.yml``'s flow depth (K 12, L 2) and schedule (lr 5e-4,
warmup 10, Adam (0.9, 0.99), weight_fl 1) and the port's seeded init (manual_seed
10), the conditional encoder and the VQGAN at ``--width`` channels (2 res blocks a
level, as the conf), ``--size`` crops, batch 4. Both packages start from the same
weights (the port's init, carried into the JAX package by ``tools/torch2flax.py``),
take the ActNorm init on batch 0 and four steps on batches 0-3; each step's loss is
the NLL of its batch before its update, beside each batch's NLL at the init's
weights. The first update is 0 (warmup from count 0), so step 2's loss is the first
batch seen after the first non-zero update.

Not a test: it prints the two packages' numbers and their relative gap (the CPU
tests' bar for a loss is 1e-4). The JAX step is compiled once (~25-35 s).
"""

import argparse
import os
import sys

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path[:0] = [ROOT, os.path.dirname(os.path.abspath(__file__))]

TRAIN = {"manual_seed": 10, "lr_G": 5e-4, "weight_decay_G": 0, "beta1": 0.9, "beta2": 0.99,
         "lr_scheme": "MultiStepLR", "warmup_iter": 10, "lr_gamma": 0.5, "niter": 80000,
         "lr_steps": [int(f * 80000) for f in (0.5, 0.75, 0.9, 0.95)], "weight_l1": 0, "weight_fl": 1}


def _opt(width, size):
    return {"model": "LLFlow", "is_train": True, "name": "stage2_swing",
            "datasets": {"train": {"quant": 32, "GT_size": size, "log_low": True}},
            "network_G": {"which_model_G": "LLFlowVQGAN2", "enc_ch": width, "enc_num_res_blocks": 2,
                          "flow": {"K": 12, "L": 2, "coupling": "CondAffineSeparatedAndCond",
                                   "additionalFlowNoAffine": 2, "split": {"enable": False}}},
            "network_VQGAN": {"type": "VQModel", "ch": width, "n_embed": 64, "num_res_blocks": 2},
            "train": dict(TRAIN), "path": {}}


def _batches(size, n=4, b=4, seed=90):
    import numpy as np

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        lq = np.log(np.clip(rng.uniform(0, 0.2, (b, size, size, 3)) + 1e-3, 1e-3, None)).astype(np.float32)
        out.append((lq, np.clip(np.exp(lq) * 5.0 + 0.05, 0.0, 1.0).astype(np.float32)))
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=64, help="encoder and VQGAN channels (the conf: 128)")
    ap.add_argument("--size", type=int, default=64, help="crop (the card's phase: 320)")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import numpy as np

    from glare_tpu.models.llflow_model import LLFlowModel as JModel
    from glare_tpu.modules.llflow_vqgan2 import LLFlowVQGAN2 as JLLFlow
    from glare_tpu.modules.vqmodel import VQModel as JVQModel
    from glare_tpu_torch import convert
    from glare_tpu_torch.models import create_model
    from test_torch_train import FAST_COMPILE
    from tools import torch2flax

    data = _batches(args.size)
    port = create_model(_opt(args.width, args.size), device="cpu")
    sd_g = {k: v.detach().clone().numpy() for k, v in port.netG.state_dict().items()}
    sd_vq = {k: v.detach().clone().numpy() for k, v in port.net_hq.state_dict().items()}
    net_p, vq_p = torch2flax.convert_stage2(sd_g), torch2flax.convert_vqgan(sd_vq)
    for back, sd in ((convert.flax_to_torch_stage2(net_p), sd_g), (convert.flax_to_torch_vqgan(vq_p), sd_vq)):
        if set(back) != set(sd) or not all(np.array_equal(back[k].numpy(), sd[k]) for k in sd):
            raise SystemExit("the weights do not carry across unchanged")

    lq0, gt0 = data[0]
    port.initialize_actnorm({"LQ": lq0, "GT": gt0})
    nll_init = {"port": [port.get_encode_nll(lq, gt) for lq, gt in data]}
    losses = {"port": [port.optimize_parameters({"LQ": lq, "GT": gt}) for lq, gt in data]}
    lrs = {"port": [port.schedule(k) for k in range(len(data))]}

    jm = JModel.__new__(JModel)
    jm.netG = JLLFlow(K=12, L=2, additional_flow_no_affine=2, enc_ch=args.width, enc_num_res_blocks=2)
    jm.net_hq = JVQModel(vq_backend="ref", ch=args.width, n_embed=64, num_res_blocks=2)
    jm.mesh, jm._jit_cache, jm.opt = None, {}, {"train": TRAIN}
    jm.params = jax.tree.map(jnp.asarray, net_p)
    jm.vq_variables = {"params": jax.tree.map(jnp.asarray, vq_p)}
    jm._actnorm_inited = False
    jm._build_optimizer(TRAIN)
    jm.initialize_actnorm({"LQ": jnp.asarray(lq0), "GT": jnp.asarray(gt0)})
    nll_init["jax"] = [jm.get_encode_nll(jnp.asarray(lq), jnp.asarray(gt)) for lq, gt in data]
    latents = [jm.encode_gt_latent(jnp.asarray(gt)) for _, gt in data]
    step = jm._train_step_fn().lower(jm.params, jm.opt_state, latents[0], jnp.asarray(lq0)).compile(
        compiler_options=FAST_COMPILE)
    params, opt_state, losses["jax"] = jm.params, jm.opt_state, []
    for (lq, _), lat in zip(data, latents):
        params, opt_state, loss = step(params, opt_state, lat, jnp.asarray(lq))
        losses["jax"].append(float(loss))
    lrs["jax"] = [float(jm.schedule(k)) for k in range(len(data))]

    print(f"width {args.width}, crop {args.size}, batch 4, K 12, L 2")
    for side in ("port", "jax"):
        print(f"{side:4s} lr by update {lrs[side]}")
        print(f"{side:4s} NLL at the init's weights   {nll_init[side]}")
        print(f"{side:4s} step losses (before update) {losses[side]}")
    print("relative gap per step", [abs(a - b) / abs(b) for a, b in zip(losses["port"], losses["jax"])])


if __name__ == "__main__":
    main()
