"""Stage-3 training in the port against the JAX package's, on the CPU.

The slice as a whole: two train steps of the port's ``VQLLFLOWDModel`` against
the JAX model's own jitted ``_train_step_fn`` with the same carried weights and
batches. The JAX side is built through ``VQLLFLOWDModel.__new__`` with the mini
modules, ``PerceptualNetwork(params=...)`` and ``_build_optimizer``, so no JAX
code is copied here; its gradients are read back from optax's first Adam
moment (``mu_1 = (1 - b1) g_1``, ``mu_2 = b1 mu_1 + (1 - b1) g_2``).

Small configuration: the mini config of tests/test_torch_stage3.py (ch 32, one
res-block per level, K 2, L 1, n_embed 64) at 32x32, batch 2, float32,
``dcn_impl`` chain at radius 2 with tempered ``conv_offset`` heads (offsets off
the integer grid, some beyond 2 px; see below), warmup 10: the first update is exactly 0
and the second is 0.1 lr, as optax applies ``schedule(count)`` from count 0.

Conditioning, two places where float32 rounding would decide the result:
  * The DCNv2 offset derivative jumps at integer sample positions (the floor
    moves to the next corner). An offset that rounding puts on the two sides of
    an integer in the two packages (seen: 1.0000015 against 0.9999985) changes
    that pixel's offset gradient by O(1). So the ``conv_offset`` heads give
    offsets of a half-integer bias in [-2.5, 2.5] (the +-2.5 ones beyond the
    clamp, zero gradient) plus an input-dependent part of a few hundredths, and
    the port checks that every offset of both steps stays 0.02 px off the grid.
  * The AFT decoder adds ``x_vq * mean(h) / mean(x_vq)``, whose gradient carries
    ``mean(h) / mean(x_vq)^2``; with seeded weights the DCN output has mean ~0
    (warp_0: -0.009 at std 0.99), which amplifies rounding a hundredfold in
    either package. The DCN biases are shifted by +1: mean(x_vq) near 1.

Tolerances: losses 1e-4 relative; the trainable gradients, the Adam moments and
the parameters after step 2 within 1e-3 of each tensor's largest magnitude;
the step-2 update within 1e-2 of its norm over all trainable tensors (Adam
divides by sqrt(v), so elements whose gradient is rounding noise move by up to
lr either way). Both sides are float32; the graph is ~60 convolutions, two
DCNs, the VGG and MS-SSIM, and rounding differences of 1e-6 grow along it.

bf16 (``train.mixed_precision``): JAX's bf16 step (the generator and the VQ
model with ``dtype=bfloat16``, one more jit) and the port's, two steps each on
the same weights and batches, are both held to JAX's float32 steps: the port's
may be at most 1.25x as far as JAX's, + 1e-3 (the stage-ratio rule of PERF.md
section 2; see the test). The port keeps float32 parameters and Adam moments.

Also here: the schedules, MS-SSIM, the perceptual loss, the GLARE_GN_BF16
group norm against JAX, and the training CLI on a synthetic image folder.
"""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from glare_tpu.models.lr_scheduler import build_schedule as jax_build_schedule
from glare_tpu.models.vqllflowd_model import VQLLFLOWDModel as JModel
from glare_tpu.modules.losses import PerceptualNetwork as JPerceptual
from glare_tpu.modules.losses import VGG16Features as JVGG
from glare_tpu.modules.msssim import msssim as jax_msssim
from glare_tpu.modules.vqllflow_deformable import VQLLFLOWDeformable as JNet
from glare_tpu.modules.vqmodel import VQModel as JVQModel
from glare_tpu_torch import convert
from glare_tpu_torch.models import create_model
from glare_tpu_torch.models.lr_scheduler import build_schedule
from glare_tpu_torch.modules.losses import PerceptualNetwork
from glare_tpu_torch.modules.msssim import msssim

from torch_port_util import fill_tree

MINI = dict(enc_ch=32, decoder_ch=32, enc_num_res_blocks=1, dec_num_res_blocks=1)
VQ = dict(ch=32, n_embed=64, num_res_blocks=1)
TRAIN = {"manual_seed": 1, "lr_G": 5e-5, "weight_decay_G": 0, "beta1": 0.9, "beta2": 0.99,
         "lr_scheme": "MultiStepLR", "warmup_iter": 10, "lr_steps": [20, 30], "lr_gamma": 0.5}
B1 = TRAIN["beta1"]
# XLA's CPU backend without its expensive passes: the same function, compiled in
# about two thirds of the time (the jit is compiled once here and dominates)
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def _opt():
    return {
        "model": "VQLLFLOWD", "is_train": True,
        "network_G": {"which_model_G": "VQLLFLOWDeformable", "dcn_max_offset": 2,
                      "flow": {"K": 2, "L": 1, "additionalFlowNoAffine": 2}, **MINI},
        "network_VQGAN": {"type": "VQModel", **VQ},
        "train": dict(TRAIN),
    }


def _batches(rng):
    out = []
    for _ in range(2):
        lq = np.log(np.clip(rng.uniform(0, 0.2, (2, 32, 32, 3)) + 1e-3, 1e-3, None))
        gt = np.clip(np.exp(lq) * 4 + 0.05 * rng.standard_normal(lq.shape), 0, 1)
        out.append((lq.astype(np.float32), gt.astype(np.float32)))
    return out


def _adam_mu(opt_state):
    """The trainable leaves' first moment (frozen subtrees are optax MaskedNodes)."""
    return opt_state.inner_states["train"].inner_state[0].mu


def _torch_named(tree, params):
    """A deformable_decoder-shaped flax tree -> {torch name: tensor} of the AFT
    decoder (the frozen subtrees are filled from ``params`` to satisfy the
    converter and dropped)."""
    full = {**params, "deformable_decoder": tree}
    return {k: v for k, v in convert.flax_to_torch_stage3(full).items()
            if k.startswith("deformable_decoder.")}


def _jax_model(net_p, vq_p, vgg_p, dtype=None):
    """The JAX model through ``VQLLFLOWDModel.__new__``: the mini generator and
    VQ model (compute ``dtype``, as ``glare_tpu/models/vqllflowd_model.py:60-64``
    builds them), the given weights, ``_build_optimizer``."""
    net = JNet(K=2, L=1, additional_flow_no_affine=2, dcn_impl="chain", dcn_max_offset=2,
               dtype=dtype, **MINI)
    vq = JVQModel(vq_backend="ref", dtype=dtype, **VQ)
    jm = JModel.__new__(JModel)
    jm.netG, jm.net_hq, jm.mesh, jm._jit_cache = net, vq, None, {}
    jm.params = jax.tree.map(jnp.asarray, net_p)
    jm.vq_variables = {"params": jax.tree.map(jnp.asarray, vq_p)}
    jm.perceptual = JPerceptual(params={"params": jax.tree.map(jnp.asarray, vgg_p)})
    jm._build_optimizer(TRAIN)
    return jm


def _jax_step(jm, batch):
    """The jitted ``_train_step_fn`` compiled with the fast options."""
    args = (jm.params, jm.opt_state, jm.vq_variables) + tuple(map(jnp.asarray, batch))
    return jm._train_step_fn().lower(*args).compile(compiler_options=FAST_COMPILE)


@pytest.fixture(scope="module")
def jax_run():
    """Two JAX train steps (one jit, shared by every case here)."""
    rng = np.random.default_rng(11)
    batches = _batches(rng)
    net = JNet(K=2, L=1, additional_flow_no_affine=2, dcn_impl="chain", dcn_max_offset=2, **MINI)
    vq = JVQModel(vq_backend="ref", **VQ)
    x = jnp.asarray(batches[0][0])

    def shapes():
        key = jax.random.PRNGKey(0)
        vq_p = vq.init(key, x)["params"]
        lat_p = net.init(key, x, method=JNet.latent_half)["params"]
        x0, enc0 = net.apply({"params": lat_p}, x, method=JNet.latent_half)
        _, _, code0 = vq.apply({"params": vq_p}, x0, method=JVQModel.decode)
        aft_p = net.init(key, x0, code0, enc0["mid_feat"], method=JNet.aft_half)["params"]
        vgg_p = JVGG().init(key, jnp.zeros((1, 32, 32, 3)))["params"]
        return vq_p, {**lat_p, **aft_p}, vgg_p

    vq_s, net_s, vgg_s = jax.eval_shape(shapes)
    vq_p, net_p, vgg_p = fill_tree(vq_s, rng), fill_tree(net_s, rng), fill_tree(vgg_s, rng)
    vq_p["quantize"]["embedding"] = (0.5 * rng.standard_normal((64, 3))).astype(np.float32)
    for w in range(2):  # see the module docstring
        dcn = net_p["deformable_decoder"][f"warp_{w}"]["dcn"]
        dcn["bias"] += np.float32(1.0)
        # offsets = a half-integer bias in [-2.5, 2.5] + a small input-dependent part
        # (JAX channel order [dy(G*K) | dx(G*K) | mask(G*K)])
        dcn["conv_offset"]["kernel"] *= np.float32(0.05)
        dcn["conv_offset"]["bias"][:72] = rng.integers(-3, 3, 72) + np.float32(0.5)

    jm = _jax_model(net_p, vq_p, vgg_p)
    step = _jax_step(jm, batches[0])
    params, opt_state, losses, mus = jm.params, jm.opt_state, [], []
    for lq, gt in batches:
        params, opt_state, total, parts = step(params, opt_state, jm.vq_variables,
                                               jnp.asarray(lq), jnp.asarray(gt))
        losses.append([float(total)] + [float(p) for p in parts])
        mus.append(jax.tree.map(np.asarray, _adam_mu(opt_state)["deformable_decoder"]))
    grads = [jax.tree.map(lambda m: m / (1 - B1), mus[0]),
             jax.tree.map(lambda m2, m1: (m2 - B1 * m1) / (1 - B1), mus[1], mus[0])]
    return {"net_p": net_p, "vq_p": vq_p, "vgg_p": vgg_p, "batches": batches, "losses": losses,
            "grads": [_torch_named(g, net_p) for g in grads], "mu2": _torch_named(mus[1], net_p),
            "params2": _torch_named(jax.tree.map(np.asarray, params["deformable_decoder"]), net_p)}


@pytest.fixture(scope="module")
def port_run(jax_run):
    model = create_model(_opt(), device="cpu")
    model.load_state_dicts(convert.flax_to_torch_stage3(jax_run["net_p"]),
                           convert.flax_to_torch_vqgan(jax_run["vq_p"]))
    model.perceptual = PerceptualNetwork(params=convert.flax_to_torch_vgg16(jax_run["vgg_p"]))
    frozen0 = {n: p.detach().clone() for n, p in model.netG.named_parameters()
               if not p.requires_grad}
    p0 = {n: p.detach().clone() for n, p in model.trainable_parameters()}
    packs = [w.dcn for w in model.netG.deformable_decoder.warp]
    losses, grads, params, grid_gap = [], [], [], []
    for lq, gt in jax_run["batches"]:
        for pack in packs:
            pack.audit_offsets = True
        losses.append(list(model.optimize_parameters({"LQ": lq, "GT": gt}, None)))
        for pack in packs:  # distance of every offset from the integer grid
            off = pack.last_offsets.detach()
            grid_gap.append(float((off - off.round()).abs().min()))
            pack.audit_offsets, pack.last_offsets = False, None
        grads.append({n: p.grad.detach().clone() for n, p in model.trainable_parameters()})
        params.append({n: p.detach().clone() for n, p in model.trainable_parameters()})
    return {"model": model, "losses": losses, "grads": grads, "params": params, "p0": p0,
            "frozen0": frozen0, "grid_gap": grid_gap}


@pytest.mark.parametrize("is_train", [True, False])
@pytest.mark.parametrize("remat", ["absent", True, False])
def test_define_flow_reads_remat_as_jax_does(is_train, remat):
    """``network_G.remat`` and its default (on when training with a DCN other than
    the chain op), against JAX's ``define_Flow`` (flax modules constructed only)."""
    from glare_tpu.models.networks import define_Flow as jax_define_flow
    from glare_tpu_torch.models.networks import define_Flow

    for dcn_impl in (None, "chain", "xla", "pallas"):
        net_g = {"which_model_G": "VQLLFLOWDeformable", "flow": {"K": 1, "L": 1}, **MINI}
        if dcn_impl is not None:
            net_g["dcn_impl"] = dcn_impl
        if remat != "absent":
            net_g["remat"] = remat
        opt = {"is_train": is_train, "network_G": net_g}
        want = jax_define_flow(opt).remat
        got = define_Flow(opt).deformable_decoder.remat
        assert got == want, (dcn_impl, got, want)
        if remat == "absent":
            assert want == (is_train and dcn_impl not in (None, "chain"))


def test_remat_step_equals_the_plain_step(jax_run, port_run, monkeypatch):
    """A step with ``network_G.remat`` (every ResnetBlock, AttnBlock and WarpBlock
    of the AFT decoder recomputed in the backward) gives the first step's losses
    and gradients of the plain model (``port_run``) on the CPU."""
    from glare_tpu_torch.modules import deformable_decoder as dd
    from glare_tpu_torch.nn.layers import AttnBlock, ResnetBlock

    wrapped = []
    checkpoint = dd.checkpoint
    monkeypatch.setattr(dd, "checkpoint", lambda block, *a, **k: wrapped.append(type(block)) or
                        checkpoint(block, *a, **k))
    opt = _opt()
    opt["network_G"]["remat"] = True
    model = create_model(opt, device="cpu")
    assert model.netG.deformable_decoder.remat
    model.load_state_dicts(convert.flax_to_torch_stage3(jax_run["net_p"]),
                           convert.flax_to_torch_vqgan(jax_run["vq_p"]))
    model.perceptual = port_run["model"].perceptual
    lq, gt = jax_run["batches"][0]
    losses = list(model.optimize_parameters({"LQ": lq, "GT": gt}, None))
    blocks = [type(m) for m in model.netG.deformable_decoder.modules()
              if isinstance(m, (ResnetBlock, AttnBlock, dd.WarpBlock))]
    assert sorted(map(str, wrapped)) == sorted(map(str, blocks)) and AttnBlock in wrapped
    np.testing.assert_allclose(losses, port_run["losses"][0], rtol=1e-6, atol=0)
    for n, p in model.trainable_parameters():
        want = port_run["grads"][0][n]
        assert float((p.grad - want).abs().max()) <= 1e-6 * max(float(want.abs().max()), 1e-30), n


def _max_rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def test_two_steps_losses_match_jax(jax_run, port_run):
    # the port returns (total, percep, l1, ssim), JAX (total, (l1, percep, ssim))
    for k in range(2):
        t, pc, l1, ss = port_run["losses"][k]
        jt, jl1, jpc, jss = jax_run["losses"][k]
        for got, want in ((t, jt), (l1, jl1), (pc, jpc), (ss, jss)):
            assert abs(got - want) <= 1e-4 * abs(want), (k, got, want)
    # the first update is exactly zero (warmup from count 0); the second is not
    assert port_run["losses"][1][0] != port_run["losses"][0][0]
    model = port_run["model"]
    assert model.updates == 2
    for n, p in port_run["params"][0].items():
        assert torch.equal(p, port_run["p0"][n]), n


def _close_or_vanishing(got, want, top, what, tol=1e-3):
    """Within ``tol`` of the tensor's largest magnitude; a tensor whose JAX value is
    below 1e-6 of ``top`` (the largest of its kind) is one that vanishes in exact
    arithmetic and holds rounding noise on both sides: it must vanish on the
    port's side too. (The key bias of an attention block: softmax ignores a
    constant shift of the scores; a conv bias straight before a group norm of
    one channel a group.)"""
    g, w = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if np.abs(w).max() <= 1e-6 * top:
        assert np.abs(g).max() <= 1e-6 * top, what
    else:
        assert np.abs(g - w).max() <= tol * np.abs(w).max(), what


def test_two_steps_gradients_match_jax(jax_run, port_run):
    # the precondition of the comparison: no offset near the integer grid
    assert min(port_run["grid_gap"]) > 0.02, port_run["grid_gap"]
    for k in range(2):
        want, got = jax_run["grads"][k], port_run["grads"][k]
        assert set(got) == set(want)
        top = max(float(np.abs(w.numpy()).max()) for w in want.values())
        assert top > 0
        for n in want:
            _close_or_vanishing(got[n].numpy(), want[n].numpy(), top, (k, n))


def test_optimizer_state_and_parameters_after_step_two(jax_run, port_run):
    model = port_run["model"]
    named = dict(model.trainable_parameters())
    top = max(float(np.abs(m.numpy()).max()) for m in jax_run["mu2"].values())
    for n, p in named.items():
        assert _max_rel(p.detach().numpy(), jax_run["params2"][n].numpy()) <= 1e-3, n
        _close_or_vanishing(model.optimizer.state[p]["exp_avg"].numpy(),
                            jax_run["mu2"][n].numpy(), top, n)
    d_port = torch.cat([(port_run["params"][1][n] - port_run["p0"][n]).flatten() for n in named])
    d_jax = torch.cat([(jax_run["params2"][n] - port_run["p0"][n]).flatten() for n in named])
    assert float(d_jax.norm()) > 0
    assert float((d_port - d_jax).norm() / d_jax.norm()) <= 1e-2
    # the frozen sub-networks are bit-equal after the steps
    for n, p in model.netG.named_parameters():
        if n.split(".", 1)[0] in ("RRDB", "flowUpsamplerNet"):
            assert not p.requires_grad and torch.equal(p, port_run["frozen0"][n]), n
    assert all(not p.requires_grad for p in model.net_hq.parameters())


# The bf16 steps (train.mixed_precision), held to JAX's float32 steps above.
BF16_RATIO, BF16_SLACK = 1.25, 1e-3


@pytest.fixture(scope="module")
def bf16_run(jax_run):
    """``train.mixed_precision``: JAX's bf16 ``_train_step_fn`` (one more jit) and
    the port's bf16 ``optimize_parameters``, two steps each on the float32
    fixture's weights and batches. The first update is exactly 0 (warmup from
    count 0), so both steps of each run are taken at the same weights: two
    gradients of the same function, as in the float32 fixture."""
    jm = _jax_model(jax_run["net_p"], jax_run["vq_p"], jax_run["vgg_p"], dtype=jnp.bfloat16)
    step = _jax_step(jm, jax_run["batches"][0])
    params, opt_state, jlosses, mus = jm.params, jm.opt_state, [], []
    for lq, gt in jax_run["batches"]:
        params, opt_state, total, parts = step(params, opt_state, jm.vq_variables,
                                               jnp.asarray(lq), jnp.asarray(gt))
        jlosses.append([float(total)] + [float(p) for p in parts])
        mus.append(jax.tree.map(np.asarray, _adam_mu(opt_state)["deformable_decoder"]))
    jgrads = [jax.tree.map(lambda m: m / (1 - B1), mus[0]),
              jax.tree.map(lambda m2, m1: (m2 - B1 * m1) / (1 - B1), mus[1], mus[0])]

    opt = _opt()
    opt["train"]["mixed_precision"] = True
    model = create_model(opt, device="cpu")
    model.load_state_dicts(convert.flax_to_torch_stage3(jax_run["net_p"]),
                           convert.flax_to_torch_vqgan(jax_run["vq_p"]))
    model.perceptual = PerceptualNetwork(params=convert.flax_to_torch_vgg16(jax_run["vgg_p"]))
    packs = [w.dcn for w in model.netG.deformable_decoder.warp]
    losses, grads, grid_gap = [], [], []
    for lq, gt in jax_run["batches"]:
        for pack in packs:
            pack.audit_offsets = True
        losses.append(list(model.optimize_parameters({"LQ": lq, "GT": gt}, None)))
        for pack in packs:  # distance of every (bf16-computed) offset from the integer grid
            off = pack.last_offsets.detach()
            grid_gap.append(float((off - off.round()).abs().min()))
            pack.audit_offsets, pack.last_offsets = False, None
        grads.append({n: p.grad.detach().clone() for n, p in model.trainable_parameters()})
    return {"model": model, "losses": losses, "grads": grads, "grid_gap": grid_gap,
            "jax_losses": jlosses, "jax_grads": [_torch_named(g, jax_run["net_p"]) for g in jgrads]}


def test_bf16_steps_match_jax_bf16_by_the_ratio_rule(jax_run, bf16_run):
    """The port's bf16 step may be at most 1.25x as far from JAX's float32 step as
    JAX's bf16 step is, + 1e-3 (the stage-ratio rule of PERF.md section 2): the
    losses of each step (relative), and each trainable gradient (relative RMS,
    pooled over the two steps at the same weights). Two bf16 runs are equally
    right and round at other places (the port's DCN rounds its column once and
    its weight to bf16, JAX's chain op sums the column in bf16 and keeps a
    float32 weight; flax adds a conv bias after rounding the product), so where
    bf16 noise dominates a gradient, one step's distances are two samples of it:
    at this size they reach 10-60% relative RMS, and for one small tensor one
    step's ratio alone was 1.66 with the other step's 0.8. Pooling the two steps
    halves that spread. A gradient that vanishes in float32 (below 1e-6 of the
    step's largest: attention key biases, a conv bias before a one-channel-a-group
    norm) is measured in units of the step's largest gradient instead."""
    # the precondition, as in float32: no offset near the integer grid
    assert min(bf16_run["grid_gap"]) > 0.02, bf16_run["grid_gap"]
    # the port returns (total, percep, l1, ssim), JAX (total, (l1, percep, ssim))
    for k in range(2):
        t, pc, l1, ss = bf16_run["losses"][k]
        for got, jb, want in zip((t, l1, pc, ss), bf16_run["jax_losses"][k], jax_run["losses"][k]):
            assert abs(got - want) <= BF16_RATIO * abs(jb - want) + BF16_SLACK * abs(want), (k, got, jb, want)
    ref = jax_run["grads"]
    top = max(float(np.abs(g.numpy()).max()) for g in ref[0].values())
    assert set(bf16_run["grads"][0]) == set(ref[0])
    for n in ref[0]:
        f = [ref[k][n].numpy().astype(np.float64) for k in range(2)]
        scale = np.sqrt(sum((fk ** 2).sum() for fk in f))
        if max(np.abs(fk).max() for fk in f) <= 1e-6 * top:   # vanishes in exact arithmetic
            scale = top * np.sqrt(sum(fk.size for fk in f))

        def dist(run, n=n, f=f, scale=scale):
            return np.sqrt(sum(((run[k][n].numpy().astype(np.float64) - f[k]) ** 2).sum()
                               for k in range(2))) / scale

        d_port, d_jax = dist(bf16_run["grads"]), dist(bf16_run["jax_grads"])
        assert d_port <= BF16_RATIO * d_jax + BF16_SLACK, (n, d_port, d_jax)


def test_bf16_step_keeps_float32_master_weights(bf16_run):
    """Parameters, gradients and Adam moments float32 after the bf16 steps; the
    convolutions compute in bf16, the flow and the VQGAN's codebook stay float32;
    the first update is exactly zero, the second moves the weights."""
    model = bf16_run["model"]
    assert model.dtype == torch.bfloat16 and model.updates == 2
    assert all(p.dtype == torch.float32 for p in model.netG.parameters())
    for _, p in model.trainable_parameters():
        assert p.grad.dtype == torch.float32
        state = model.optimizer.state[p]
        assert state["exp_avg"].dtype == state["exp_avg_sq"].dtype == torch.float32
    dec, enc = model.netG.deformable_decoder, model.netG.RRDB
    assert dec.conv_in.dtype == enc.color_conv.dtype == torch.bfloat16
    assert dec.conv_in.weight.dtype == torch.float32
    assert model.net_hq.quantize.embedding.weight.dtype == torch.float32
    assert all(not isinstance(m, torch.nn.Conv2d) or m.weight.dtype == torch.float32
               for m in model.netG.flowUpsamplerNet.modules())
    assert bf16_run["losses"][1][0] != bf16_run["losses"][0][0]
    sd = model.netG.state_dict()
    assert all(v.dtype == torch.float32 for v in sd.values() if v.is_floating_point())


@pytest.mark.parametrize("conf", [
    dict(TRAIN),
    dict(TRAIN, warmup_iter=-1, restarts=[15], restart_weights=[0.5]),
    {"lr_G": 2e-4, "lr_scheme": "CosineAnnealingLR_Restart", "T_period": [10, 10, 10],
     "restarts": [10, 20], "restart_weights": [1.0, 0.5], "eta_min": 1e-7, "warmup_iter": 3},
])
def test_schedule_matches_jax(conf):
    """The schedule as a pure function of the update count. 1e-5 relative: the
    JAX side computes in float32 (the cosine of a float32 phase), the port in
    float64."""
    ours, theirs = build_schedule(conf), jax_build_schedule(conf)
    for k in range(35):
        assert ours(k) == pytest.approx(float(theirs(k)), rel=1e-5, abs=1e-12), k
    if conf.get("warmup_iter", -1) > 0:
        assert ours(0) == 0.0


def test_msssim_and_perceptual_match_jax():
    """Tolerance 1e-5 relative: float32 window convolutions and VGG on both sides."""
    rng = np.random.default_rng(3)
    a = rng.uniform(0, 1, (2, 40, 36, 3)).astype(np.float32)
    b = np.clip(a + 0.1 * rng.standard_normal(a.shape), 0, 1).astype(np.float32)
    for norm in (True, False):
        want = float(jax_msssim(jnp.asarray(a), jnp.asarray(b), normalize=norm))
        got = float(msssim(torch.tensor(a), torch.tensor(b), normalize=norm))
        assert got == pytest.approx(want, rel=1e-5)
    vgg_p = fill_tree(jax.eval_shape(lambda: JVGG().init(jax.random.PRNGKey(0),
                                                         jnp.zeros((1, 32, 32, 3))))["params"], rng)
    want = float(JPerceptual(params={"params": vgg_p})(jnp.asarray(a), jnp.asarray(b)))
    got = float(PerceptualNetwork(params=convert.flax_to_torch_vgg16(vgg_p))(torch.tensor(a),
                                                                             torch.tensor(b)))
    assert got == pytest.approx(want, rel=1e-5)


def test_load_vgg16_params_takes_the_jax_rng_seed(monkeypatch):
    """``rng_seed`` is the JAX name of ``seed``; ``features(x=)`` the JAX keyword."""
    from glare_tpu_torch.modules import losses

    monkeypatch.delenv("GLARE_VGG16_NPZ", raising=False)
    monkeypatch.setattr(losses, "probe_torch_vgg16_cache", lambda: None)
    with pytest.warns(UserWarning, match="RANDOM VGG"):
        by_jax_name, source = losses.load_vgg16_params(rng_seed=3, return_source=True)
        by_port_name = losses.load_vgg16_params(seed=3)
        other = losses.load_vgg16_params(rng_seed=4)
    assert source == "random" and by_jax_name.keys() == by_port_name.keys()
    assert all(torch.equal(by_jax_name[k], by_port_name[k]) for k in by_jax_name)
    assert not torch.equal(by_jax_name["convs.0.weight"], other["convs.0.weight"])
    with pytest.raises(ValueError, match="not both"):
        losses.load_vgg16_params(seed=1, rng_seed=2)
    net = PerceptualNetwork(params=by_jax_name)
    x = torch.rand(1, 16, 16, 3)
    assert all(torch.equal(a, b) for a, b in zip(net.features(x=x), net.features(x)))


def test_groupnorm_bf16_io_matches_jax(monkeypatch):
    """GLARE_GN_BF16=1 on bf16 input: float32 statistics, a bf16 result. Both
    round the same float32 value to bf16, so they may differ by one bf16 ulp
    (2^-8 relative) where the two float32 sums differ in the last bit."""
    from glare_tpu.nn.layers import GroupNorm32 as JGN
    from glare_tpu_torch.nn.layers import GroupNorm32

    monkeypatch.setenv("GLARE_GN_BF16", "1")
    rng = np.random.default_rng(5)
    x = jnp.asarray((3 * rng.standard_normal((2, 9, 11, 64)) + 1).astype(np.float32), jnp.bfloat16)
    scale = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(64)).astype(np.float32)
    jy = JGN().apply({"params": {"GroupNorm_0": {"scale": scale, "bias": bias}}}, x)
    gn = GroupNorm32(64)
    assert gn.bf16_io
    gn.load_state_dict({"weight": torch.tensor(scale), "bias": torch.tensor(bias)})
    with torch.no_grad():
        ty = gn(torch.tensor(np.asarray(x.astype(jnp.float32))).to(torch.bfloat16).permute(0, 3, 1, 2))
    assert jy.dtype == jnp.bfloat16 and ty.dtype == torch.bfloat16
    want = np.asarray(jy.astype(jnp.float32))
    got = ty.float().permute(0, 2, 3, 1).numpy()
    assert np.abs(got - want).max() <= 2.0 ** -8 * np.abs(want).max()
    monkeypatch.setenv("GLARE_GN_BF16", "0")
    assert not GroupNorm32(64).bf16_io
    assert GroupNorm32(64, bf16_io=True).bf16_io   # the JAX module's field beats the variable


def _write_folder(root, names, rng, size=48):
    import cv2

    for sub in ("low", "high"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    for n in names:
        hi = (rng.uniform(0.2, 1.0, (size, size + 8, 3)) * 255).astype(np.uint8)
        cv2.imwrite(os.path.join(root, "high", n), hi)
        cv2.imwrite(os.path.join(root, "low", n), (hi * 0.1).astype(np.uint8))


class _Writer:
    """A tensorboard writer that records (tag, step, value)."""

    def __init__(self, log_dir=None):
        self.log_dir, self.scalars, self.closed = log_dir, [], False

    def add_scalar(self, tag, value, step):
        self.scalars.append((tag, int(step), float(value)))

    def close(self):
        self.closed = True


class _JaxStubModel:
    """What ``glare_tpu/cli/train.py`` calls on a stage-3 model, with the JAX
    model's loss names (``VQLLFLOWDModel.optimize_parameters``): the JAX loop's
    tensorboard tags and steps without a JAX training step."""

    def __init__(self, opt):
        self.log_dict = {}

    def optimize_parameters(self, feed, step):
        self.log_dict = {"total_loss": 1.0, "l1_loss": 0.1, "percep_loss": 0.2, "ssim_loss": 0.3}

    def get_current_log(self):
        return self.log_dict

    def schedule(self, step):
        return 5e-5

    def get_sr(self, lq):
        return np.clip(np.exp(np.asarray(lq)) * 4, 0, 1)

    def save(self, label):
        pass

    def save_training(self, epoch, step):
        pass


def _jax_loop_scalars(conf, root, monkeypatch):
    """The JAX training loop on ``conf`` with :class:`_JaxStubModel` and a stub
    ``tensorboardX`` -> its (tag, step) pairs."""
    import sys
    import types

    from glare_tpu.cli import train as jtrain

    writers = []
    tbx = types.ModuleType("tensorboardX")
    tbx.SummaryWriter = lambda log_dir: writers.append(_Writer(log_dir)) or writers[-1]
    monkeypatch.setitem(sys.modules, "tensorboardX", tbx)
    monkeypatch.setattr(jtrain, "create_model", _JaxStubModel)
    monkeypatch.setenv("GLARE_ROOT", str(root))
    jtrain.main(stage=3, argv=["--opt", str(conf), "--niter", "2"])
    assert len(writers) == 1 and writers[0].log_dir.endswith(os.path.join("tstage3_jax", "tb_logger"))
    return [(tag, step) for tag, step, _ in writers[0].scalars]


def test_cli_trains_checkpoints_and_resumes(tmp_path, monkeypatch):
    """cli.train --device cpu --niter 2 on a synthetic LOL folder (mini network,
    32 px crops): 2_G.pth and 2.state; the inference CLI's loader takes the .pth;
    a resume restores the step and the optimizer. With ``use_tb_logger`` (a stub
    writer) it writes the JAX loop's tags at the JAX loop's steps (that loop run
    on the same conf with a stub model)."""
    from glare_tpu_torch.cli import infer_paired, train

    rng = np.random.default_rng(9)
    _write_folder(str(tmp_path / "LOLdataset" / "our485"), ["1.png", "2.png", "3.png", "4.png"], rng)
    _write_folder(str(tmp_path / "LOLdataset" / "eval15"), ["5.png"], rng)
    opt = _opt()
    del opt["is_train"]
    opt.update({
        "name": "tstage3_torch", "dataset": "LoL", "scale": 1,
        "datasets": {
            "train": {"root": str(tmp_path / "LOLdataset"), "batch_size": 2, "use_resize_crop": True,
                      "use_flip": True, "use_rot": True, "GT_size": 32, "log_low": True, "quant": 32},
            "val": {"root": str(tmp_path / "LOLdataset"), "split": 0, "log_low": True, "quant": 32}},
        "path": {"resume_state": "auto"},
        "logger": {"print_freq": 1, "save_checkpoint_freq": 2},
    })
    opt["train"].update({"niter": 40000, "val_freq": 2, "lr_steps_rel": [0.5, 0.75]})
    opt["use_tb_logger"] = True
    jax_conf = tmp_path / "train_jax.yml"
    jax_conf.write_text(yaml.safe_dump({**opt, "name": "tstage3_jax"}))
    want = _jax_loop_scalars(jax_conf, tmp_path / "jax", monkeypatch)
    conf = tmp_path / "train.yml"
    conf.write_text(yaml.safe_dump(opt))
    monkeypatch.setenv("GLARE_ROOT", str(tmp_path))
    writers = []
    monkeypatch.setattr(train, "init_tb_logger", lambda log_dir: writers.append(_Writer(log_dir)) or writers[-1])
    model, step = train.main(argv=["--opt", str(conf), "--niter", "2", "--device", "cpu"])
    root = tmp_path / "experiments" / "tstage3_torch"
    assert step == 2 and model.updates == 2
    assert len(writers) == 1 and writers[0].log_dir == str(root / "tb_logger") and writers[0].closed
    got = writers[0].scalars
    assert [(tag, s) for tag, s, _ in got] == want, (got, want)
    assert {t for t, _ in want} == {"loss/total_loss", "loss/l1_loss", "loss/percep_loss", "loss/ssim_loss",
                                   "lr", "time/iteration", "time/data", "eta_h", "val/psnr"}
    assert all(np.isfinite(v) for _, _, v in got) and all(v >= 0 for t, _, v in got if t.startswith("time/"))
    assert [v for t, s, v in got if t == "lr"] == [model.schedule(1), model.schedule(2)]
    assert all(np.isfinite(v) for v in model.get_current_log().values())
    assert (root / "models" / "2_G.pth").exists() and (root / "training_state" / "2.state").exists()
    assert glob.glob(str(root / "models" / "best_psnr_2_G.pth"))

    infer = {**opt, "model_path": str(root / "models" / "2_G.pth"), "network_G": {
        **opt["network_G"], "dcn_impl": "xla"}}
    infer_conf = tmp_path / "infer.yml"
    infer_conf.write_text(yaml.safe_dump(infer))
    loaded, _ = infer_paired.load_model(str(infer_conf), device="cpu")
    for n, p in model.netG.state_dict().items():
        assert torch.equal(loaded.netG.state_dict()[n], p), n

    fresh = create_model({**_opt(), "train": dict(TRAIN)}, device="cpu")
    epoch, it = fresh.resume_training(str(root / "training_state" / "2.state"))
    assert it == 2 and fresh.updates == 2
    for n, p in fresh.trainable_parameters():
        assert torch.equal(p, model.netG.get_parameter(n)), n

    # a second run of the same conf resumes from 2.state and stops at once
    _, step2 = train.main(argv=["--opt", str(conf), "--niter", "2", "--device", "cpu"])
    assert step2 == 2
    # --stage 2 trains the stage-2 model (tests/test_torch_train_stage2.py), not this conf's
    with pytest.raises(ValueError, match="--stage 2 trains model 'LLFlow'"):
        train.main(argv=["--stage", "2", "--opt", str(conf), "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="glare_tpu_torch.sr.train"):
        train.main(argv=["--stage", "1", "--opt", str(conf), "--device", "cpu"])
