"""Stage-2 training in the port against the JAX package's, on the CPU.

The slice as a whole: the ActNorm data-dependent init and two train steps of the
port's ``LLFlowModel`` against the JAX model's own ``initialize_actnorm`` and
jitted ``_train_step_fn`` with the same carried weights and batches. The JAX side
is built through ``LLFlowModel.__new__`` with the mini modules and
``_build_optimizer``, so no JAX code is copied here; its gradients are read back
from optax's first Adam moment (``mu_1 = (1 - b1) g_1``,
``mu_2 = b1 mu_1 + (1 - b1) g_2``) of its two groups.

Small configuration: the mini config of tests/test_torch_stage2.py (encoder ch
32, one res-block per level, K 2, L 1, n_embed 64) at 32x32, batch 2, float32.
The schedule has no warmup, so both updates are non-zero. Its lr is small: Adam's
first update is lr * sign(g) for every element, also where the gradient is
float32 rounding noise (an attention key bias, a conv bias before a group norm of
one channel a group: the function does not depend on them), and there the two
packages may move by lr in opposite directions; at lr 2e-5 that stays under the
parameter tolerance.

Tolerances: the ActNorm statistics within 1e-5 of each tensor's largest
magnitude; losses 1e-4 relative; the gradients, both Adam moments and the
parameters after step 2 within 1e-3 of each tensor's largest magnitude (a
gradient or moment that vanishes in exact arithmetic must vanish on both sides).
Both sides are float32 and rounding differences of 1e-6 grow along ~30
convolutions and an 8-step flow.

Also here: ``add_gt_noise`` and ``squeeze2d`` / ``unsqueeze2d`` against JAX, the
model widened to float64 against its float32 run, and ``cli.train --stage 2`` on a synthetic image folder, its checkpoints through
``cli.test_stages --stage 2``.
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from glare_tpu.models.llflow_model import LLFlowModel as JModel
from glare_tpu.models.llflow_model import _label_params as jax_label_params
from glare_tpu.modules.flow_layers import squeeze2d as jax_squeeze2d
from glare_tpu.modules.flow_layers import unsqueeze2d as jax_unsqueeze2d
from glare_tpu.modules.llflow_vqgan2 import LLFlowVQGAN2 as JLLFlow
from glare_tpu.modules.vqmodel import VQModel as JVQModel
from glare_tpu_torch import convert
from glare_tpu_torch.models import create_model
from glare_tpu_torch.modules.flow_layers import ActNorm2d, SqueezeLayer, squeeze2d, unsqueeze2d

from test_torch_stage2 import MINI, VQ
from test_torch_stage2 import _opt as _opt_infer
from test_torch_train import FAST_COMPILE, _batches, _close_or_vanishing, _write_folder
from torch_port_util import fill_tree, nchw, nhwc

TRAIN = {"manual_seed": 1, "lr_G": 2e-5, "weight_decay_G": 1e-3, "beta1": 0.9, "beta2": 0.99,
         "lr_scheme": "MultiStepLR", "warmup_iter": -1, "lr_steps": [20, 30], "lr_gamma": 0.5,
         "weight_fl": 1, "weight_l1": 0}
B1, B2 = TRAIN["beta1"], TRAIN["beta2"]


def _opt():
    return {**_opt_infer(), "is_train": True, "train": dict(TRAIN)}


def _torch_named(tree):
    """A stage-2 flax tree -> {torch name: tensor}."""
    return convert.flax_to_torch_stage2(jax.tree.map(np.asarray, tree))


def _adam_moments(opt_state):
    """(mu, nu) of both optax groups merged into one stage-2 tree each (a group's
    state holds MaskedNodes where the other group's leaves are)."""
    out = []
    for field in ("mu", "nu"):
        flat = {}
        for group in opt_state.inner_states.values():
            for k, v in flax.traverse_util.flatten_dict(getattr(group.inner_state[0], field)).items():
                if isinstance(v, jax.Array):
                    flat[k] = v
        out.append(flax.traverse_util.unflatten_dict(flat))
    return out


@pytest.fixture(scope="module")
def jax_run():
    """The ActNorm init and two JAX train steps (one jit, shared by every case)."""
    rng = np.random.default_rng(21)
    batches = _batches(rng)
    net = JLLFlow(K=2, L=1, additional_flow_no_affine=2, **MINI)
    vq = JVQModel(vq_backend="ref", **VQ)

    def shapes():
        key = jax.random.PRNGKey(0)
        vq_p = vq.init(key, jnp.asarray(batches[0][1]))["params"]
        net_p = net.init(key, jnp.zeros((2, 8, 8, 3)), jnp.asarray(batches[0][0]),
                         method=JLLFlow.normal_flow)["params"]
        return vq_p, net_p

    vq_s, net_s = jax.eval_shape(shapes)
    vq_p, net_p = fill_tree(vq_s, rng), fill_tree(net_s, rng)
    jm = JModel.__new__(JModel)
    jm.netG, jm.net_hq, jm.mesh, jm._jit_cache, jm.opt = net, vq, None, {}, {"train": TRAIN}
    jm.params = jax.tree.map(jnp.asarray, net_p)
    jm.vq_variables = {"params": jax.tree.map(jnp.asarray, vq_p)}
    jm._actnorm_inited = False
    jm._build_optimizer(TRAIN)
    jm.initialize_actnorm({"LQ": jnp.asarray(batches[0][0]), "GT": jnp.asarray(batches[0][1])})
    params0 = jax.tree.map(np.asarray, jm.params)

    latents = [jm.encode_gt_latent(jnp.asarray(gt)) for _, gt in batches]
    args = (jm.params, jm.opt_state, latents[0], jnp.asarray(batches[0][0]))
    step = jm._train_step_fn().lower(*args).compile(compiler_options=FAST_COMPILE)
    params, opt_state, losses, mus = jm.params, jm.opt_state, [], []
    for (lq, _), lat in zip(batches, latents):
        params, opt_state, loss = step(params, opt_state, lat, jnp.asarray(lq))
        losses.append(float(loss))
        mus.append(jax.tree.map(np.asarray, _adam_moments(opt_state)[0]))
    mu2, nu2 = _adam_moments(opt_state)
    grads = [jax.tree.map(lambda m: m / (1 - B1), mus[0]),
             jax.tree.map(lambda m2, m1: (m2 - B1 * m1) / (1 - B1), mus[1], mus[0])]
    return {"net_p": net_p, "vq_p": vq_p, "batches": batches, "losses": losses,
            "params0": _torch_named(params0), "grads": [_torch_named(g) for g in grads],
            "mu2": _torch_named(mu2), "nu2": _torch_named(nu2), "params2": _torch_named(params),
            "rrdb_mask": _torch_named(jax.tree.map(lambda lab, p: np.full(p.shape, lab == "rrdb",
                                                                          np.float32),
                                                   jax_label_params(jm.params), jm.params))}


@pytest.fixture(scope="module")
def port_run(jax_run):
    model = create_model(_opt(), device="cpu")
    model.load_state_dicts(convert.flax_to_torch_stage2(jax_run["net_p"]),
                           convert.flax_to_torch_vqgan(jax_run["vq_p"]))
    vq0 = {n: t.clone() for n, t in model.net_hq.state_dict().items()}
    lq0, gt0 = jax_run["batches"][0]
    model.initialize_actnorm({"LQ": lq0, "GT": gt0})
    params0 = {n: p.detach().clone() for n, p in model.netG.named_parameters()}
    losses, grads = [], []
    for lq, gt in jax_run["batches"]:
        losses.append(model.optimize_parameters({"LQ": lq, "GT": gt}))
        grads.append({n: p.grad.detach().clone() for n, p in model.trainable_parameters()})
    return {"model": model, "losses": losses, "grads": grads, "params0": params0, "vq0": vq0}


def test_actnorm_init_matches_jax(jax_run, port_run):
    """Each ActNorm's bias / logs within 1e-5 of the tensor's largest magnitude.
    The second ActNorm of a step sequence sees an input that is already of zero
    mean (ActNorm, then an invertible 1x1), so its bias is rounding noise of ~1e-8
    in both packages: such a tensor (below 1e-6 of the largest bias) must vanish
    on both sides."""
    want = jax_run["params0"]
    keys = [n for n in want if ".actnorm." in n]
    assert len(keys) == 2 * (4 + 2 * 4), keys   # 4 steps: one ActNorm each, + 2 in each of 4 FNets
    for kind in ("bias", "logs"):
        names = [n for n in keys if n.endswith(kind)]
        top = max(float(np.abs(want[n].numpy()).max()) for n in names)
        for n in names:
            got, w = port_run["params0"][n].numpy(), want[n].numpy()
            assert got.shape == w.shape, n
            _close_or_vanishing(got, w, top, n, tol=1e-5)
    # no new state_dict key: the checkpoint names stay the reference's
    assert set(port_run["model"].netG.state_dict()) == set(want)


def test_two_steps_losses_and_gradients_match_jax(jax_run, port_run):
    for k in range(2):
        got, want = port_run["losses"][k], jax_run["losses"][k]
        assert abs(got - want) <= 1e-4 * abs(want), (k, got, want)
    assert port_run["losses"][1] != port_run["losses"][0]
    for k in range(2):
        want, got = jax_run["grads"][k], port_run["grads"][k]
        assert set(got) == set(want)
        top = max(float(np.abs(w.numpy()).max()) for w in want.values())
        for n in want:
            _close_or_vanishing(got[n].numpy(), want[n].numpy(), top, (k, n))


def test_optimizer_groups_moments_and_parameters_after_step_two(jax_run, port_run):
    model = port_run["model"]
    assert model.updates == 2
    # the two groups: the conditional encoder (JAX label 'rrdb') at decay 1e-5, the flow
    # at weight_decay_G, and the conf's betas
    jlabels = {n: "rrdb" if bool(v.all()) else "other" for n, v in jax_run["rrdb_mask"].items()}
    assert all(bool(v.all()) or not bool(v.any()) for v in jax_run["rrdb_mask"].values())
    groups = {g["label"]: g for g in model.optimizer.param_groups}
    names = {id(p): n for n, p in model.netG.named_parameters()}
    for label, wd in (("rrdb", 1e-5), ("other", TRAIN["weight_decay_G"])):
        g = groups[label]
        assert g["weight_decay"] == wd and g["betas"] == (B1, B2) and g["eps"] == 1e-8
        assert sorted(names[id(p)] for p in g["params"]) == sorted(n for n, v in jlabels.items()
                                                                    if v == label)
    named = dict(model.trainable_parameters())
    assert set(named) == set(jax_run["params2"])
    for field, want in (("exp_avg", jax_run["mu2"]), ("exp_avg_sq", jax_run["nu2"])):
        top = max(float(np.abs(w.numpy()).max()) for w in want.values())
        for n, p in named.items():
            _close_or_vanishing(model.optimizer.state[p][field].numpy(), want[n].numpy(), top,
                                (field, n))
    for n, p in named.items():
        # within 1e-3 of the tensor's largest beyond the two inits' own difference (an
        # ActNorm bias of rounding noise starts 1e-8 apart and moves by 2 lr)
        want = jax_run["params2"][n].numpy()
        init_diff = np.abs(port_run["params0"][n].numpy() - jax_run["params0"][n].numpy()).max()
        assert np.abs(p.detach().numpy() - want).max() <= 1e-3 * np.abs(want).max() + init_diff, n
        assert not torch.equal(p.detach(), port_run["params0"][n]), n   # both updates moved it
    # the two updates themselves, pooled over the tensors with a live gradient in both
    # steps (where the gradient is rounding noise, Adam moves by lr * its sign)
    tops = [max(float(np.abs(g.numpy()).max()) for g in grads.values()) for grads in jax_run["grads"]]
    live = [n for n in named if all(float(np.abs(g[n].numpy()).max()) > 1e-6 * top
                                    for g, top in zip(jax_run["grads"], tops))]
    assert len(live) > len(named) // 2, (len(live), len(named))
    d_port = torch.cat([(named[n].detach() - port_run["params0"][n]).flatten() for n in live])
    d_jax = torch.cat([(jax_run["params2"][n] - jax_run["params0"][n]).flatten() for n in live])
    assert float(d_jax.norm()) > 0
    assert float((d_port - d_jax).norm() / d_jax.norm()) <= 1e-2
    for n, t in model.net_hq.state_dict().items():
        assert torch.equal(t, port_run["vq0"][n]), n
    assert all(not p.requires_grad for p in model.net_hq.parameters())


def test_add_gt_noise_matches_jax(jax_run):
    """The flow alone (a given ``lr_enc``): the port with noise u against JAX's
    ``normal_flow(add_gt_noise=True)`` drawing the same u, and against JAX's plain
    ``normal_flow`` on gt + (u - 0.5) / quant, whose logdet lies -log(quant) *
    pixels away."""
    rng = np.random.default_rng(4)
    net = JLLFlow(K=2, L=1, additional_flow_no_affine=2, **MINI)
    port = create_model(_opt_infer(), device="cpu")
    port.load_state_dicts(convert.flax_to_torch_stage2(jax_run["net_p"]))
    gt = rng.standard_normal((2, 8, 8, 3)).astype(np.float32)
    enc = {"cond_feat": rng.standard_normal((2, 8, 8, 64)).astype(np.float32),
           "color_map": 0.5 * rng.standard_normal((2, 8, 8, 3)).astype(np.float32)}
    key = jax.random.PRNGKey(3)
    u = np.asarray(jax.random.uniform(key, gt.shape))
    shifted = gt + (u - 0.5) / 32.0

    @jax.jit
    def run(p, gt, key):
        enc_j = jax.tree.map(jnp.asarray, enc)
        noisy = net.apply({"params": p}, gt, None, lr_enc=enc_j, add_gt_noise=True, noise_rng=key,
                          method=JLLFlow.normal_flow)
        plain = net.apply({"params": p}, gt + (jax.random.uniform(key, gt.shape) - 0.5) / 32.0, None,
                          lr_enc=enc_j, method=JLLFlow.normal_flow)
        return noisy, plain

    (jz, jnll, jld), (pz, _, pld) = jax.tree.map(np.asarray, run(jax_run["net_p"], gt, key))
    with torch.no_grad():
        enc_t = {k: nchw(v) for k, v in enc.items()}
        z, nll, logdet = port.netG.normal_flow(nchw(gt), None, lr_enc=enc_t, add_gt_noise=True,
                                               noise=nchw(u))
        _, _, logdet_plain = port.netG.normal_flow(nchw(shifted), None, lr_enc=enc_t)
    shift = -np.log(32.0) * 64
    assert np.abs(nhwc(z) - jz).max() <= 1e-5 * np.abs(jz).max()
    assert np.abs(nll.numpy() - jnll).max() <= 1e-5 * np.abs(jnll).max()
    assert np.abs(logdet.numpy() - jld).max() <= 1e-5 * np.abs(jld).max()
    assert np.allclose(jld - pld, shift, rtol=1e-5)                        # JAX's own shift
    assert np.allclose(logdet.numpy() - logdet_plain.numpy(), shift, rtol=1e-5)
    # the reverse pass takes the same term out of its logdet
    lr = torch.zeros(1, 3, 16, 16)
    with torch.no_grad():
        _, ld0 = port.netG.reverse_flow(lr)
        _, ld1 = port.netG.reverse_flow(lr, add_gt_noise=True)
    assert float(ld1 - ld0) == pytest.approx(np.log(32.0) * 256, rel=1e-6)


def test_squeeze_matches_jax_bit_for_bit():
    x = np.random.default_rng(2).standard_normal((2, 8, 12, 6)).astype(np.float32)
    for f in (1, 2, 4):
        want = np.asarray(jax_squeeze2d(jnp.asarray(x), f))
        got = squeeze2d(nchw(x), f)
        assert np.array_equal(nhwc(got), want)
        assert np.array_equal(nhwc(unsqueeze2d(got, f)), x)
        assert np.array_equal(np.asarray(jax_unsqueeze2d(jnp.asarray(want), f)), x)
    layer = SqueezeLayer(2)
    y, ld = layer(nchw(x), torch.ones(2))
    assert np.array_equal(nhwc(y), np.asarray(jax_squeeze2d(jnp.asarray(x), 2)))
    assert torch.equal(layer(y, ld, reverse=True)[0], nchw(x)) and torch.equal(ld, torch.ones(2))


def test_actnorm_ddinit_normalizes_and_keeps_its_keys():
    x = 3.0 + 0.5 * torch.randn(4, 5, 6, 7, generator=torch.Generator().manual_seed(0))
    norm = ActNorm2d(5, scale=2.0)
    with torch.no_grad():
        y, logdet = norm(x, torch.zeros(4), ddinit=True)
    assert set(norm.state_dict()) == {"bias", "logs"}
    assert float(y.mean(dim=(0, 2, 3)).abs().max()) < 1e-5
    var = ((y - y.mean(dim=(0, 2, 3), keepdim=True)) ** 2).mean(dim=(0, 2, 3))
    assert torch.allclose(var.sqrt(), torch.full((5,), 2.0), atol=1e-4)
    assert torch.allclose(logdet, torch.full((4,), float(norm.logs.detach().sum()) * 42))
    assert torch.equal(norm(x)[0], y)   # the statistics were written


def test_float64_run_matches_float32(jax_run):
    """The stage-2 model widened to float64 (the exact reference of the card-against-CPU
    step check) computes the same loss and gradients as in float32, in float64: the
    loss within 1e-6 relative, each gradient within 1e-3 of its largest (a gradient
    below 1e-6 of the largest vanishes on both sides)."""
    model = create_model(_opt(), device="cpu")
    model.load_state_dicts(convert.flax_to_torch_stage2(jax_run["net_p"]),
                           convert.flax_to_torch_vqgan(jax_run["vq_p"]))
    lq, gt = jax_run["batches"][0]
    model.initialize_actnorm({"LQ": lq, "GT": gt})
    runs = []
    for widen in (False, True):
        if widen:
            model.netG.double()
            model.net_hq.double()
        loss = model.train_loss(lq, gt)
        loss.backward()
        runs.append((loss.detach(), {n: p.grad.detach().clone() for n, p in model.trainable_parameters()}))
        model.optimizer.zero_grad(set_to_none=True)
    (loss32, g32), (loss64, g64) = runs
    assert loss32.dtype == torch.float32 and loss64.dtype == torch.float64
    assert all(g.dtype == torch.float64 for g in g64.values())
    assert abs(float(loss32) - float(loss64)) <= 1e-6 * abs(float(loss64))
    top = max(float(g.abs().max()) for g in g64.values())
    for n, g in g64.items():
        _close_or_vanishing(g32[n].numpy(), g.numpy(), top, n)


def test_cli_stage2_trains_checkpoints_resumes_and_feeds_test_stages(tmp_path, monkeypatch):
    """cli.train --stage 2 --niter 2 --device cpu on a synthetic LOL folder (mini
    network, 32 px crops): 2_G.pth and 2.state, validation through decode_latent,
    a resume, and the checkpoints through cli.test_stages --stage 2."""
    pytest.importorskip("cv2")
    pytest.importorskip("pandas")
    from glare_tpu_torch.cli import test_stages, train

    rng = np.random.default_rng(9)
    data = tmp_path / "LOLdataset"
    _write_folder(str(data / "our485"), ["1.png", "2.png", "3.png", "4.png"], rng)
    _write_folder(str(data / "eval15"), ["5.png"], rng)
    opt = _opt()
    del opt["is_train"]
    opt.update({
        "name": "tstage2_torch", "dataset": "LoL", "scale": 1,
        "datasets": {
            "train": {"root": str(data), "batch_size": 2, "use_resize_crop": True,
                      "use_flip": True, "GT_size": 32, "log_low": True, "quant": 32},
            "val": {"root": str(data), "split": 0, "log_low": True, "quant": 32}},
        "path": {"resume_state": "auto"},
        "logger": {"print_freq": 1, "save_checkpoint_freq": 2},
    })
    opt["train"].update({"niter": 80000, "val_freq": 2, "lr_steps_rel": [0.5, 0.75]})
    conf = tmp_path / "train.yml"
    conf.write_text(yaml.safe_dump(opt))
    monkeypatch.setenv("GLARE_ROOT", str(tmp_path))
    argv = ["--stage", "2", "--opt", str(conf), "--niter", "2", "--device", "cpu"]
    model, step = train.main(argv=argv)
    root = tmp_path / "experiments" / "tstage2_torch"
    assert step == 2 and model.updates == 2 and model._actnorm_inited
    assert set(model.get_current_log()) == {"nll_loss"}
    assert np.isfinite(model.get_current_log()["nll_loss"])
    models = root / "models"
    assert (models / "2_G.pth").exists() and (root / "training_state" / "2.state").exists()
    assert (models / "best_psnr_2_G.pth").exists()

    fresh = create_model(_opt(), device="cpu")
    epoch, it = fresh.resume_training(str(root / "training_state" / "2.state"))
    assert it == 2 and fresh.updates == 2 and fresh._actnorm_inited
    for n, p in fresh.trainable_parameters():
        assert torch.equal(p, model.netG.get_parameter(n)), n
    assert fresh.optimizer.state_dict()["state"].keys() == model.optimizer.state_dict()["state"].keys()
    # a second run of the same conf resumes from 2.state and stops at once
    assert train.main(argv=argv)[1] == 2

    # the _G.pth into an inference model (bit-equal get_sr) and through test_stages
    lq = _batches(rng)[0][0]
    infer = create_model(_opt_infer(), device="cpu")
    infer.load_network(str(models / "2_G.pth"))
    assert torch.equal(infer.get_sr(lq), model.get_sr(lq))
    sweep = {**_opt_infer(), "name": "tstage2_sweep", "dataroot_LR": str(data / "eval15" / "low"),
             "dataroot_GT": str(data / "eval15" / "high")}
    sweep_conf = tmp_path / "sweep.yml"
    sweep_conf.write_text(yaml.safe_dump(sweep))
    df = test_stages.run_checkpoint_sweep(2, str(sweep_conf), str(models), device="cpu")
    assert list(df["checkpoint"]) == ["2_G.pth", "best_psnr_2_G.pth"]
    assert np.isfinite(df[["PSNR", "SSIM", "PSNR_adj", "SSIM_adj"]].to_numpy()).all()
    assert df["PSNR"].iloc[0] == df["PSNR"].iloc[1]     # the same weights

    with pytest.raises(ValueError, match="--stage 3 trains model 'VQLLFLOWD'"):
        train.main(argv=["--stage", "3", "--opt", str(conf), "--device", "cpu"])
