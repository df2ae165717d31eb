"""Stage-1 training in the port against the JAX package's, on the CPU.

The slice as a whole: two HQ iterations of the port's ``VQDehazeModel`` (each:
the g step, ``z_gt`` by the updated generator, the d step, the EMA) against the
JAX model's own ``optimize_parameters`` with the same carried weights and
batches.
The JAX side is built by ``VQDehazeModel(opt)`` (its flax inits jitted, its
VGG19 the carried one) and given the carried generator and discriminator (with
its spectral ``u``) before its first step; its steps are its own jitted ``_g_step`` / ``_d_step``, each
compiled once with the fast XLA options (the compile dominates); its gradients
are read back from optax's first Adam moment (``mu_1 = (1 - b1) g_1``,
``mu_2 = b1 mu_1 + (1 - b1) g_2``).

Small configuration: ``tests/test_sr.py``'s (``gt_resolution`` 32, codebook
``[[8, 64, 64]]``, UNet-SN ``num_in_ch`` 64, ``num_feat`` 32), batch 2,
float32, the conf's losses: L1, VGG19 perceptual (relu1_2 / 2_2 / 3_3), codebook,
hinge GAN 0.1; Adam (0.9, 0.99); EMA 0.999. The codebook is N(0, 1) (the
seeded init, uniform +-1/64, would make every token's distances near-ties).
Adam's lr is 2e-6, not the conf's 1e-4: its first update is lr * sign(g) for
every element, also where the gradient is float32 rounding noise (measured: on
~1e-4 of the generator's elements), and there the two packages move by lr in
opposite directions. The second iteration then starts from parameters that
differ by that noise; at lr 2e-5 it moved the second iteration's generator
gradients 1.1e-3 of their largest apart (at equal parameters 3.9e-4), at 2e-6
5.5e-4. For the same reason the update rule is held on the second iteration's
update (each package from its own parameters after the first), as the stage-3
test holds it on its second step (its first update is 0, a warmup); the first
iteration's update, pure lr * sign(g), measured 1.6e-2 apart.

Tolerances: losses 1e-4 relative; the gradients of both networks, their
parameters after Adam and the EMA within 1e-3 of each tensor's largest magnitude
(a gradient that vanishes in exact arithmetic must vanish on both sides); the
generator's second update within 1e-2 in the 2-norm over all its tensors; the
spectral ``u`` after each d step within 1e-5. Both sides are float32; rounding differences
of 1e-6 grow along ~30 convolutions, the VGG and the discriminator.

Also here: the LQ stage's frozen set in ``VQDehazeModel`` (keywords) and the
``sr.train`` CLI on a folder of PNGs (train 2 iterations, save, resume).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from flax import linen as nn

from glare_tpu.sr.archs import vgg_arch as jax_vgg_arch
from glare_tpu.sr.archs.discriminator_arch import UNetDiscriminatorSN as JD
from glare_tpu.sr.archs.vgg_arch import VGGFeatureExtractor as JVGG
from glare_tpu.sr.archs.vq_weight_arch import VQWeightDehazeNet as JNet
from glare_tpu.sr.models.vq_model import VQDehazeModel as JModel
from glare_tpu_torch import convert
from glare_tpu_torch.sr.models import build_model

from test_torch_train import FAST_COMPILE, _close_or_vanishing
from torch_port_util import fill_tree

NET_G = {"type": "VQWeightDehazeNet", "gt_resolution": 32, "codebook_params": [[8, 64, 64]],
         "LQ_stage": False, "use_weight": False, "norm_type": "gn", "act_type": "silu"}
NET_D = {"type": "UNetDiscriminatorSN", "num_in_ch": 64, "num_feat": 32}
TAPS = {"relu1_2": 1.0, "relu2_2": 1.0, "relu3_3": 1.0}
B1 = 0.9


def _opt(tmp):
    return {
        "is_train": True, "manual_seed": 0, "model_type": "VQDehazeModel",
        "network_g": dict(NET_G), "network_d": dict(NET_D),
        "datasets": {"train": {"gt_size": 32}},
        "path": {"models": os.path.join(tmp, "models"),
                 "training_states": os.path.join(tmp, "training_states")},
        "train": {
            "optim_g": {"type": "Adam", "lr": 2e-6}, "optim_d": {"type": "Adam", "lr": 2e-6},
            "pixel_opt": {"type": "L1Loss", "loss_weight": 1.0, "reduction": "mean"},
            "perceptual_opt": {"type": "PerceptualLoss", "layer_weights": dict(TAPS),
                               "perceptual_weight": 1.0, "style_weight": 0},
            "codebook_opt": {"loss_weight": 1.0},
            "gan_opt": {"type": "GANLoss", "gan_type": "hinge", "real_label_val": 1.0,
                        "fake_label_val": 0.0, "loss_weight": 0.1},
            "net_d_iters": 1, "net_d_init_iters": 0, "ema_decay": 0.999},
        "val": {"metrics": {"psnr": {"type": "psnr", "better": "higher"}}},
    }


def _weights(rng, batch):
    """Carried weights: generator, discriminator (+ spectral u), VGG19 through relu3_3."""
    x = jnp.asarray(batch["gt"])
    net = JNet(**{k: v for k, v in NET_G.items() if k != "type"})
    d = JD(num_in_ch=64, num_feat=32)
    vgg = JVGG(layer_name_list=list(TAPS), vgg_type="vgg19")
    g_s, d_s, v_s = jax.eval_shape(lambda: (
        net.init(jax.random.PRNGKey(0), x)["params"],
        d.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 64))),
        vgg.init(jax.random.PRNGKey(0), x)["params"]))
    params_g = fill_tree(g_s, rng)
    params_g["quantize_group_0"]["embedding"] = rng.standard_normal((64, 64)).astype(np.float32)
    return params_g, fill_tree(d_s["params"], rng), fill_tree(d_s["spectral"], rng), fill_tree(v_s, rng)


def _adam_mu(opt_state):
    return jax.tree.map(np.asarray, opt_state[0].mu)


def _batches(rng):
    out = []
    for _ in range(2):
        x = rng.uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
        out.append({"lq": x, "gt": x})  # HQ pretraining: SingleImageDataset gives lq == gt
    return out


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """Two JAX iterations (the g step, d step and z_gt compiled once each)."""
    rng = np.random.default_rng(21)
    batches = _batches(rng)
    params_g, params_d, spectral, vgg = _weights(rng, batches[0])
    init = nn.Module.init

    def jit_init(module, rngs, *args, method=None, **kw):  # one compile, not one per eager op
        return jax.jit(lambda r, *a: init(module, r, *a, method=method, **kw))(rngs, *args)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(nn.Module, "init", jit_init)
        mp.setattr(jax_vgg_arch, "load_vgg_params", lambda *a, **k: {"params": jax.tree.map(jnp.asarray, vgg)})
        jm = JModel(_opt(str(tmp_path_factory.mktemp("jax"))))
    jm.params_g = jax.tree.map(jnp.asarray, params_g)
    jm.params_d = jax.tree.map(jnp.asarray, params_d)
    jm.spectral_d = jax.tree.map(jnp.asarray, spectral)
    jm.opt_state_g, jm.opt_state_d = jm.tx_g.init(jm.params_g), jm.tx_d.init(jm.params_d)
    from jax.flatten_util import ravel_pytree

    jm.params_g_ema = ravel_pytree(jm.params_g)[0]
    lq = gt = jnp.asarray(batches[0]["gt"])
    g_args = (jm.params_g, jm.opt_state_g, None, jm.params_d, jm.spectral_d, lq, gt, jnp.float32(1.0))
    jm._jit["g"] = jm._g_step().lower(*g_args).compile(compiler_options=FAST_COMPILE)
    zgt_fn = jax.jit(lambda p, x: jm.net_g.apply({"params": p}, x, method=jm.net_g.encode_and_decode)[4])
    jm._jit["zgt"] = zgt_fn.lower(jm.params_g, gt).compile(compiler_options=FAST_COMPILE)
    z0 = jnp.zeros((2, 8, 8, 64), jnp.float32)
    jm._jit["d"] = jm._d_step().lower(jm.params_d, jm.spectral_d, jm.opt_state_d, z0, z0).compile(
        compiler_options=FAST_COMPILE)
    out = {"batches": batches, "params_g": params_g, "params_d": params_d, "spectral": spectral, "vgg": vgg,
           "logs": [], "mu_g": [], "mu_d": [], "g": [], "d": []}
    for it, batch in enumerate(batches, start=1):
        out["logs"].append(dict(jm.optimize_parameters(it, batch).items()))
        out["mu_g"].append(_adam_mu(jm.opt_state_g))
        out["mu_d"].append(_adam_mu(jm.opt_state_d))
        out["g"].append(convert.flax_to_torch_stage1(jax.tree.map(np.asarray, jm.params_g)))
        out["d"].append(convert.flax_to_torch_stage1(jax.tree.map(np.asarray, jm.params_d),
                                                     jax.tree.map(np.asarray, jm.spectral_d)))
    for net in ("g", "d"):
        mu = out.pop(f"mu_{net}")
        out[f"grads_{net}"] = [
            convert.flax_to_torch_stage1(jax.tree.map(lambda m: m / (1 - B1), mu[0])),
            convert.flax_to_torch_stage1(jax.tree.map(lambda m2, m1: (m2 - B1 * m1) / (1 - B1), mu[1], mu[0]))]
    out["ema"] = convert.flax_to_torch_stage1(jax.tree.map(np.asarray, jm._ema_unravel(jm.params_g_ema)))
    return out


def _port_model(jax_run, tmp):
    model = build_model(_opt(tmp), device="cpu")
    model.net_g.load_state_dict(convert.flax_to_torch_stage1(jax_run["params_g"]))
    model.net_d.load_state_dict(convert.flax_to_torch_stage1(jax_run["params_d"], jax_run["spectral"]))
    model.cri_perceptual.vgg.load_state_dict(convert.flax_to_torch_vgg(jax_run["vgg"]))
    model.init_ema(model.net_g)
    return model


@pytest.fixture(scope="module")
def port_run(jax_run, tmp_path_factory):
    model = _port_model(jax_run, str(tmp_path_factory.mktemp("port")))
    snap = lambda net: {n: t.detach().clone() for n, t in net.state_dict().items()}  # noqa: E731
    out = {"model": model, "g": [snap(model.net_g)], "d": [snap(model.net_d)], "logs": [],
           "grads_g": [], "grads_d": []}
    for it, batch in enumerate(jax_run["batches"], start=1):
        out["logs"].append(dict(model.optimize_parameters(it, batch)))
        out["grads_g"].append({n: p.grad.clone() for n, p in model.net_g.named_parameters()
                               if p.grad is not None})
        out["grads_d"].append({n: p.grad.clone() for n, p in model.net_d.named_parameters()})
        out["g"].append(snap(model.net_g))
        out["d"].append(snap(model.net_d))
    return out


def _close(got, want, what, tol=1e-3):
    w = want.numpy()
    assert np.abs(got.numpy() - w).max() <= tol * max(np.abs(w).max(), 1e-12), what


@pytest.mark.parametrize("it", [0, 1])
def test_hq_iterations_losses_match_jax(jax_run, port_run, it):
    want, got = jax_run["logs"][it], port_run["logs"][it]
    keys = ("l_codebook", "l_pix", "l_percep", "l_g_gan", "l_g_total", "l_d_real", "l_d_fake",
            "out_d_real", "out_d_fake")
    assert set(keys) <= set(got) and set(keys) <= set(want)
    for k in keys:
        assert abs(got[k] - want[k]) <= 1e-4 * abs(want[k]), (it, k, got[k], want[k])


@pytest.mark.parametrize("it", [0, 1])
@pytest.mark.parametrize("net", ["g", "d"])
def test_hq_iterations_gradients_match_jax(jax_run, port_run, net, it):
    want, got = dict(jax_run[f"grads_{net}"][it]), port_run[f"grads_{net}"][it]
    if net == "g":  # the quantizer's usage weight has no gradient path (the port's is frozen)
        assert float(np.abs(want.pop("quantize_group.0.weight").numpy()).max()) == 0
    assert set(got) == set(want)
    top = max(float(np.abs(w.numpy()).max()) for w in want.values())
    for n in want:
        _close_or_vanishing(got[n].numpy(), want[n].numpy(), top, (net, it, n))


@pytest.mark.parametrize("it", [0, 1])
def test_hq_iterations_parameters_and_spectral_u_match_jax(jax_run, port_run, it):
    for net in ("g", "d"):
        got = port_run[net][it + 1]
        for n, w in jax_run[net][it].items():
            if n.endswith(".u"):  # the d step's real forward moved it (a 1-vector stays at +-1)
                assert np.abs(got[n].numpy() - w.numpy()).max() <= 1e-5, (it, n)
                assert got[n].numel() == 1 or not torch.equal(got[n], port_run[net][it][n]), (it, n)
            else:
                _close(got[n], w, (net, it, n))


def test_second_update_matches_jax(jax_run, port_run):
    g1, g2 = port_run["g"][1], port_run["g"][2]
    names = [n for n, _ in port_run["model"].net_g.named_parameters()]
    d_port = torch.cat([(g2[n] - g1[n]).flatten() for n in names])
    d_jax = torch.cat([(jax_run["g"][1][n] - jax_run["g"][0][n]).flatten() for n in names])
    assert float(d_jax.norm()) > 0
    assert float((d_port - d_jax).norm() / d_jax.norm()) <= 1e-2


def test_ema_matches_jax_and_its_formula(jax_run, port_run):
    model = port_run["model"]
    ema = model.ema_state_dict()
    for n, w in jax_run["ema"].items():
        _close(ema[n], w, n)
    p0, p1, p2 = port_run["g"]
    for n, _ in model.net_g.named_parameters():
        want = (p0[n] * 0.999 + p1[n] * (1 - 0.999)) * 0.999 + p2[n] * (1 - 0.999)
        assert torch.allclose(ema[n], want, rtol=1e-6, atol=1e-7), n


LQ_NET = {**NET_G, "LQ_stage": True, "use_weight": True}
KEYWORDS = [["quantize", "after_quant_group", "decoder_group", "out_conv"],
            ["quantize", "decoder", "after_quant_group", "out_conv"],
            ["multiscale_encoder"], ["swin", "warp", "residual_conv"]]


@pytest.fixture(scope="module")
def lq_tree():
    net = JNet(**{k: v for k, v in LQ_NET.items() if k != "type"})
    return jax.eval_shape(lambda: net.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3))))["params"]


@pytest.mark.parametrize("keywords", KEYWORDS, ids=lambda k: "+".join(k))
def test_lq_frozen_set_equals_jax(lq_tree, keywords, tmp_path):
    """The JAX model labels the flax tree (``_label_frozen``); carried through the
    converter as 1 / 0 tensors, its frozen set is the port's by ``is_frozen``, and
    ``VQDehazeModel`` in the LQ stage leaves exactly those (and the quantizer's
    usage weight, which no loss reaches) out of its optimizer."""
    from glare_tpu.sr.models.vq_model import _label_frozen

    labels = _label_frozen(lq_tree, keywords)
    tags = jax.tree.map(lambda lab, s: np.full(s.shape, lab == "frozen", np.float32), labels, lq_tree)
    want = {n for n, t in convert.flax_to_torch_stage1(tags).items() if bool(t.all())}
    assert want
    opt = _opt(str(tmp_path))
    opt["network_g"] = {**LQ_NET, "frozen_module_keywords": keywords}
    opt["train"].pop("perceptual_opt")
    model = build_model(opt, device="cpu")
    frozen = {n for n, p in model.net_g.named_parameters() if not p.requires_grad}
    assert frozen - {"quantize_group.0.weight"} == want - {"quantize_group.0.weight"}
    in_opt = {id(p) for group in model.optimizer_g.param_groups for p in group["params"]}
    assert {n for n, p in model.net_g.named_parameters() if id(p) not in in_opt} == frozen
    assert all(not p.requires_grad for p in model.net_hq.parameters())


def _write_images(folder, names, rng, size=(40, 48)):
    import cv2

    os.makedirs(folder, exist_ok=True)
    for n in names:
        cv2.imwrite(os.path.join(folder, n), (rng.uniform(0.1, 0.9, size + (3,)) * 255).astype(np.uint8))


def test_cli_trains_saves_resumes_and_tests(tmp_path, monkeypatch):
    """``sr.train -opt CONF --device cpu`` on a folder of PNGs (the mini network,
    32 px crops, batch 2): 2 iterations, ``net_g_2.pth`` / ``net_d_2.pth`` /
    ``2.state`` and a best-PSNR snapshot; ``--auto_resume`` resumes at 2 with the
    saved networks and EMA and stops; ``sr.test`` reads the checkpoint; without
    ``--device cpu`` and without a GPU both raise."""
    from glare_tpu_torch.sr import test as sr_test
    from glare_tpu_torch.sr import train as sr_train

    rng = np.random.default_rng(5)
    _write_images(str(tmp_path / "high"), ["1.png", "2.png", "3.png", "4.png"], rng)
    _write_images(str(tmp_path / "val"), ["5.png"], rng, size=(36, 44))
    opt = _opt(str(tmp_path))
    del opt["is_train"], opt["path"]
    opt["train"].pop("perceptual_opt")
    opt.update({
        "name": "tstage1_torch", "scale": 1,
        "datasets": {
            "train": {"name": "hq", "type": "SingleImageDataset", "dataroot_gt": str(tmp_path / "high"),
                      "gt_size": 32, "use_hflip": True, "use_rot": True, "batch_size_per_gpu": 2},
            "val": {"name": "val", "type": "SingleImageDataset", "dataroot_gt": str(tmp_path / "val")}},
        "path": {"pretrain_network_g": None, "resume_state": None},
        "val": {"val_freq": 2, "metrics": {"psnr": {"type": "psnr", "better": "higher"}}},
        "logger": {"print_freq": 1, "save_checkpoint_freq": 2, "use_tb_logger": False}})
    opt["train"]["total_iter"] = 2
    conf = tmp_path / "stage1.yml"
    conf.write_text(yaml.safe_dump(opt))
    monkeypatch.setenv("GLARE_ROOT", str(tmp_path))
    model, it = sr_train.train_pipeline(argv=["-opt", str(conf), "--device", "cpu"])
    root = tmp_path / "experiments" / "tstage1_torch"
    assert it == 2
    assert all(np.isfinite(v) for v in model.get_current_log().values())
    for f in ("models/net_g_2.pth", "models/net_d_2.pth", "models/net_g_best_.pth", "training_states/2.state"):
        assert (root / f).exists(), f
    saved = torch.load(root / "models" / "net_g_2.pth", weights_only=True)
    assert set(saved) == {"params", "params_ema"}
    for n, t in model.net_g.state_dict().items():
        assert torch.equal(saved["params"][n], t), n
        assert torch.equal(saved["params_ema"][n], model.ema_state_dict()[n]), n

    resumed, it2 = sr_train.train_pipeline(argv=["-opt", str(conf), "--device", "cpu", "--auto_resume"])
    assert it2 == 2
    for net in ("net_g", "net_d"):
        for n, t in getattr(model, net).state_dict().items():
            assert torch.equal(getattr(resumed, net).state_dict()[n], t), (net, n)
    assert torch.equal(resumed.ema_flat, model.ema_flat)

    test_conf = tmp_path / "test.yml"
    test_conf.write_text(yaml.safe_dump({
        "name": "tstage1_test", "model_type": "VQDehazeModel", "network_g": dict(NET_G),
        "path": {"pretrain_network_g": str(root / "models" / "net_g_2.pth")},
        "datasets": {"test": {"type": "SingleImageDataset", "dataroot_gt": str(tmp_path / "val")}}}))
    tested, results = sr_test.test_pipeline(argv=["-opt", str(test_conf), "--device", "cpu"])
    for n, t in model.net_g.state_dict().items():
        assert torch.equal(tested.net_g.state_dict()[n], t), n
    assert np.isfinite(results["test"][0])

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn, c in ((sr_train.train_pipeline, conf), (sr_test.test_pipeline, test_conf)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn(argv=["-opt", str(c)])


# ---------------------------------------------------------------------------
# The LQ stage's iteration as a whole (slow: one JAX jit of the LQ g step is
# longer than the Tier-1 budget allows). LQ_NET with the frozen keywords
# KEYWORDS[0] (the codebook and the code decoder), net_hq the HQ generator, two
# iterations of each package's optimize_parameters from the same carried weights
# and (lq, gt) batches: the g step through net_hq's GT indices, z_gt by net_hq,
# the d step, Adam over the partly frozen tree. The bars of the HQ test above.

LQ_KEYWORDS = KEYWORDS[0]


def _lq_opt(tmp):
    opt = _opt(tmp)
    opt["network_g"] = {**LQ_NET, "frozen_module_keywords": list(LQ_KEYWORDS)}
    return opt


def _lq_batches(rng):
    return [{"lq": rng.uniform(0, 1, (2, 32, 32, 3)).astype(np.float32),
             "gt": rng.uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)} for _ in range(2)]


def _overlay(tree, src):
    """``tree`` with every leaf that ``src`` has at the same path and shape taken
    from ``src`` (what loading the HQ file into the LQ generator, strict=False, does)."""
    out = {}
    for k, v in tree.items():
        s = src.get(k) if isinstance(src, dict) else None
        if isinstance(v, dict):
            out[k] = _overlay(v, s if isinstance(s, dict) else {})
        else:
            out[k] = s if s is not None and np.shape(s) == np.shape(v) else v
    return out


def _train_mu(opt_state, params):
    """Adam's first moment of the multi_transform's ``train`` group as a full tree:
    frozen leaves (optax's MaskedNode) read 0."""
    from flax import traverse_util

    mu = traverse_util.flatten_dict(opt_state.inner_states["train"].inner_state[0].mu)
    flat = traverse_util.flatten_dict(jax.tree.map(np.asarray, params))
    return traverse_util.unflatten_dict({k: np.asarray(mu[k]) if isinstance(mu.get(k), jax.Array)
                                         else np.zeros_like(p) for k, p in flat.items()})


@pytest.fixture(scope="module")
def lq_jax_run(tmp_path_factory):
    """Two JAX LQ iterations (the g step, z_gt by net_hq and the d step compiled
    once each). JAX's build_network passes every key of network_g to the flax
    module, so the frozen keywords are dropped on the way there (ROADMAP,
    reference-side caveats); ``_init_training`` still reads them."""
    from glare_tpu.sr.models import vq_model as jax_vq_model

    rng = np.random.default_rng(31)
    batches = _lq_batches(rng)
    params_hq, params_d, spectral, vgg = _weights(rng, {"gt": batches[0]["gt"]})
    net = JNet(**{k: v for k, v in LQ_NET.items() if k != "type"})
    lq_shapes = jax.eval_shape(lambda: net.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3))))["params"]
    params_g = _overlay(fill_tree(lq_shapes, rng), params_hq)
    init, build = nn.Module.init, jax_vq_model.build_network

    def jit_init(module, rngs, *args, method=None, **kw):
        return jax.jit(lambda r, *a: init(module, r, *a, method=method, **kw))(rngs, *args)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(nn.Module, "init", jit_init)
        mp.setattr(jax_vgg_arch, "load_vgg_params", lambda *a, **k: {"params": jax.tree.map(jnp.asarray, vgg)})
        mp.setattr(jax_vq_model, "build_network",
                   lambda o: build({k: v for k, v in o.items() if k != "frozen_module_keywords"}))
        jm = JModel(_lq_opt(str(tmp_path_factory.mktemp("jax_lq"))))
    assert jm.LQ_stage
    jm.params_g, jm.params_hq = (jax.tree.map(jnp.asarray, p) for p in (params_g, params_hq))
    jm.params_d = jax.tree.map(jnp.asarray, params_d)
    jm.spectral_d = jax.tree.map(jnp.asarray, spectral)
    jm.opt_state_g, jm.opt_state_d = jm.tx_g.init(jm.params_g), jm.tx_d.init(jm.params_d)
    from jax.flatten_util import ravel_pytree

    jm.params_g_ema = ravel_pytree(jm.params_g)[0]
    lq, gt = (jnp.asarray(batches[0][k]) for k in ("lq", "gt"))
    g_args = (jm.params_g, jm.opt_state_g, jm.params_hq, jm.params_d, jm.spectral_d, lq, gt, jnp.float32(1.0))
    jm._jit["g"] = jm._g_step().lower(*g_args).compile(compiler_options=FAST_COMPILE)
    zgt_fn = jax.jit(lambda p, x: jm.net_hq.apply({"params": p}, x, method=jm.net_hq.encode_and_decode)[4])
    jm._jit["zgt"] = zgt_fn.lower(jm.params_hq, gt).compile(compiler_options=FAST_COMPILE)
    z0 = jnp.zeros((2, 8, 8, 64), jnp.float32)
    jm._jit["d"] = jm._d_step().lower(jm.params_d, jm.spectral_d, jm.opt_state_d, z0, z0).compile(
        compiler_options=FAST_COMPILE)
    out = {"batches": batches, "params_g": params_g, "params_hq": params_hq, "params_d": params_d,
           "spectral": spectral, "vgg": vgg, "logs": [], "mu_g": [], "mu_d": [], "g": [], "d": []}
    for it, batch in enumerate(batches, start=1):
        out["logs"].append(dict(jm.optimize_parameters(it, batch).items()))
        out["mu_g"].append(_train_mu(jm.opt_state_g, jm.params_g))
        out["mu_d"].append(_adam_mu(jm.opt_state_d))
        out["g"].append(convert.flax_to_torch_stage1(jax.tree.map(np.asarray, jm.params_g)))
        out["d"].append(convert.flax_to_torch_stage1(jax.tree.map(np.asarray, jm.params_d),
                                                     jax.tree.map(np.asarray, jm.spectral_d)))
    for net_ in ("g", "d"):
        mu = out.pop(f"mu_{net_}")
        out[f"grads_{net_}"] = [
            convert.flax_to_torch_stage1(jax.tree.map(lambda m: m / (1 - B1), mu[0])),
            convert.flax_to_torch_stage1(jax.tree.map(lambda m2, m1: (m2 - B1 * m1) / (1 - B1), mu[1], mu[0]))]
    return out


@pytest.fixture(scope="module")
def lq_port_run(lq_jax_run, tmp_path_factory):
    model = build_model(_lq_opt(str(tmp_path_factory.mktemp("port_lq"))), device="cpu")
    model.net_g.load_state_dict(convert.flax_to_torch_stage1(lq_jax_run["params_g"]))
    model.net_hq.load_state_dict(convert.flax_to_torch_stage1(lq_jax_run["params_hq"]))
    model.net_d.load_state_dict(convert.flax_to_torch_stage1(lq_jax_run["params_d"], lq_jax_run["spectral"]))
    model.cri_perceptual.vgg.load_state_dict(convert.flax_to_torch_vgg(lq_jax_run["vgg"]))
    model.init_ema(model.net_g)
    snap = lambda net: {n: t.detach().clone() for n, t in net.state_dict().items()}  # noqa: E731
    out = {"model": model, "g": [snap(model.net_g)], "d": [snap(model.net_d)], "logs": [],
           "grads_g": [], "grads_d": []}
    for it, batch in enumerate(lq_jax_run["batches"], start=1):
        out["logs"].append(dict(model.optimize_parameters(it, batch)))
        out["grads_g"].append({n: p.grad.clone() for n, p in model.net_g.named_parameters()
                               if p.grad is not None})
        out["grads_d"].append({n: p.grad.clone() for n, p in model.net_d.named_parameters()})
        out["g"].append(snap(model.net_g))
        out["d"].append(snap(model.net_d))
    return out


@pytest.mark.slow
def test_lq_iterations_losses_and_gradients_match_jax(lq_jax_run, lq_port_run):
    keys = ("l_codebook", "l_pix", "l_percep", "l_g_gan", "l_g_total", "l_d_real", "l_d_fake",
            "out_d_real", "out_d_fake")
    frozen = {n for n, p in lq_port_run["model"].net_g.named_parameters() if not p.requires_grad}
    for it in range(2):
        want, got = lq_jax_run["logs"][it], lq_port_run["logs"][it]
        for k in keys:
            assert abs(got[k] - want[k]) <= 1e-4 * abs(want[k]), (it, k, got[k], want[k])
        for net in ("g", "d"):
            want_g, got_g = dict(lq_jax_run[f"grads_{net}"][it]), lq_port_run[f"grads_{net}"][it]
            if net == "g":  # JAX's frozen leaves have no moment; the port's no gradient
                assert all(float(np.abs(want_g.pop(n).numpy()).max()) == 0 for n in frozen)
            assert set(got_g) == set(want_g)
            top = max(float(np.abs(w.numpy()).max()) for w in want_g.values())
            for n in want_g:
                _close_or_vanishing(got_g[n].numpy(), want_g[n].numpy(), top, (net, it, n))


@pytest.mark.slow
def test_lq_iterations_parameters_match_jax_and_frozen_tensors_stay(lq_jax_run, lq_port_run):
    frozen = {n for n, p in lq_port_run["model"].net_g.named_parameters() if not p.requires_grad}
    assert frozen >= {"quantize_group.0.embedding.weight", "out_conv.weight"}
    start = convert.flax_to_torch_stage1(lq_jax_run["params_g"])
    for it in range(2):
        for net in ("g", "d"):
            got = lq_port_run[net][it + 1]
            for n, w in lq_jax_run[net][it].items():
                if n.endswith(".u"):
                    assert np.abs(got[n].numpy() - w.numpy()).max() <= 1e-5, (it, n)
                else:
                    _close(got[n], w, (net, it, n))
        for n in frozen:
            assert torch.equal(lq_port_run["g"][it + 1][n], start[n]), (it, n)
            assert torch.equal(lq_jax_run["g"][it][n], start[n]), (it, n)


def _live(name, t):
    """``t`` without the key third of a Swin block's fused ``attn.qkv.bias``:
    softmax ignores a shift of a query's scores, so that third's gradient vanishes
    in exact arithmetic (the attention key bias of ``_close_or_vanishing``), and
    Adam turns its rounding noise into steps of +-lr in either direction."""
    if name.endswith("attn.qkv.bias"):
        c = t.numel() // 3
        return torch.cat([t[:c], t[2 * c:]])
    return t.flatten()


@pytest.mark.slow
def test_lq_second_update_matches_jax(lq_jax_run, lq_port_run):
    g1, g2 = lq_port_run["g"][1], lq_port_run["g"][2]
    names = [n for n, p in lq_port_run["model"].net_g.named_parameters() if p.requires_grad]
    key_biases = [n for n in names if n.endswith("attn.qkv.bias")]
    assert key_biases
    for it in range(2):  # the premise: the key thirds' gradient vanishes on both sides
        want, got = lq_jax_run["grads_g"][it], lq_port_run["grads_g"][it]
        top = max(float(np.abs(w.numpy()).max()) for w in want.values())
        for n in key_biases:
            c = want[n].numel() // 3
            for grads in (want, got):
                assert float(grads[n][c:2 * c].abs().max()) <= 1e-6 * top, (it, n)
    d_port = torch.cat([_live(n, g2[n] - g1[n]) for n in names])
    d_jax = torch.cat([_live(n, lq_jax_run["g"][1][n] - lq_jax_run["g"][0][n]) for n in names])
    assert float(d_jax.norm()) > 0
    assert float((d_port - d_jax).norm() / d_jax.norm()) <= 1e-2
