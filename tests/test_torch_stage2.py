"""Stage-2 inference of the port vs the JAX package (CPU): ``LLFlowModel.get_sr``
+ ``decode_latent`` against ``LLFlowVQGAN2.reverse_flow`` + ``VQModel.decode``,
``get_encode_nll`` against ``normal_flow``, and the evaluators of
``cli/test_stages.py`` and ``cli/infer_unpaired.py`` on synthetic PNGs.

Small configuration: 32x32 input, ch=32, one res-block per level, K=2, L=1,
n_embed=64, float32; weights carried by ``flax_to_torch_stage2`` /
``flax_to_torch_vqgan``. Tolerances: 1e-3 relative to the largest output for
latent and image (float32 on both sides; ~30 convolutions, an 8-step flow and a
VQGAN decoder let 1e-6 rounding differences grow); zero codebook index flips on
the same latent; 1e-4 relative for the NLL (a mean over the batch of sums of
~200 float32 terms).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glare_tpu.modules.llflow_vqgan2 import LLFlowVQGAN2 as JLLFlow
from glare_tpu.modules.vqmodel import VQModel as JVQModel
from glare_tpu.utils import imgproc as jimgproc
from glare_tpu_torch import convert
from glare_tpu_torch.cli import infer_unpaired
from glare_tpu_torch.cli import test_stages as stages_cli
from glare_tpu_torch.measure import Measure
from glare_tpu_torch.models import create_model
from glare_tpu_torch.modules.flow_layers import GaussianDiag
from glare_tpu_torch.modules.llflow_vqgan2 import LLFlowVQGAN2
from glare_tpu_torch.utils.imgproc import auto_padding, imwrite
from glare_tpu_torch.utils import lpips as lpips_mod

from test_torch_stage3 import _opt as _opt3
from torch_port_util import fill_tree, nhwc, rel_err

MINI = dict(enc_ch=32, enc_num_res_blocks=1)
VQ = dict(ch=32, n_embed=64, num_res_blocks=1)


def _opt():
    return {
        "model": "LLFlow", "is_train": False,
        "datasets": {"train": {"quant": 32, "log_low": True}},
        "network_G": {"which_model_G": "LLFlowVQGAN2",
                      "flow": {"K": 2, "L": 1, "additionalFlowNoAffine": 2}, **MINI},
        "network_VQGAN": {"type": "VQModel", **VQ},
        "train": {"manual_seed": 1},
    }


@pytest.fixture(scope="module")
def pair():
    """(jax net, jax vq, their params, the port's model with the same weights, inputs)."""
    rng = np.random.default_rng(5)
    lq = np.log(np.clip(rng.uniform(0, 0.2, (2, 32, 32, 3)) + 1e-3, 1e-3, None)).astype(np.float32)
    gt = rng.uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
    jnet = JLLFlow(K=2, L=1, additional_flow_no_affine=2, **MINI)
    jvq = JVQModel(vq_backend="ref", **VQ)

    def shapes():
        key = jax.random.PRNGKey(0)
        vq_p = jvq.init(key, jnp.asarray(gt))["params"]
        net_p = jnet.init(key, jnp.zeros((2, 8, 8, 3)), jnp.asarray(lq),
                          method=JLLFlow.normal_flow)["params"]
        return vq_p, net_p

    vq_s, net_s = jax.eval_shape(shapes)
    vq_p, net_p = fill_tree(vq_s, rng), fill_tree(net_s, rng)
    vq_p["quantize"]["embedding"] = (0.5 * rng.standard_normal((64, 3))).astype(np.float32)
    model = create_model(_opt(), device="cpu")
    model.load_state_dicts(convert.flax_to_torch_stage2(net_p), convert.flax_to_torch_vqgan(vq_p))
    return jnet, jvq, net_p, vq_p, model, lq, gt


def test_get_sr_and_decode_latent_match_jax(pair):
    jnet, jvq, net_p, vq_p, model, lq, _ = pair

    @jax.jit
    def run(net_p, vq_p, x):
        lat, logdet = jnet.apply({"params": net_p}, x, method=JLLFlow.reverse_flow)
        dec, _, _ = jvq.apply({"params": vq_p}, lat, method=JVQModel.decode)
        return lat, logdet, dec

    jlat, jlogdet, jdec = (np.asarray(a) for a in run(net_p, vq_p, jnp.asarray(lq)))
    lat = model.get_sr(lq)
    assert lat.shape == (2, 8, 8, 3) and lat.dtype == torch.float32
    assert rel_err(lat.numpy(), jlat) < 1e-3
    dec = model.decode_latent(lat)
    assert dec.shape == (2, 32, 32, 3) and bool(torch.isfinite(dec).all())
    # stage-wise on the JAX latent: zero index flips, then the image
    dec_j = model.decode_latent(jlat)
    _, _, (_, _, jidx) = jvq.bind({"params": vq_p}).quantize(jnp.asarray(jlat))
    idx = model.net_hq.quantize.last_indices.numpy()
    assert int((idx != np.asarray(jidx)).sum()) == 0
    assert len(set(idx.tolist())) > 4, "the latent should hit several codes"
    assert rel_err(dec_j.numpy(), jdec) < 1e-3
    # and the module's own logdet of the reverse pass
    with torch.inference_mode():
        x = torch.from_numpy(lq).permute(0, 3, 1, 2)
        _, logdet = model.netG(x, reverse=True)
    assert rel_err(logdet.numpy(), jlogdet) < 1e-4


def test_get_encode_nll_matches_jax_normal_flow(pair):
    jnet, jvq, net_p, vq_p, model, lq, gt = pair

    @jax.jit
    def run(net_p, vq_p, lq, gt):
        h, _ = jvq.apply({"params": vq_p}, gt, method=JVQModel.encode)
        z, nll, logdet = jnet.apply({"params": net_p}, h, lq, method=JLLFlow.normal_flow)
        return h, z, nll, logdet

    jh, jz, jnll, jlogdet = (np.asarray(a) for a in run(net_p, vq_p, jnp.asarray(lq),
                                                        jnp.asarray(gt)))
    assert rel_err(model.encode_gt_latent(gt).numpy(), jh) < 2e-4
    got = model.get_encode_nll(lq, gt)
    assert abs(got - float(jnll.mean())) <= 1e-4 * abs(float(jnll.mean()))
    with torch.inference_mode():   # per-sample values on the JAX latent
        z, nll, logdet = model.netG.normal_flow(
            torch.from_numpy(jh).permute(0, 3, 1, 2), torch.from_numpy(lq).permute(0, 3, 1, 2))
    assert rel_err(nhwc(z), jz) < 1e-3
    assert rel_err(nll.numpy(), jnll) < 1e-4 and rel_err(logdet.numpy(), jlogdet) < 1e-4


def test_gaussian_diag_and_training_only_options():
    x = torch.tensor([[[[0.5, -1.0]]]])
    mean = torch.tensor([[[[0.0, 1.0]]]])
    want = -0.5 * ((0.25 + np.log(2 * np.pi)) + (4.0 + np.log(2 * np.pi)))
    assert abs(float(GaussianDiag.logp(mean, 0.0, x)) - want) < 1e-6
    assert abs(float(GaussianDiag.logp(None, None, x)) + 0.5 * (1.25 + 2 * np.log(2 * np.pi))) < 1e-6
    net = LLFlowVQGAN2(K=1, L=1, **MINI)
    g = torch.Generator().manual_seed(0)
    lr, gt = torch.randn(2, 3, 16, 16, generator=g), torch.randn(2, 3, 4, 4, generator=g)
    with torch.no_grad():
        _, nll0, logdet0 = net.normal_flow(gt, lr)
        # the ActNorm data-dependent init writes the statistics of this batch
        first = net.flowUpsamplerNet.layers[0].actnorm
        z, nll, logdet = net.normal_flow(gt, lr, ddinit=True)
        assert torch.allclose(first.bias.flatten(), -gt.mean(dim=(0, 2, 3)))
        assert not torch.equal(logdet, logdet0) and bool(torch.isfinite(nll).all())
        # uniform dequantization noise: the logdet gains -log(quant) * pixels
        z1, _, logdet1 = net.normal_flow(gt, lr, add_gt_noise=True,
                                         noise=torch.rand(gt.shape, generator=g))
        _, _, logdet2 = net.normal_flow(gt, lr, add_gt_noise=True, noise=torch.full_like(gt, 0.5))
        assert not torch.equal(z1, z)
        # without noise, drawn from the caller's generator (the JAX method's noise_rng)
        z3 = net.normal_flow(gt, lr, add_gt_noise=True, generator=torch.Generator().manual_seed(3))[0]
        u = torch.rand(gt.shape, generator=torch.Generator().manual_seed(3))
        assert torch.equal(z3, net.normal_flow(gt, lr, add_gt_noise=True, noise=u)[0])
        assert torch.allclose(logdet2 - logdet, torch.full((2,), -np.log(32.0) * 16), rtol=1e-5)
        _, ld = net.reverse_flow(lr, add_gt_noise=True)
        assert torch.allclose(ld - net.reverse_flow(lr)[1], torch.full((2,), np.log(32.0) * 256))
    trainer = create_model({**_opt(), "is_train": True,
                            "train": {"manual_seed": 1, "lr_G": 5e-4, "lr_scheme": "MultiStepLR"}},
                           device="cpu")
    assert [g["label"] for g in trainer.optimizer.param_groups] == ["other", "rrdb"]
    assert all(p.requires_grad for p in trainer.netG.parameters())
    assert not any(p.requires_grad for p in trainer.net_hq.parameters())
    assert set(net.encode_cond(lr)) == {"cond_feat", "color_map"}


def test_state_dict_has_the_reference_names_and_round_trips(pair, tmp_path):
    model = pair[4]
    keys = set(model.netG.state_dict())
    assert {k.split(".")[0] for k in keys} == {"RRDB", "flowUpsamplerNet"}
    assert "flowUpsamplerNet.layers.3.affine.fAffine.4.logs" in keys
    path = str(tmp_path / "7_G.pth")
    torch.save(model.netG.state_dict(), path)
    other = create_model(_opt(), device="cpu")
    lq = pair[5]
    assert not torch.equal(other.get_sr(lq), model.get_sr(lq))
    # the confs name the JAX package's .flax files: the port reads the .pth beside them
    other.load_network(str(tmp_path / "7_G.flax"))
    assert torch.equal(other.get_sr(lq), model.get_sr(lq))


def test_load_and_network_description(pair, tmp_path):
    """``load()``: the ``{iter}_G`` beside the newest resume state, else
    ``path.pretrain_model_G`` under ``path.strict_load`` (glare_tpu/models/
    llflow_model.py:265); ``get_network_description`` -> (class name, parameter count)."""
    model, lq = pair[4], pair[5]
    sd = model.netG.state_dict()
    path = str(tmp_path / "pre_G.pth")
    torch.save({k: v for k, v in sd.items() if not k.startswith("RRDB.")}, path)
    for strict_load in (True, False):
        other = create_model({**_opt(), "path": {"pretrain_model_G": path, "strict_load": strict_load}},
                             device="cpu")
        rrdb0 = other.netG.RRDB.state_dict()
        if strict_load:
            with pytest.raises(RuntimeError, match="RRDB"):
                other.load()
            continue
        other.load()
        got = other.netG.state_dict()
        assert all(torch.equal(got[k], v) for k, v in sd.items() if not k.startswith("RRDB."))
        assert all(torch.equal(other.netG.RRDB.state_dict()[k], v) for k, v in rrdb0.items())
    # a resume state wins, loaded strictly
    states, models = tmp_path / "training_state", tmp_path / "models"
    os.makedirs(states)
    (states / "3.state").write_bytes(b"")
    os.makedirs(models)
    torch.save(sd, str(models / "3_G.pth"))
    other = create_model({**_opt(), "path": {"resume_state": "auto", "training_state": str(states),
                                             "pretrain_model_G": path}}, device="cpu")
    other.load()
    assert torch.equal(other.get_sr(lq), model.get_sr(lq))
    name, n = model.get_network_description()
    assert name == "LLFlowModel" and n == sum(p.numel() for p in model.netG.parameters()) > 0
    assert model.get_network_description(model.net_hq)[1] == sum(p.numel() for p in model.net_hq.parameters())


def _write_pairs(root, n, h, w, seed):
    rng = np.random.default_rng(seed)
    lr_dir, hr_dir = os.path.join(root, "low"), os.path.join(root, "high")
    for i in range(n):
        hr = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        imwrite(os.path.join(hr_dir, f"{i}.png"), hr)
        imwrite(os.path.join(lr_dir, f"{i}.png"), (hr // 8).astype(np.uint8))
    names = [f"{i}.png" for i in range(n)]
    return [os.path.join(lr_dir, f) for f in names], [os.path.join(hr_dir, f) for f in names]


@pytest.mark.parametrize("stage", [2, 3])
def test_evaluate_once_on_synthetic_pairs(stage, tmp_path, pair, monkeypatch):
    pytest.importorskip("cv2")
    monkeypatch.delenv("GLARE_LPIPS_NPZ", raising=False)   # no LPIPS weights: the column is NaN
    monkeypatch.setattr(lpips_mod, "probe_lpips_cache", lambda: None)
    # stage 2 pads 30x26 to 32x28 (the latent stride); stage 3 pads 28x20 to 48x40
    h, w = (30, 26) if stage == 2 else (28, 20)
    lr_paths, hr_paths = _write_pairs(str(tmp_path), 2, h, w, seed=stage)
    if stage == 2:
        model, opt = pair[4], _opt()
    else:
        opt = {**_opt3("hybrid"), "datasets": {"train": {"log_low": True}}}
        model = create_model(opt, device="cpu")
    save_dir = str(tmp_path / "out")
    m = stages_cli.evaluate_once(stage, model, opt, lr_paths, hr_paths, Measure(device="cpu"),
                                 save_dir=save_dir)
    assert set(m) == {"PSNR", "SSIM", "PSNR_adj", "SSIM_adj", "LPIPS"}
    assert np.isnan(m.pop("LPIPS"))     # as the JAX CLI writes it without weights
    assert all(np.isfinite(v) for v in m.values())
    assert m["PSNR_adj"] >= m["PSNR"] - 1e-9 or m["PSNR"] > 0
    assert sorted(os.listdir(save_dir)) == ["0.png", "1.png"]


def test_checkpoint_sweep_over_pth_files(tmp_path, monkeypatch, pair):
    pytest.importorskip("cv2")
    pytest.importorskip("pandas")
    model = pair[4]
    lr_paths, hr_paths = _write_pairs(str(tmp_path / "data"), 1, 16, 16, seed=9)
    models_dir = tmp_path / "models"
    models_dir.mkdir()
    for it in (10, 2):
        torch.save(model.netG.state_dict(), str(models_dir / f"{it}_G.pth"))
    opt = {**_opt(), "dataroot_LR": os.path.dirname(lr_paths[0]),
           "dataroot_GT": os.path.dirname(hr_paths[0])}
    monkeypatch.setattr(stages_cli, "parse", lambda conf, is_train: dict(opt))
    devices = []
    real_create = stages_cli.create_model

    def create(o, device="cuda"):
        devices.append(device)
        return real_create(o, device=device)

    monkeypatch.setattr(stages_cli, "create_model", create)
    assert stages_cli.run_checkpoint_sweep(2, "unused.yml", str(tmp_path / "none"),
                                            device="cpu") is None
    df = stages_cli.run_checkpoint_sweep(2, "unused.yml", str(models_dir), device="cpu")
    assert devices == ["cpu", "cpu"]
    assert list(df["checkpoint"]) == ["2_G.pth", "10_G.pth"]      # natural order
    assert df["PSNR"].iloc[0] == df["PSNR"].iloc[1]                # the same weights
    assert os.path.exists(models_dir / "test_stage2_metrics.csv")
    # the command line: --stage and --device reach the sweep
    monkeypatch.setattr("sys.argv", ["test_stages", "--stage", "2", "--device", "cpu",
                                     "--models_dir", str(models_dir)])
    stages_cli.main()
    assert devices[-1] == "cpu"


def test_auto_padding_matches_the_jax_package_and_unpaired_keeps_the_shape():
    pytest.importorskip("cv2")
    rng = np.random.default_rng(2)
    for h, w in ((30, 26), (32, 48), (17, 33)):
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        got, pads = auto_padding(img, times=16)
        want, jpads = jimgproc.auto_padding(img, times=16)
        assert pads == jpads and np.array_equal(got, want)
        assert got.shape[0] % 16 == 0 and got.shape[1] % 16 == 0
    model = create_model(_opt3("xla"), device="cpu")
    img = rng.integers(0, 64, (30, 26, 3), dtype=np.uint8)
    out = infer_unpaired.enhance_image(model, img, apply_log=True)
    assert out.shape == img.shape and out.dtype == np.uint8
