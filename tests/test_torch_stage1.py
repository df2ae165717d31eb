"""The stage-1 framework's modules in the port against the JAX package's, on the CPU.

Small configuration: ``tests/test_sr.py``'s (``gt_resolution`` 32, codebook
``[[8, 64, 64]]``: 256 channels at 32, 16 and 8 px, the codebook at 8 px;
UNet-SN ``num_in_ch`` 64, ``num_feat`` 32), batch 2, float32. Inputs come from a
numpy seed; weights are filled with numpy (``torch_port_util.fill_tree``) and
carried across by ``convert.flax_to_torch_stage1`` / ``flax_to_torch_vgg``. The
codebook is N(0, 1), its usage weight N(0, 0.1^2) so the LQ stage's weighted
distance moves the argmin.

Tolerances: every output within 1e-4 of its tensor's largest magnitude (the
codebook loss 1e-4 relative); codebook indices equal but where the float64
distances of the two codes agree to 1e-6 relative; the spectral ``u`` after an
updating forward within 1e-5; the WarpBlock's vjp (grad_x of both inputs, and
every parameter) within 1e-4 of each largest, with every DCN offset of the
forward more than 0.3 px off the integer grid (the DCNv2 derivative jumps
there: the offset heads give a half-integer bias plus a small input-dependent
part); GAN losses and their gradients 1e-6; the quantizer's loss 1e-5
relative. The LQ stage's train step is not run against JAX here: one JAX jit of
it would outrun the CPU budget of these files, so the LQ stage is held module
by module (its forward with GT indices, Swin, the WarpBlock vjp, the quantizer
with GT indices; its frozen set in ``test_torch_train_stage1.py``).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glare_tpu.modules.quantize import WeightedVectorQuantizer as JWVQ
from glare_tpu.modules.quantize import _gram_loss as jax_gram_loss
from glare_tpu.sr import losses as jax_losses
from glare_tpu.sr import metrics as jax_metrics
from glare_tpu.sr.archs.discriminator_arch import UNetDiscriminatorSN as JD
from glare_tpu.sr.archs.swin import RSTB as JRSTB
from glare_tpu.sr.archs.swin import SwinLayers as JSwin
from glare_tpu.sr.archs.vgg_arch import VGGFeatureExtractor as JVGG
from glare_tpu.sr.archs.vq_weight_arch import VQWeightDehazeNet as JNet
from glare_tpu.sr.archs.vq_weight_arch import WarpBlock as JWarp
from glare_tpu_torch import convert
from glare_tpu_torch.modules.deformable_decoder import WarpBlock
from glare_tpu_torch.modules.quantize import WeightedVectorQuantizer, _gram_loss
from glare_tpu_torch.sr import losses, metrics
from glare_tpu_torch.sr.archs.discriminator_arch import UNetDiscriminatorSN
from glare_tpu_torch.sr.archs.swin import RSTB, SwinLayers, window_partition, window_reverse
from glare_tpu_torch.sr.archs.vq_weight_arch import VQWeightDehazeNet
from glare_tpu_torch.sr.registry import Registry

from torch_port_util import fill_tree, nchw, nhwc

MINI = dict(gt_resolution=32, codebook_params=((8, 64, 64),), use_weight=True)


def _close(got, want, what, tol=1e-4):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1e-30), what


def _shapes(module, *args, **kw):
    return jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args, **kw))


def _near_tie_flips(z, emb, weight, got, want):
    """Indices that differ, each allowed only where the two codes' float64
    distances agree to 1e-6 relative. -> the number of flips."""
    z, emb = np.asarray(z, np.float64).reshape(-1, emb.shape[1]), np.asarray(emb, np.float64)
    d = (z ** 2).sum(1)[:, None] + (emb ** 2).sum(1)[None] - 2 * z @ emb.T
    if weight is not None:
        d = d * np.exp(np.asarray(weight, np.float64))[None]
    got, want = np.asarray(got).reshape(-1), np.asarray(want).reshape(-1)
    for t in np.nonzero(got != want)[0]:
        a, b = d[t, got[t]], d[t, want[t]]
        assert abs(a - b) <= 1e-6 * abs(b), (t, a, b)
    return int((got != want).sum())


def test_registries():
    import glare_tpu_torch.sr.archs as archs
    import glare_tpu_torch.sr.data as data
    import glare_tpu_torch.sr.models as models

    assert {"VQWeightDehazeNet", "UNetDiscriminatorSN"} <= set(archs.ARCH_REGISTRY.keys())
    assert "VQDehazeModel" in models.MODEL_REGISTRY
    assert {"PairedImageDataset", "SingleImageDataset"} <= set(data.DATASET_REGISTRY.keys())
    assert {"L1Loss", "PerceptualLoss", "GANLoss", "MultiScaleGANLoss"} <= set(losses.LOSS_REGISTRY.keys())
    r = Registry("t")

    @r.register()
    class Foo:
        pass

    with pytest.raises(KeyError):
        r.register(Foo)
    with pytest.raises(KeyError, match="Available"):
        r.get("Bar")


@pytest.mark.parametrize("lq_stage", [False, True], ids=["hq", "lq_gt_indices"])
def test_vq_weight_net_forward_matches_jax(lq_stage):
    rng = np.random.default_rng(3 + lq_stage)
    x = rng.uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
    jnet = JNet(LQ_stage=lq_stage, **MINI)
    params = fill_tree(_shapes(jnet, jnp.asarray(x))["params"], rng)
    params["quantize_group_0"]["embedding"] = rng.standard_normal((64, 64)).astype(np.float32)
    params["quantize_group_0"]["weight"] = (0.1 * rng.standard_normal(64)).astype(np.float32)
    gt_idx = [rng.integers(0, 64, (2, 8, 8)).astype(np.int32)] if lq_stage else None
    want = jax.jit(lambda p, x, g: jnet.apply({"params": p}, x, gt_indices=g, method=jnet.encode_and_decode))(
        params, x, None if gt_idx is None else [jnp.asarray(g) for g in gt_idx])
    net = VQWeightDehazeNet(LQ_stage=lq_stage, **MINI)
    net.load_state_dict(convert.flax_to_torch_stage1(params))
    with torch.no_grad():
        got = net.encode_and_decode(nchw(x), gt_indices=None if gt_idx is None else [torch.tensor(g) for g in gt_idx])
    _close(nhwc(got[0]), want[0], "out")
    if lq_stage:
        _close(nhwc(got[1]), want[1], "out_residual")
    else:
        assert got[1] is None and want[1] is None
    assert abs(float(got[2]) - float(want[2])) <= 1e-4 * abs(float(want[2]))
    _close(nhwc(got[3]), want[3], "feat_to_quant")
    weight = params["quantize_group_0"]["weight"] if lq_stage else None
    _near_tie_flips(want[3], params["quantize_group_0"]["embedding"], weight, got[5][0].numpy(), want[5][0])
    if not lq_stage:  # the codebook decoder alone
        idx = got[5][0]
        with torch.no_grad():
            img = net.decode_indices(idx)
        decode = jax.jit(lambda p, i: jnet.apply({"params": p}, i, method=jnet.decode_indices))
        _close(nhwc(img), decode(params, jnp.asarray(idx.numpy())), "decode_indices")


@pytest.mark.parametrize("which", ["swin_layers", "rstb_3conv"])
def test_swin_matches_jax(which):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 8, 8, 32)).astype(np.float32)  # 4 windows of 4x4: shifted windows
    if which == "swin_layers":
        jm = JSwin(embed_dim=32, blk_depth=2, num_heads=4, window_size=4)
        params = fill_tree(_shapes(jm, jnp.asarray(x))["params"], rng)
        want = jax.jit(lambda p, t: jm.apply({"params": p}, t))(params, x)
        sd = convert.flax_to_torch_stage1({"multiscale_encoder": {"swin_layers": params}})
        m = SwinLayers(embed_dim=32, blk_depth=2, num_heads=4, window_size=4)
        m.load_state_dict({k.split(".", 2)[2]: v for k, v in sd.items()})
        with torch.no_grad():
            got = nhwc(m(nchw(x)))
    else:
        tokens = jnp.asarray(x.reshape(2, 64, 32))
        jm = JRSTB(dim=32, depth=2, num_heads=4, window_size=4, resi_connection="3conv")
        params = fill_tree(_shapes(jm, tokens, (8, 8))["params"], rng)
        want = jax.jit(lambda p, t: jm.apply({"params": p}, t, (8, 8)))(params, tokens)
        sd = convert.flax_to_torch_stage1({"multiscale_encoder": {"swin_layers": {"swin_blk_0": params}}})
        m = RSTB(32, depth=2, num_heads=4, window_size=4, resi_connection="3conv")
        m.load_state_dict({k.split(".", 4)[4]: v for k, v in sd.items()})
        with torch.no_grad():
            got = m(torch.tensor(x.reshape(2, 64, 32)), (8, 8)).numpy()
    _close(got, want, which)
    w = torch.arange(2 * 8 * 8 * 3, dtype=torch.float32).reshape(2, 8, 8, 3)
    assert torch.equal(window_reverse(window_partition(w, 4), 4, 8, 8), w)


def test_warp_block_vjp_matches_jax_with_grad_x():
    rng = np.random.default_rng(11)
    c = 32
    x_vq = rng.standard_normal((2, 12, 12, c)).astype(np.float32)
    x_res = rng.standard_normal((2, 12, 12, c)).astype(np.float32)
    cot = rng.standard_normal((2, 12, 12, c)).astype(np.float32)
    jw = JWarp()
    params = fill_tree(_shapes(jw, jnp.asarray(x_vq), jnp.asarray(x_res))["params"], rng)
    # offsets = a half-integer bias in [-2.5, 2.5] + an input-dependent part of a few
    # hundredths (JAX channel order [dy(G*K) | dx(G*K) | mask(G*K)]): off the grid
    dcn = params["dcn"]
    dcn["conv_offset"]["kernel"] *= np.float32(0.05)
    dcn["conv_offset"]["bias"][:72] = rng.integers(-3, 3, 72) + np.float32(0.5)

    @jax.jit
    def vjp_fn(p, a, b, ct):
        out, vjp = jax.vjp(lambda p, a, b: jw.apply({"params": p}, a, b), p, a, b)
        return out, vjp(ct)

    out, (g_params, g_vq, g_res) = vjp_fn(params, x_vq, x_res, cot)

    def to_port(tree):
        sd = convert.flax_to_torch_stage1({"multiscale_decoder": {"warp_0": tree}})
        return {k[len("multiscale_decoder.warp.0."):]: v for k, v in sd.items()}

    w = WarpBlock(c, dcn_impl="xla")
    w.load_state_dict(to_port(jax.tree.map(np.asarray, params)))
    w.dcn.audit_offsets = True
    a = nchw(x_vq).requires_grad_(True)
    b = nchw(x_res).requires_grad_(True)
    y = w(a, b)
    off = w.dcn.last_offsets.detach()
    assert float((off - off.round()).abs().min()) > 0.3
    y.backward(nchw(cot))
    _close(nhwc(y), out, "forward")
    _close(nhwc(a.grad), g_vq, "grad x_vq (the DCN's x and the offset conv's input)")
    _close(nhwc(b.grad), g_res, "grad x_residual")
    want = to_port(jax.tree.map(np.asarray, g_params))
    for n, p in w.named_parameters():
        _close(p.grad.numpy(), want[n].numpy(), n)


def test_discriminator_forward_and_spectral_u_match_jax():
    rng = np.random.default_rng(13)
    x = rng.standard_normal((2, 8, 8, 64)).astype(np.float32)
    jd = JD(num_in_ch=64, num_feat=32)
    shapes = _shapes(jd, jnp.asarray(x))
    variables = {"params": fill_tree(shapes["params"], rng), "spectral": fill_tree(shapes["spectral"], rng)}
    want, new_vars = jax.jit(lambda v, t: jd.apply(v, t, update_stats=True, mutable=["spectral"]))(variables, x)
    want_frozen = jax.jit(lambda v, t: jd.apply(v, t, update_stats=False))(variables, x)
    d = UNetDiscriminatorSN(num_in_ch=64, num_feat=32)
    d.load_state_dict(convert.flax_to_torch_stage1(variables["params"], variables["spectral"]))
    u0 = {n: t.clone() for n, t in d.state_dict().items() if n.endswith(".u")}
    with torch.no_grad():
        got_frozen = d(nchw(x), update_stats=False)
        for n, t in d.state_dict().items():
            if n.endswith(".u"):
                assert torch.equal(t, u0[n]), n
        got = d(nchw(x), update_stats=True)
    _close(nhwc(got_frozen), want_frozen, "update_stats=False")
    _close(nhwc(got), want, "update_stats=True")
    new_u = convert.flax_to_torch_stage1(variables["params"], jax.tree.map(np.asarray, new_vars["spectral"]))
    for n, t in d.state_dict().items():
        if n.endswith(".u"):
            assert np.abs(t.numpy() - new_u[n].numpy()).max() <= 1e-5, n
            assert t.numel() == 1 or not torch.equal(t, u0[n]), n


@pytest.mark.parametrize("gan_type", ["vanilla", "lsgan", "wgan", "wgan_softplus", "hinge"])
def test_gan_loss_matches_jax(gan_type):
    pred = np.random.default_rng(17).standard_normal((2, 1, 4, 4)).astype(np.float32) * 2
    jl = jax_losses.GANLoss(gan_type=gan_type, loss_weight=0.1)
    pl = losses.GANLoss(gan_type=gan_type, loss_weight=0.1)
    for real in (True, False):
        for is_disc in (True, False):
            want, jgrad = jax.value_and_grad(lambda p: jl(p, real, is_disc=is_disc))(jnp.asarray(pred))
            t = torch.tensor(pred, requires_grad=True)
            got = pl(t, real, is_disc=is_disc)
            got.backward()
            assert abs(float(got) - float(want)) <= 1e-6 * max(1.0, abs(float(want))), (real, is_disc)
            assert np.abs(t.grad.numpy() - np.asarray(jgrad)).max() <= 1e-6, (real, is_disc)
    ms = losses.MultiScaleGANLoss(gan_type=gan_type)([torch.tensor(pred), [torch.tensor(pred)]], True)
    want = jax_losses.MultiScaleGANLoss(gan_type=gan_type)([jnp.asarray(pred), [jnp.asarray(pred)]], True)
    assert abs(float(ms) - float(want)) <= 1e-6 * max(1.0, abs(float(want)))


@pytest.mark.parametrize("case", ["hq", "lq_weighted", "lq_gt_indices"])
def test_weighted_quantizer_matches_jax(case):
    rng = np.random.default_rng(19)
    lq = case != "hq"
    z = rng.standard_normal((2, 4, 4, 16)).astype(np.float32)
    emb = rng.standard_normal((64, 16)).astype(np.float32)
    weight = (0.1 * rng.standard_normal(64)).astype(np.float32)
    gt = rng.integers(0, 64, (2, 4, 4)).astype(np.int32) if case == "lq_gt_indices" else None
    jq = JWVQ(n_e=64, e_dim=16, LQ_stage=lq, use_weight=True, weight_alpha=1.5)
    params = {"embedding": jnp.asarray(emb), "weight": jnp.asarray(weight)}

    def jloss(p, zz):
        zq, loss, idx = jq.apply({"params": p}, zz, gt_indices=None if gt is None else jnp.asarray(gt))
        return loss + 0.3 * jnp.sum(zq), (idx, loss)

    (_, (jidx, jl)), (jg_p, jg_z) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True))(params, z)
    q = WeightedVectorQuantizer(64, 16, LQ_stage=lq, use_weight=True, weight_alpha=1.5)
    with torch.no_grad():
        q.embedding.weight.copy_(torch.tensor(emb))
        q.weight.copy_(torch.tensor(weight))
    zt = nchw(z).requires_grad_(True)
    zq, loss, idx = q(zt, gt_indices=None if gt is None else torch.tensor(gt))
    (loss + 0.3 * zq.sum()).backward()
    assert _near_tie_flips(z, emb, 1.5 * weight if lq else None, idx.numpy(), jidx) == 0
    assert abs(float(loss) - float(jl)) <= 1e-5 * abs(float(jl))
    _close(nhwc(zt.grad), jg_z, "grad z (straight-through)")
    if gt is not None:  # the GT codes and the usage weight are stop-gradient: no gradient into the codebook
        assert q.embedding.weight.grad is None or float(q.embedding.weight.grad.abs().max()) == 0
        assert float(jnp.abs(jg_p["embedding"]).max()) == 0
    else:
        _close(q.embedding.weight.grad.numpy(), jg_p["embedding"], "grad embedding")
    a, b = rng.standard_normal((2, 2, 5, 5, 8)).astype(np.float32)
    assert abs(float(_gram_loss(torch.tensor(a), torch.tensor(b))) - float(jax_gram_loss(a, b))) <= \
        1e-5 * float(jax_gram_loss(a, b))


@pytest.mark.parametrize("criterion", ["l1", "fro"])
def test_pixel_and_perceptual_losses_match_jax(criterion):
    rng = np.random.default_rng(23)
    pred, target = rng.uniform(0, 1, (2, 2, 16, 16, 3)).astype(np.float32)
    w = rng.uniform(0, 1, (2, 16, 16, 3)).astype(np.float32)
    for name in ("L1Loss", "MSELoss", "CharbonnierLoss"):
        for red in ("mean", "sum"):
            jl = getattr(jax_losses, name)(loss_weight=0.5, reduction=red)
            want = jax.jit(lambda a, b, c: jl(a, b, weight=c))(pred, target, w)
            got = getattr(losses, name)(loss_weight=0.5, reduction=red)(nchw(pred), nchw(target), weight=nchw(w))
            assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want)), (name, red)
    want = jax.jit(lambda a, c: jax_losses.WeightedTVLoss(loss_weight=0.5)(a, weight=c))(pred, w)
    got = losses.WeightedTVLoss(loss_weight=0.5)(nchw(pred), weight=nchw(w))
    assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want))

    taps = {"relu1_2": 1.0, "relu2_2": 0.5, "relu3_3": 0.25}
    vgg = fill_tree(_shapes(JVGG(layer_name_list=list(taps)), jnp.asarray(pred))["params"], rng)
    kw = dict(layer_weights=taps, perceptual_weight=1.0, style_weight=0.5, criterion=criterion)
    jl = jax_losses.PerceptualLoss(**kw)
    jl.params = {"params": vgg}
    want = jax.jit(jl)(pred, target)
    got = losses.PerceptualLoss(params=convert.flax_to_torch_vgg(vgg), **kw)(nchw(pred), nchw(target))
    for g, wv, what in zip(got, want, ("perceptual", "style")):
        assert abs(float(g) - float(wv)) <= 1e-4 * abs(float(wv)), what


def test_r1_and_gradient_penalty_match_jax():
    rng = np.random.default_rng(29)
    x = rng.standard_normal((2, 8, 8, 8)).astype(np.float32)
    jd = JD(num_in_ch=8, num_feat=8)
    shapes = _shapes(jd, jnp.asarray(x))
    variables = {"params": fill_tree(shapes["params"], rng), "spectral": fill_tree(shapes["spectral"], rng)}
    want = jax.jit(lambda v, t: jax_losses.r1_penalty(lambda u: jd.apply(v, u, update_stats=False), t))(variables, x)
    d = UNetDiscriminatorSN(num_in_ch=8, num_feat=8)
    d.load_state_dict(convert.flax_to_torch_stage1(variables["params"], variables["spectral"]))
    got = losses.r1_penalty(lambda t: d(t, update_stats=False), nchw(x))
    assert abs(float(got) - float(want)) <= 1e-4 * abs(float(want))
    got.backward()  # differentiable in the discriminator's parameters (its weights; the biases drop out)
    assert all(p.grad is not None for n, p in d.named_parameters() if n.endswith("weight"))
    # a linear critic: |grad| is |w| everywhere, whatever the interpolates
    wl = torch.tensor(rng.standard_normal((1, 8, 8, 8)).astype(np.float32)).permute(0, 3, 1, 2)
    gp = losses.gradient_penalty_loss(lambda t: (t * wl).sum(dim=(1, 2, 3)), nchw(x), nchw(x[::-1].copy()),
                                      generator=torch.Generator().manual_seed(0))
    assert abs(float(gp) - (float(wl.norm()) - 1) ** 2) <= 1e-4 * (float(wl.norm()) - 1) ** 2


def test_metrics_match_jax_and_niqe_raises(monkeypatch):
    rng = np.random.RandomState(0)
    a = rng.randint(0, 256, (32, 32, 3), np.uint8)
    b = np.clip(a.astype(int) + rng.randint(-8, 8, a.shape), 0, 255).astype(np.uint8)
    for kw in ({}, {"crop_border": 2, "test_y_channel": True}):
        assert abs(metrics.calculate_psnr(a, b, **kw) - jax_metrics.calculate_psnr(a, b, **kw)) <= 1e-9
        assert abs(metrics.calculate_ssim(a, b, **kw) - jax_metrics.calculate_ssim(a, b, **kw)) <= 1e-9
    assert metrics.build_metric("calculate_psnr") is metrics.calculate_psnr
    # NIQE: computed where JAX computes (pristine parameters given; here fitted on a
    # seeded 192x192 field), JAX's informative error without them (GLARE_NIQE_PARAMS unset)
    from glare_tpu_torch.utils.niqe import fit_niqe_params

    field = rng.rand(192, 192)
    field = np.round(255.0 * (field - field.min()) / (field.max() - field.min()))
    pris = fit_niqe_params([field])
    img = rng.randint(0, 256, (96, 100, 3), np.uint8)
    got = metrics.build_metric("calculate_niqe")(img, pris_params=pris)
    assert np.isfinite(got) and abs(got - jax_metrics.calculate_niqe(img, pris_params=pris)) <= 1e-10 * got
    monkeypatch.delenv("GLARE_NIQE_PARAMS", raising=False)
    with pytest.raises(NotImplementedError, match="NIQE"):
        metrics.calculate_niqe(np.zeros((8, 8, 3)))


def test_datasets_and_file_client(tmp_path, monkeypatch):
    import cv2

    from glare_tpu_torch.sr.data import build_dataloader, build_dataset
    from glare_tpu_torch.sr.utils.file_client import FileClient, imfrombytes

    rng = np.random.RandomState(0)
    for sub in ("lq", "gt"):
        os.makedirs(tmp_path / sub)
        for i in range(3):
            cv2.imwrite(str(tmp_path / sub / f"{i}.png"), rng.randint(0, 255, (20, 24, 3), np.uint8))
    img = cv2.imread(str(tmp_path / "gt" / "0.png"))
    assert np.array_equal(imfrombytes(FileClient("disk").get(str(tmp_path / "gt" / "0.png"))), img)
    with pytest.raises(ValueError):
        FileClient("s3")
    opt = {"type": "PairedImageDataset", "phase": "train", "dataroot_lq": str(tmp_path / "lq"),
           "dataroot_gt": str(tmp_path / "gt"), "gt_size": 16, "batch_size_per_gpu": 2}
    batch = next(iter(build_dataloader(build_dataset(opt), opt, seed=1)))
    assert batch["lq"].shape == batch["gt"].shape == (2, 16, 16, 3) and batch["gt"].dtype == np.float32
    val = build_dataset({**opt, "phase": "val"})[0]
    assert np.allclose(val["gt"], img[:, :, ::-1] / 255.0)

    # the portable .lmdb layout (data.pack + index.txt) reads without the lmdb package
    db = tmp_path / "x.lmdb"
    os.makedirs(db)
    (db / "data.pack").write_bytes(b"helloworld")
    (db / "index.txt").write_text("a\t0\t5\nb\t5\t5\n")
    fc = FileClient("lmdb", db_paths=[str(db)], client_keys=["gt"])
    assert bytes(fc.get("b", "gt")) == b"world"
    monkeypatch.setitem(__import__("sys").modules, "lmdb", None)
    with pytest.raises(ImportError, match="lmdb"):
        FileClient("lmdb", db_paths=[str(tmp_path / "gt")], client_keys=["gt"])


def test_model_test_pads_to_32_and_tiles(tmp_path):
    from glare_tpu_torch.sr.models import build_model

    model = build_model({"model_type": "VQDehazeModel", "is_train": False, "manual_seed": 0,
                         "network_g": {"type": "VQWeightDehazeNet", "gt_resolution": 32,
                                       "codebook_params": [[8, 64, 64]]}, "path": {}}, device="cpu")
    rng = np.random.default_rng(31)
    for h, w, ph, pw in ((40, 52, 64, 64), (32, 32, 64, 64)):  # a multiple of 32 still gains 32
        lq = rng.uniform(0, 1, (1, h, w, 3)).astype(np.float32)
        out = model.test(lq)
        pad = np.concatenate([lq, lq[:, ::-1]], 1)[:, :ph]
        pad = np.concatenate([pad, pad[:, :, ::-1]], 2)[:, :, :pw]
        with torch.no_grad():
            want = model.net_g.encode_and_decode(nchw(pad))[0]
        assert out.shape == (1, h, w, 3)
        assert torch.equal(out, want.permute(0, 2, 3, 1)[:, :h, :w])
    assert np.array_equal(model.test_tile(lq, tile_size=64), out.numpy())
    tiled = model.test_tile(lq, tile_size=16, tile_pad=4)
    assert tiled.shape == (1, 32, 32, 3) and np.isfinite(tiled).all()
