"""The rest of the stage-1 tree (``glare_tpu_torch/sr/``) against the JAX package's,
on the CPU: SwinIR, ``arch_util``, DiffJPEG, ``filter2D`` / ``USMSharp`` /
``usm_sharp``, ``HazeOnlineDataset``, ``lmdb_util``, ``flow_util`` and
``face_util``; and the stage-1 trainer's semantic loss.

Small sizes and seeded numpy inputs; the JAX sides are jitted (or run eagerly
where they are a few operations), with no Pallas kernel. Tolerances:
  * SwinIR (``embed_dim`` 16, ``depths`` (2, 2), ``heads`` (2, 2), window 4,
    every head, 1conv and 3conv, a 16x18 input that is no window multiple) and
    ``arch_util``: within 1e-5 of the output's largest magnitude;
  * DiffJPEG (quality 20 and 90, a per-sample vector, 40x56): within 1e-5
    absolute on [0, 1], except in the image blocks of a coefficient within 1e-4
    of a rounding boundary, where the two may round apart; the gradient of the
    differentiable mode within 1e-4 of its largest;
  * filter2D / USMSharp: 1e-5 absolute (USM: outside the reach of a mask pixel
    that differs, each such pixel's residual within 1e-4 of the threshold);
    ``usm_sharp`` (host) bit-equal;
  * the host utilities (the seeded dataset items, the lmdb files and items,
    flow files, face crops and paste-back) bit-equal;
  * the semantic loss within 1e-5 relative, its gradients (z_q and the
    semantic head) within 1e-4 of each largest.
"""

import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glare_tpu.modules.losses import VGG16Features as JVGG16
from glare_tpu.sr.archs import arch_util as jau
from glare_tpu.sr.archs.swinir_arch import SwinIR as JSwinIR
from glare_tpu.sr.archs.vq_weight_arch import VQWeightDehazeNet as JNet
from glare_tpu.sr.data import haze_online_dataset as jhaze
from glare_tpu.sr.data.paired_image_dataset import PairedImageDataset as JPaired
from glare_tpu.sr.utils import diffjpeg as jjpeg
from glare_tpu.sr.utils import face_util as jface
from glare_tpu.sr.utils import flow_util as jflow
from glare_tpu.sr.utils import img_process_util as jimg
from glare_tpu.sr.utils import lmdb_util as jlmdb
from glare_tpu_torch import convert
from glare_tpu_torch.modules.losses import VGG16Features
from glare_tpu_torch.sr.archs import arch_util, build_network
from glare_tpu_torch.sr.archs.vq_weight_arch import VQWeightDehazeNet
from glare_tpu_torch.sr.data import build_dataloader, build_dataset
from glare_tpu_torch.sr.data import haze_online_dataset as haze
from glare_tpu_torch.sr.data.paired_image_dataset import PairedImageDataset
from glare_tpu_torch.sr.models.vq_model import semantic_loss
from glare_tpu_torch.sr.utils import diffjpeg, face_util, flow_util, img_process_util, lmdb_util

from torch_port_util import fill_tree, nchw, nhwc, rel_err

cv2 = pytest.importorskip("cv2")


def _shapes(module, *args, **kw):
    return jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args, **kw))["params"]


# ------------------------------------------------------------------ SwinIR --

SWIN_MINI = dict(embed_dim=16, depths=(2, 2), num_heads=(2, 2), window_size=4, mlp_ratio=2.0)


@pytest.mark.parametrize("upsampler,scale,resi,ape", [
    ("pixelshuffle", 2, "1conv", False),
    ("pixelshuffledirect", 3, "1conv", False),
    ("nearest+conv", 4, "3conv", False),
    ("", 1, "3conv", True),
], ids=["pixelshuffle_x2", "pixelshuffledirect_x3", "nearest_conv_x4_3conv", "denoise_3conv_ape"])
def test_swinir_matches_jax(upsampler, scale, resi, ape):
    rng = np.random.default_rng(11 + scale)
    hw = (16, 16) if ape else (16, 18)  # an ape network takes inputs of img_size
    x = rng.uniform(0, 1, (1, *hw, 3)).astype(np.float32)
    kw = dict(SWIN_MINI, upscale=scale, upsampler=upsampler, resi_connection=resi, ape=ape)
    jm = JSwinIR(**kw)
    params = fill_tree(_shapes(jm, jnp.asarray(x)), rng)
    want = np.asarray(jax.jit(lambda p, t: jm.apply({"params": p}, t))(params, x))
    net = build_network({"type": "SwinIR", "img_size": 16, **kw})  # through the port's registry
    net.load_state_dict(convert.flax_to_torch_swinir(params))
    with torch.no_grad():
        got = nhwc(net(nchw(x)))
    assert got.shape == want.shape == (1, hw[0] * scale, hw[1] * scale, 3)
    assert rel_err(got, want) <= 1e-5, rel_err(got, want)


def test_swinir_names_and_heads():
    names = set(build_network({"type": "SwinIR", **SWIN_MINI, "upscale": 4, "upsampler": "pixelshuffle"})
                .state_dict())
    assert {"conv_first.weight", "patch_embed.norm.weight", "norm.bias", "conv_after_body.weight",
            "conv_before_upsample.0.weight", "upsample.0.weight", "upsample.2.weight", "conv_last.weight",
            "layers.1.conv.weight", "layers.0.residual_group.blocks.1.attn.relative_position_bias_table",
            "layers.0.residual_group.blocks.0.mlp.fc2.bias"} <= names
    net = build_network({"type": "SwinIR", **SWIN_MINI, "upscale": 2, "upsampler": "pixelshuffledirect",
                         "resi_connection": "3conv"})
    assert {"upsample.0.weight", "conv_after_body.4.weight", "layers.0.conv.2.weight"} <= set(net.state_dict())
    with pytest.raises(ValueError, match="x4"):
        build_network({"type": "SwinIR", **SWIN_MINI, "upscale": 2, "upsampler": "nearest+conv"})


# --------------------------------------------------------------- arch_util --

@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
@pytest.mark.parametrize("align_corners", [True, False])
def test_flow_warp_matches_jax(mode, align_corners):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 9, 11, 3)).astype(np.float32)
    flow = (3.0 * rng.standard_normal((2, 9, 11, 2))).astype(np.float32)
    want = np.asarray(jax.jit(jau.flow_warp, static_argnums=(2, 3, 4))(x, flow, mode, "zeros", align_corners))
    got = nhwc(arch_util.flow_warp(nchw(x), torch.from_numpy(flow), mode, "zeros", align_corners))
    assert rel_err(got, want) <= 1e-5, rel_err(got, want)


@pytest.mark.parametrize("mode,align_corners,size_type,sizes", [
    ("bilinear", False, "ratio", (2.0, 1.5)), ("bilinear", True, "shape", (13, 7)),
    ("nearest", False, "shape", (13, 29)), ("nearest", False, "ratio", (0.5, 0.5))])
def test_resize_flow_matches_jax(mode, align_corners, size_type, sizes):
    flow = np.random.default_rng(6).standard_normal((2, 10, 12, 2)).astype(np.float32)
    want = np.asarray(jax.jit(jau.resize_flow, static_argnums=(1, 2, 3, 4))(flow, size_type, sizes, mode,
                                                                         align_corners))
    got = nhwc(arch_util.resize_flow(torch.from_numpy(flow).permute(0, 3, 1, 2), size_type, sizes, mode,
                                     align_corners))
    assert got.shape == want.shape
    assert rel_err(got, want) <= 1e-5, rel_err(got, want)
    with pytest.raises(ValueError):
        arch_util.resize_flow(torch.zeros(1, 2, 4, 4), "shape", (8, 8), "bicubic")


def test_arch_util_blocks():
    x = torch.randn(2, 8, 6, 4)
    assert torch.equal(arch_util.pixel_shuffle(arch_util.pixel_unshuffle(x, 2), 2), x)
    # the (c, sy, sx) channel order of the JAX module's NHWC pixel_unshuffle
    want = np.asarray(jau.pixel_unshuffle(jnp.asarray(x.permute(0, 2, 3, 1).numpy()), 2))
    assert np.array_equal(nhwc(arch_util.pixel_unshuffle(x, 2)), want)
    g = torch.Generator().manual_seed(0)
    blk = arch_util.ResidualBlockNoBN(num_feat=64)
    blk.conv1.seeded_reset(g)
    std = float(blk.conv1.weight.detach().std())
    assert abs(std - 0.1 * (2.0 / (64 * 9)) ** 0.5) < 0.005 * 0.1 and not blk.conv1.bias.detach().any()
    layer = arch_util.make_layer(arch_util.ResidualBlockNoBN, 2, num_feat=8)
    assert len(layer) == 2 and layer(torch.zeros(1, 8, 4, 4)).shape == (1, 8, 4, 4)
    up = arch_util.Upsample(4, 8)
    assert [n for n, _ in up.named_parameters()] == ["0.weight", "0.bias", "2.weight", "2.bias"]
    assert up(torch.zeros(1, 8, 3, 5)).shape == (1, 8, 12, 20)
    assert arch_util.Upsample(3, 8)(torch.zeros(1, 8, 3, 5)).shape == (1, 8, 9, 15)
    with pytest.raises(ValueError):
        arch_util.Upsample(5, 8)


# ----------------------------------------------------------------- DiffJPEG --

def _jpeg_flip_mask(x, quality, got, want, tol=1e-5):
    """Pixels outside the image blocks of coefficients that round differently
    between the two runs must agree within ``tol``; each such coefficient must lie
    within 1e-4 of a rounding boundary (read from the port's quotients). -> count."""
    quot, _, (hp, wp) = diffjpeg.quantized_coefficients(torch.from_numpy(x).permute(0, 3, 1, 2), quality)
    bad = np.abs(got - want).max(axis=-1) > tol  # [B, H, W]
    if not bad.any():
        return 0
    near = {}
    for name, q in quot.items():
        q = q.numpy()
        tie = np.abs(np.abs(q - np.floor(q)) - 0.5) < 1e-4
        blocks = tie.any(axis=(2, 3)).reshape(q.shape[0], (hp if name == "y" else hp // 2) // 8, -1)
        px = 8 if name == "y" else 16
        near[name] = np.kron(blocks, np.ones((px, px), bool))[:, :x.shape[1], :x.shape[2]]
    allowed = near["y"] | near["cb"] | near["cr"]
    assert not (bad & ~allowed).any(), "DiffJPEG differs away from a rounding near-tie"
    return int(bad.sum())


@pytest.mark.parametrize("differentiable", [True, False], ids=["diff", "hard"])
@pytest.mark.parametrize("quality", [20.0, 90.0, "vector"])
def test_diffjpeg_matches_jax(quality, differentiable):
    x = np.random.default_rng(7).uniform(0, 1, (2, 40, 56, 3)).astype(np.float32)
    q = np.array([30.0, 95.0], np.float32) if quality == "vector" else quality
    want = np.asarray(jjpeg.diff_jpeg(jnp.asarray(x), jnp.asarray(q), differentiable=differentiable))
    got = nhwc(diffjpeg.DiffJPEG(differentiable)(torch.from_numpy(x).permute(0, 3, 1, 2), torch.tensor(q)))
    assert got.shape == want.shape == x.shape
    _jpeg_flip_mask(x, torch.tensor(q), got, want)


def test_diffjpeg_gradient_matches_jax():
    rng = np.random.default_rng(8)
    x = rng.uniform(0, 1, (2, 24, 40, 3)).astype(np.float32)
    w = rng.standard_normal(x.shape).astype(np.float32)
    want = np.asarray(jax.grad(lambda t: jnp.sum(jjpeg.diff_jpeg(t, 50.0, differentiable=True) * w))(jnp.asarray(x)))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_(True)
    (diffjpeg.diff_jpeg(xt, 50.0) * torch.from_numpy(w).permute(0, 3, 1, 2)).sum().backward()
    got = xt.grad.permute(0, 2, 3, 1).numpy()
    assert rel_err(got, want) <= 1e-4, rel_err(got, want)


# ------------------------------------------------------ filter2D / USMSharp --

@pytest.mark.parametrize("per_sample", [False, True], ids=["shared", "per_sample"])
def test_filter2d_matches_jax(per_sample):
    rng = np.random.default_rng(9)
    img = rng.uniform(0, 1, (3, 30, 34, 3)).astype(np.float32)
    k = rng.uniform(0, 1, (3, 21, 21) if per_sample else (21, 21)).astype(np.float32)
    k /= k.sum(axis=(-2, -1), keepdims=True)
    want = np.asarray(jimg.filter2D(jnp.asarray(img), jnp.asarray(k)))
    got = nhwc(img_process_util.filter2D(torch.from_numpy(img).permute(0, 3, 1, 2), torch.from_numpy(k)))
    assert np.abs(got - want).max() <= 1e-5
    with pytest.raises(ValueError):
        img_process_util.filter2D(torch.zeros(1, 3, 8, 8), torch.zeros(4, 4))


def test_usm_sharp_matches_jax():
    rng = np.random.default_rng(10)
    img = np.clip(cv2.GaussianBlur(rng.uniform(0, 1, (2, 40, 56, 3)).astype(np.float32)[0], (5, 5), 0)[None]
                  + 0.05 * rng.standard_normal((2, 40, 56, 3)).astype(np.float32), 0, 1).astype(np.float32)
    jm, pm = jimg.USMSharp(), img_process_util.USMSharp()
    assert pm.radius == 51 and np.array_equal(pm.kernel[0].numpy(), np.asarray(jm.kernel))
    want = np.asarray(jm(jnp.asarray(img)))
    t = torch.from_numpy(img).permute(0, 3, 1, 2)
    got = nhwc(pm(t))
    bad = np.abs(got - want).max(axis=-1) > 1e-5
    if bad.any():  # only within reach of a mask pixel whose residual sits on the threshold
        residual, _ = pm.mask(t)
        near = (torch.abs(residual.abs() - 10 / 255) < 1e-4).float()
        reach = img_process_util.filter2D(near, pm.kernel).amax(dim=1) > 0
        assert not (torch.from_numpy(bad) & ~reach).any()
    assert np.mean(np.abs(got - img)) > 1e-3  # it did sharpen
    for i in range(2):  # the host version, bit-equal
        assert np.array_equal(img_process_util.usm_sharp(img[i]), jimg.usm_sharp(img[i]))


# ------------------------------------------------------- HazeOnlineDataset --

def _write_haze_folder(root, n=3, h=40, w=52):
    rng = np.random.default_rng(12)
    os.makedirs(root / "gt")
    os.makedirs(root / "depth")
    for i in range(n):
        img = cv2.resize(rng.integers(0, 256, (h // 4, w // 4, 3), dtype=np.uint8), (w, h))
        cv2.imwrite(str(root / "gt" / f"im{i}.png"), img)
        np.save(root / "depth" / f"im{i}.npy", rng.uniform(0, 10, (h, w)).astype(np.float32))
    return {"dataroot_gt": str(root / "gt"), "dataroot_depth": str(root / "depth")}


def test_gaussian_noise_every_branch_bit_equal():
    branches = set()
    img = np.random.default_rng(13).uniform(0, 1, (12, 10, 3)).astype(np.float32)
    for seed in range(12):
        random.seed(seed)
        np.random.seed(seed)
        random.randint(2, 25)
        r = np.random.rand()
        branches.add("color" if r > 0.6 else "gray" if r < 0.4 else "orth")
        outs = []
        for mod in (jhaze, haze):
            random.seed(seed)
            np.random.seed(seed)
            outs.append(mod.add_gaussian_noise(img))
        assert np.array_equal(outs[0], outs[1]), seed
    assert branches == {"color", "gray", "orth"}
    random.seed(3)
    a = jhaze.add_jpeg_noise(img)
    random.seed(3)
    assert np.array_equal(a, haze.add_jpeg_noise(img))


@pytest.mark.parametrize("phase", ["train", "val"])
def test_haze_dataset_items_bit_equal(tmp_path, phase):
    opt = {**_write_haze_folder(tmp_path), "phase": phase, "gt_size": 32, "type": "HazeOnlineDataset"}
    jds, ds = jhaze.HazeOnlineDataset(dict(opt)), build_dataset(opt)  # the port's registry
    assert isinstance(ds, haze.HazeOnlineDataset) and len(ds) == len(jds) == 3
    for seed in range(6):
        items = []
        for d in (jds, ds):
            random.seed(seed)
            np.random.seed(seed)
            items.append(d[seed % 3])
        for k in ("lq", "gt"):
            assert items[0][k].dtype == items[1][k].dtype == np.float32
            assert np.array_equal(items[0][k], items[1][k]), (seed, k)
        assert items[1]["gt"].shape == ((32, 32, 3) if phase == "train" else (40, 52, 3))
    batch = next(iter(build_dataloader(ds, {"phase": "train", "batch_size_per_gpu": 2}, seed=0)))
    assert batch["lq"].shape == ((2, 32, 32, 3) if phase == "train" else (2, 40, 52, 3))


# --------------------------------------------------------------- lmdb_util --

@pytest.fixture(scope="module")
def lmdb_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("lmdb")
    rng = np.random.default_rng(14)
    for sub in ("lq", "gt"):
        os.makedirs(root / sub)
        for i in range(3):
            cv2.imwrite(str(root / sub / f"img_{i}.png"), rng.integers(0, 256, (36, 44, 3), dtype=np.uint8))
    names = sorted(os.listdir(root / "gt"))
    keys = [os.path.splitext(n)[0] for n in names]
    for sub in ("lq", "gt"):
        jlmdb.make_lmdb_from_imgs(str(root / sub), str(root / f"j_{sub}.lmdb"), names, keys)
        lmdb_util.make_lmdb_from_imgs(str(root / sub), str(root / f"p_{sub}.lmdb"), names, keys,
                                      multiprocessing_read=sub == "gt", n_thread=2)
    return root, names, keys


def test_lmdb_files_bit_equal(lmdb_dirs):
    root, names, keys = lmdb_dirs
    for sub in ("lq", "gt"):
        for f in ("data.pack", "index.txt", "meta_info.txt"):
            a = open(root / f"j_{sub}.lmdb" / f, "rb").read()
            assert a == open(root / f"p_{sub}.lmdb" / f, "rb").read(), (sub, f)
    with pytest.raises(FileExistsError):
        lmdb_util.make_lmdb_from_imgs(str(root / "gt"), str(root / "p_gt.lmdb"), names, keys)
    with pytest.raises(ValueError):
        lmdb_util.make_lmdb_from_imgs(str(root / "gt"), str(root / "x.lmdb"), names, keys[:1])


@pytest.mark.parametrize("phase", ["train", "val"])
def test_lmdb_paired_dataset_bit_equal(lmdb_dirs, phase):
    root = lmdb_dirs[0]

    def opt(tag):
        return {"dataroot_lq": str(root / f"{tag}_lq.lmdb"), "dataroot_gt": str(root / f"{tag}_gt.lmdb"),
                "io_backend": {"type": "lmdb"}, "phase": phase, "gt_size": 24}

    jds, ds = JPaired(opt("j")), PairedImageDataset(opt("p"))
    assert len(ds) == len(jds) == 3
    for i in range(3):
        items = []
        for d in (jds, ds):
            random.seed(i)
            items.append(d[i])
        for k in ("lq", "gt"):
            assert np.array_equal(items[0][k], items[1][k]), (i, k)
    src = cv2.imread(str(root / "gt" / "img_1.png"))[:, :, ::-1].astype(np.float32) / 255.0
    if phase == "val":
        assert np.array_equal(ds[1]["gt"], src)


# --------------------------------------------------------------- flow_util --

def test_flow_util_bit_equal(tmp_path):
    flow = (np.random.default_rng(15).standard_normal((12, 16, 2)) * 0.2).astype(np.float32)
    for mod, tag in ((jflow, "j"), (flow_util, "p")):
        mod.flowwrite(flow, str(tmp_path / f"{tag}.flo"))
        mod.flowwrite(flow, str(tmp_path / f"{tag}_q" / "f.png"), quantize=True, concat_axis=1)
    for f in (".flo", "_q/f.png"):
        assert open(tmp_path / f"j{f}", "rb").read() == open(tmp_path / f"p{f}", "rb").read()
    assert np.array_equal(flow_util.flowread(str(tmp_path / "j.flo")), flow)
    got = flow_util.flowread(str(tmp_path / "p_q" / "f.png"), quantize=True, concat_axis=1)
    assert np.array_equal(got, jflow.flowread(str(tmp_path / "j_q" / "f.png"), quantize=True, concat_axis=1))
    for a, b in zip(flow_util.quantize_flow(flow, 0.05), jflow.quantize_flow(flow, 0.05)):
        assert np.array_equal(a, b) and a.dtype == np.uint8
    q = flow_util.quantize(flow[..., 0], -0.3, 0.3, 255)
    assert np.array_equal(flow_util.dequantize(q, -0.3, 0.3, 255), jflow.dequantize(q, -0.3, 0.3, 255))
    open(tmp_path / "bad.flo", "wb").write(b"XXXX")
    with pytest.raises(IOError):
        flow_util.flowread(str(tmp_path / "bad.flo"))
    with pytest.raises(ValueError):
        flow_util.quantize(flow, 1.0, 0.0, 255)


# --------------------------------------------------------------- face_util --

def test_face_util_bit_equal(tmp_path):
    assert np.array_equal(face_util.FFHQ_TEMPLATE_1024, jface.FFHQ_TEMPLATE_1024)
    rng = np.random.default_rng(16)
    src = rng.uniform(0, 100, (5, 2))
    dst = src @ np.array([[0.9, -0.3], [0.3, 0.9]]) + np.array([4.0, -2.0]) + rng.normal(0, 0.5, (5, 2))
    assert np.array_equal(face_util.estimate_similarity(src, dst), jface.estimate_similarity(src, dst))
    img = cv2.resize(rng.integers(0, 256, (30, 40, 3), dtype=np.uint8), (240, 180))
    outs = []
    for mod, tag in ((jface, "j"), (face_util, "p")):
        helper = mod.FaceRestorationHelper(upscale_factor=2, face_size=128)
        helper.input_img = img.copy()
        helper.all_landmarks_5 = [helper.face_template * 0.9 + np.array([40.0, 20.0])]
        helper.warp_crop_faces(save_cropped_path=str(tmp_path / tag / "crop.png"),
                               save_inverse_affine_path=str(tmp_path / tag / "inv.npy"))
        helper.add_restored_face(np.ascontiguousarray(helper.cropped_faces[0][:, :, ::-1]))
        helper.paste_faces_to_input_image(str(tmp_path / tag / "out.jpg"))
        outs.append((helper.cropped_faces[0], helper.inverse_affine_matrices[0],
                     cv2.imread(str(tmp_path / tag / "out.png")), np.load(tmp_path / tag / "inv_00.npy")))
    for a, b in zip(*outs):
        assert np.array_equal(a, b)
    with pytest.raises(ImportError, match="dlib"):
        face_util.FaceRestorationHelper(upscale_factor=2).init_dlib("a", "b", "c")


# --------------------------------------------------------- semantic loss --

@pytest.mark.parametrize("img_px", [32, 48], ids=["same_size", "resized"])
def test_semantic_loss_and_gradient_match_jax(img_px):
    """The stage-1 trainer's ``use_semantic_loss`` term (``glare_tpu/sr/models/
    vq_model.py:201-218``), on the same z_q (8x8x64) and image; at 48 px the
    VGG features (12x12) are resized to 8x8 (antialiased bilinear)."""
    rng = np.random.default_rng(17 + img_px)
    mini = dict(gt_resolution=32, codebook_params=((8, 64, 64),), use_semantic_loss=True)
    z_q = rng.standard_normal((2, 8, 8, 64)).astype(np.float32)
    img = rng.uniform(0, 1, (2, img_px, img_px, 3)).astype(np.float32)
    jnet, jvgg = JNet(**mini), JVGG16()
    sem_p = fill_tree(_shapes(jnet, jnp.asarray(z_q), method=jnet.semantic_embed), rng)
    vgg_p = fill_tree(_shapes(jvgg, jnp.asarray(img)), rng)

    def jax_term(zq, p):  # the JAX trainer's lines, as written there
        feat = jax.lax.stop_gradient(jvgg.apply({"params": vgg_p}, jnp.asarray(img))[-1])
        sem = jnet.apply({"params": p}, zq, method=jnet.semantic_embed)
        if feat.shape[1:3] != sem.shape[1:3]:
            feat = jax.image.resize(feat, (feat.shape[0],) + sem.shape[1:3] + (feat.shape[-1],), method="bilinear")
        return jnp.mean((sem.astype(jnp.float32) - feat.astype(jnp.float32)) ** 2) * 0.1

    want, (g_zq, g_p) = jax.value_and_grad(jax_term, argnums=(0, 1))(jnp.asarray(z_q), sem_p)
    net = VQWeightDehazeNet(**mini)
    missing = net.load_state_dict(convert.flax_to_torch_stage1(sem_p), strict=False)
    assert not missing.unexpected_keys
    vgg = VGG16Features()
    vgg.load_state_dict(convert.flax_to_torch_vgg16(vgg_p))
    zq_t = nchw(z_q).requires_grad_(True)
    got = semantic_loss(vgg, net, nchw(img), zq_t, 0.1)
    got.backward()
    assert abs(got.item() - float(want)) <= 1e-5 * abs(float(want))
    assert rel_err(nhwc(zq_t.grad), g_zq) <= 1e-4
    w = net.conv_semantic[0].weight.grad.permute(2, 3, 1, 0).numpy()
    assert rel_err(w, g_p["conv_semantic"]["kernel"]) <= 1e-4
    assert rel_err(net.conv_semantic[0].bias.grad.numpy(), g_p["conv_semantic"]["bias"]) <= 1e-4
