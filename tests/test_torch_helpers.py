"""The last pieces of the port against the JAX package, on the CPU: the
prefetching loader, the wandb hook of ``sr.train`` and the public helpers.

``PrefetchDataLoader`` gives the plain loader's batches in its order, and JAX's
``PrefetchDataLoader``'s, bit for bit over two epochs, with a dataset that draws
from Python's and numpy's global RNG as ``HazeOnlineDataset`` does; with an
``EnlargedSampler`` (``set_epoch`` before each epoch) it gives the plain loader's.
An exception in its thread reaches the loop (JAX's loop would wait forever), and
a loop that stops early leaves no thread reading the dataset. Without the wandb
package ``sr.train`` logs the JAX package's warning, makes its tensorboard
logger and trains. The helpers: ``options.save_opt`` / ``check_resume``,
``utils.timer.ScopeTimer``, ``nn.ResBlockGN`` through ``convert`` (1e-5 of the
output's largest), the float64 DCN loop oracle (1e-12), ``utils.imgproc``'s
batch helpers and ``utils.util.copy_tree_once``; the names the port lacked until
then: ``ops.dcn.deform_conv`` (1e-5 of the output's largest; the strides, paddings
and dilations the port's op does not take raise), the ``modules.quantize.VectorQuantizer``
alias (the same class on both sides; a forward through it, bit-equal indices and
1e-6 of the output) and ``utils.imgproc.random_resize`` (bit-equal). The chain
op is held in ``tests/test_torch_dcn_bwd.py``, beside its compiled vjp.
"""

import logging
import os
import random
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from glare_tpu.data import loader as jax_loader
from glare_tpu.nn.layers import ResBlockGN as JResBlockGN
from glare_tpu.modules import quantize as jax_quantize
from glare_tpu.ops.dcn import deform_conv as jax_deform_conv
from glare_tpu.ops.dcn import modulated_deform_conv_naive as jax_naive
from glare_tpu.options import options as jax_options
from glare_tpu.sr.data import build_dataloader as jax_build_dataloader
from glare_tpu.utils import imgproc as jax_imgproc
from glare_tpu.utils import timer as jax_timer
from glare_tpu.utils import util as jax_util
from glare_tpu_torch import convert
from glare_tpu_torch.data.loader import DataLoader, PrefetchDataLoader
from glare_tpu_torch.nn import ResBlockGN
from glare_tpu_torch.modules import quantize
from glare_tpu_torch.ops.dcn import deform_conv, modulated_deform_conv_naive
from glare_tpu_torch.options import options
from glare_tpu_torch.parallel.mesh import EnlargedSampler
from glare_tpu_torch.sr.data import build_dataloader
from glare_tpu_torch.sr.utils.logger import init_wandb_logger
from glare_tpu_torch.utils import imgproc, timer, util

from test_torch_train_stage1 import _opt as _stage1_opt
from test_torch_train_stage1 import _write_images
from torch_port_util import fill_tree


class _RandomDraws:
    """Items drawn from the global RNGs, as the haze dataset's are."""

    def __init__(self, n=10, fail_at=None):
        self.n, self.fail_at = n, fail_at

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        if i == self.fail_at:
            raise ValueError(f"item {i} is broken")
        return {"lq": np.random.rand(4, 4, 3).astype(np.float32) + i,
                "gt": np.full((4, 4, 3), random.random(), np.float32), "key": f"{i:03d}"}


def _epochs(make_loader, sampler=None, epochs=2):
    random.seed(3)
    np.random.seed(3)
    loader, out = make_loader(), []
    for epoch in range(epochs):
        if sampler is not None:
            sampler.set_epoch(epoch)
        out += list(loader)
    return loader, out


def _equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            if isinstance(w[k], np.ndarray):
                assert np.array_equal(g[k], w[k]), k
            else:
                assert g[k] == w[k], k


DATA_OPT = {"phase": "train", "batch_size_per_gpu": 3}


def test_prefetch_batches_equal_plain_and_jax_over_two_epochs():
    ds = _RandomDraws()
    pre, got = _epochs(lambda: build_dataloader(ds, {**DATA_OPT, "prefetch_mode": "cpu"}, seed=5))
    assert isinstance(pre, PrefetchDataLoader) and len(pre) == 3
    plain, want = _epochs(lambda: build_dataloader(ds, DATA_OPT, seed=5))
    assert isinstance(plain, DataLoader)
    jpre, jax_want = _epochs(lambda: jax_build_dataloader(ds, {**DATA_OPT, "prefetch_mode": "cpu"}, seed=5))
    assert isinstance(jpre, jax_loader.PrefetchDataLoader) and len(jpre) == len(pre)
    assert len(got) == 6
    _equal(got, want)
    _equal(got, jax_want)
    assert [b["key"] for b in got[:3]] != [b["key"] for b in got[3:]]  # each epoch its own shuffle


def test_prefetch_with_an_enlarged_sampler_equals_the_plain_loader():
    ds = _RandomDraws(7)
    batches = {}
    for prefetch in (False, True):
        sampler = EnlargedSampler(len(ds), 2, 1, ratio=2)
        opt = {**DATA_OPT, "prefetch_mode": "cpu" if prefetch else None}
        loader, batches[prefetch] = _epochs(lambda: build_dataloader(ds, opt, seed=0, sampler=sampler),
                                            sampler)
        assert len(loader) == 7 // 3
        sampler.set_epoch(0)
        order = [f"{i:03d}" for i in sampler.indices()]
        assert [k for b in batches[prefetch][:2] for k in b["key"]] == order[:6]
    _equal(batches[True], batches[False])


def _consume(loader, result, stop_after=None):
    def run():
        try:
            for n, _ in enumerate(loader, start=1):
                if n == stop_after:
                    break
            result["done"] = True
        except ValueError as exc:
            result["raised"] = exc

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(5.0)
    return t


def test_a_producer_exception_reaches_the_loop():
    result = {}
    loader = PrefetchDataLoader(DataLoader(_RandomDraws(fail_at=4), batch_size=2))
    t = _consume(loader, result)
    assert not t.is_alive(), "the loop still waits after 5 s"
    assert "broken" in str(result.get("raised")), result


def test_a_loop_that_stops_early_stops_the_thread():
    result, before = {}, set(threading.enumerate())
    loader = PrefetchDataLoader(DataLoader(_RandomDraws(40), batch_size=2), num_prefetch=2)
    t = _consume(loader, result, stop_after=1)
    assert not t.is_alive() and result.get("done")
    assert not [th for th in set(threading.enumerate()) - before if th.name == "PrefetchDataLoader"]


class _Records(logging.Handler):
    def __init__(self):
        super().__init__(logging.WARNING)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


JAX_WANDB_WARNING = ("wandb logger requested (logger.wandb.project) but the wandb package is not "
                     "installed; continuing with tensorboard only")


def test_wandb_hook_without_wandb_warns_as_jax_and_train_goes_on(tmp_path, monkeypatch):
    """``init_wandb_logger`` returns None with the JAX package's warning, and
    ``sr.train`` (``use_tb_logger``, ``logger.wandb.project``, a name without
    ``debug``) writes it to its log, makes its tensorboard logger and trains."""
    from glare_tpu_torch.sr import train as sr_train

    monkeypatch.setitem(sys.modules, "wandb", None)
    monkeypatch.setitem(sys.modules, "tensorflow", None)  # tensorboard's writer runs without it, in seconds
    opt = {"name": "wandb_run", "logger": {"wandb": {"project": "glare"}}}
    handler = _Records()
    logging.getLogger("base").addHandler(handler)
    try:
        assert init_wandb_logger(opt) is None
    finally:
        logging.getLogger("base").removeHandler(handler)
    assert handler.messages == [JAX_WANDB_WARNING]
    with pytest.raises(ImportError):
        import wandb  # noqa: F401
    with monkeypatch.context() as mp:
        mp.setattr(logging.getLogger("glare_tpu.sr"), "warning", handler.messages.append)
        from glare_tpu.sr.utils.logger import init_wandb_logger as jax_init_wandb_logger

        assert jax_init_wandb_logger(opt) is None
    assert handler.messages == [JAX_WANDB_WARNING] * 2

    _write_images(str(tmp_path / "high"), ["1.png", "2.png"], np.random.default_rng(8))
    conf = _stage1_opt(str(tmp_path))
    del conf["is_train"], conf["path"]
    conf["train"].pop("perceptual_opt")
    conf["train"]["total_iter"] = 1
    conf.update({
        "name": "wandb_run", "scale": 1, "val": None, "path": {"resume_state": None},
        "datasets": {"train": {"name": "hq", "type": "SingleImageDataset", "dataroot_gt": str(tmp_path / "high"),
                               "gt_size": 32, "batch_size_per_gpu": 2, "prefetch_mode": "cpu"}},
        "logger": {"print_freq": 1, "save_checkpoint_freq": 10, "use_tb_logger": True,
                   "wandb": {"project": "glare", "resume_id": None}}})
    path = tmp_path / "stage1.yml"
    path.write_text(yaml.safe_dump(conf))
    monkeypatch.setenv("GLARE_ROOT", str(tmp_path))
    model, it = sr_train.train_pipeline(argv=["-opt", str(path), "--device", "cpu"])
    root = tmp_path / "experiments" / "wandb_run"
    assert it == 1 and all(np.isfinite(v) for v in model.get_current_log().values())
    log = "".join(p.read_text() for p in root.glob("train_*.log"))
    assert JAX_WANDB_WARNING in log
    assert any((root / "tb_logger").iterdir()), "no tensorboard event file"
    assert (root / "models" / "net_g_1.pth").exists()


def test_save_opt_and_check_resume_match_jax(tmp_path):
    opt = options.dict_to_nonedict({
        "name": "x", "gpu_ids": (0, 1), "train": {"lr_steps": [1, 2], "niter": 10.5},
        "path": {"models": "/m", "resume_state": "/s/7.state", "pretrain_model_G": "/p.pth"}})
    options.save_opt(opt, tmp_path / "port.yml")
    jax_options.save_opt(opt, tmp_path / "jax.yml")
    port = yaml.safe_load((tmp_path / "port.yml").read_text())
    assert port == yaml.safe_load((tmp_path / "jax.yml").read_text())
    assert port["gpu_ids"] == [0, 1] and "!!python" not in (tmp_path / "port.yml").read_text()
    for resume in ("/s/7.state", None):
        got, want = ({**opt, "path": {**opt["path"], "resume_state": resume}} for _ in range(2))
        options.check_resume(got, 7)
        jax_options.check_resume(want, 7)
        assert got == want
    assert got["path"]["pretrain_model_G"] == "/p.pth"
    options.check_resume(opt, 7)
    assert opt["path"]["pretrain_model_G"] == os.path.join("/m", "7_G")


def test_scope_timer_matches_jax(capsys, monkeypatch):
    for mod in (timer, jax_timer):
        clock = iter([10.0, 12.5])
        monkeypatch.setattr(mod.time, "time", lambda: next(clock))
        with pytest.raises(KeyError):
            with mod.ScopeTimer("load") as t:
                raise KeyError("the block's error passes through")
        assert t.dt == 2.5
    out = capsys.readouterr().out.splitlines()
    assert out == ["load 2.5000s", "load 2.5000s"]


@pytest.mark.parametrize("cin, cout", [(32, 32), (32, 64)])
def test_resblock_gn_through_convert_matches_jax(cin, cout):
    rng = np.random.default_rng(cin + cout)
    x = rng.standard_normal((2, 8, 8, cin)).astype(np.float32)
    net = JResBlockGN(out_channels=cout)
    params = fill_tree(jax.eval_shape(lambda: net.init(jax.random.PRNGKey(0), jnp.asarray(x)))["params"], rng)
    want = np.asarray(net.apply({"params": params}, jnp.asarray(x)))
    port = ResBlockGN(cin, cout)
    port.load_state_dict(convert.flax_to_torch_resblock_gn(params))
    assert hasattr(port, "conv_out") == (cin != cout)
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_naive_dcn_oracle_matches_jax_in_float64():
    rng = np.random.default_rng(2)
    B, H, W, C, G, O = 1, 4, 5, 4, 2, 3
    x = rng.standard_normal((B, H, W, C))
    offset = rng.uniform(-2.5, 2.5, (B, H, W, G, 9, 2))
    offset[0, 0, 0, 0, 0] = (-1.0, 0.0)            # on the border of (-1, H): contributes 0
    mask = rng.uniform(0, 1, (B, H, W, G, 9))
    weight = rng.standard_normal((3, 3, C, O))
    bias = rng.standard_normal(O)
    want = jax_naive(x, offset, mask, weight, bias)
    got = modulated_deform_conv_naive(torch.from_numpy(x), torch.from_numpy(offset), mask, weight, bias)
    assert got.dtype == torch.float64 and got.shape == (B, H, W, O)
    assert np.abs(got.numpy() - want).max() <= 1e-12 * np.abs(want).max()


def test_imgproc_batch_helpers_match_jax():
    img = np.random.default_rng(4).integers(0, 256, (5, 6, 3), dtype=np.uint8)
    f = imgproc.to_float01(img)
    assert f.dtype == np.float32 and np.array_equal(f, jax_imgproc.to_float01(img))
    b = imgproc.to_nhwc_batch(f * 1.5 - 0.2)
    assert b.shape == (1, 5, 6, 3) and np.array_equal(b, jax_imgproc.to_nhwc_batch(f * 1.5 - 0.2))
    for x in (b, b[0], torch.from_numpy(b)):
        assert np.array_equal(imgproc.from_nhwc_batch(x), jax_imgproc.from_nhwc_batch(np.asarray(x)))
    assert imgproc.from_nhwc_batch(b).min() == 0.0 and imgproc.from_nhwc_batch(b).max() == 1.0


def test_copy_tree_once_matches_jax(tmp_path):
    src = tmp_path / "src"
    (src / "sub").mkdir(parents=True)
    (src / "sub" / "a.txt").write_text("one")
    for fn, dst in ((util.copy_tree_once, tmp_path / "port"), (jax_util.copy_tree_once, tmp_path / "jax")):
        fn(str(src), str(dst))
        (src / "sub" / "a.txt").write_text("two")
        fn(str(src), str(dst))                       # exists: not copied again
        assert (dst / "sub" / "a.txt").read_text() == "one"
        (src / "sub" / "a.txt").write_text("one")


def test_deform_conv_matches_jax_and_refuses_other_geometry():
    rng = np.random.default_rng(6)
    B, H, W, C, G, O = 1, 16, 16, 8, 4, 6
    x = rng.standard_normal((B, H, W, C)).astype(np.float32)
    offset = (1.5 * rng.standard_normal((B, H, W, G, 9, 2))).astype(np.float32)
    weight = (0.2 * rng.standard_normal((3, 3, C, O))).astype(np.float32)
    bias = rng.standard_normal(O).astype(np.float32)
    want = np.asarray(jax_deform_conv(*map(jnp.asarray, (x, offset, weight, bias))))
    got = deform_conv(*map(torch.from_numpy, (x, offset, weight, bias))).numpy()
    assert got.shape == want.shape == (B, H, W, O)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    for kw in ({"stride": 2}, {"padding": 0}, {"dilation": 2}):
        with pytest.raises(NotImplementedError):
            deform_conv(*map(torch.from_numpy, (x, offset, weight)), **kw)


def test_vector_quantizer_alias_matches_jax():
    assert quantize.VectorQuantizer is quantize.VectorQuantizer2
    assert jax_quantize.VectorQuantizer is jax_quantize.VectorQuantizer2
    rng = np.random.default_rng(7)
    z = rng.standard_normal((2, 3, 16, 16)).astype(np.float32)   # NCHW, as the port takes it
    codebook = rng.standard_normal((64, 3)).astype(np.float32)
    jvq = jax_quantize.VectorQuantizer(n_e=64, e_dim=3, backend="ref")
    zq_j, loss_j, (_, _, idx_j) = jvq.apply({"params": {"embedding": jnp.asarray(codebook)}},
                                            jnp.asarray(z.transpose(0, 2, 3, 1)))
    vq = quantize.VectorQuantizer(n_e=64, e_dim=3)
    vq.embedding.weight.data.copy_(torch.from_numpy(codebook))
    with torch.no_grad():
        zq, loss, (_, _, idx) = vq(torch.from_numpy(z))
    assert np.array_equal(idx.numpy().reshape(-1), np.asarray(idx_j).reshape(-1))
    assert np.abs(zq.numpy().transpose(0, 2, 3, 1) - np.asarray(zq_j)).max() <= 1e-6
    assert abs(float(loss) - float(loss_j)) <= 1e-6 * abs(float(loss_j))


@pytest.mark.parametrize("scale", [0.5, 1.5])
def test_random_resize_matches_jax(scale):
    img = np.random.default_rng(8).integers(0, 256, (16, 24, 3), dtype=np.uint8)
    for a in (img, img.astype(np.float32) / 255.0):
        got, want = imgproc.random_resize(a, scale), jax_imgproc.random_resize(a, scale)
        assert got.dtype == want.dtype and np.array_equal(got, want)



def test_stage1_options_num_gpu_auto_and_force_yml_match_jax(tmp_path):
    """``num_gpu: auto`` is the count of the devices the process trains on (JAX:
    ``jax.device_count()``, here the virtual CPU devices the tests' XLA flags make;
    the port: its cards, 1 with ``--device cpu``); ``--force_yml a:b=value``
    overrides a conf value read as YAML, as JAX's ``parse_options`` does."""
    from glare_tpu.sr.utils.options import parse_options as jax_parse
    from glare_tpu_torch.sr.utils.options import parse_options

    conf = tmp_path / "s1.yml"
    conf.write_text(yaml.safe_dump({"name": "s1", "num_gpu": "auto", "manual_seed": 3,
                                    "train": {"ema_decay": 0.9, "optim_g": {"lr": 1e-4}}}))
    argv = ["-opt", str(conf), "--force_yml", "train:ema_decay=0.999", "train:optim_g:lr=2e-4"]
    got, _ = parse_options(str(tmp_path), is_train=False, argv=argv + ["--device", "cpu"])
    want, _ = jax_parse(str(tmp_path), is_train=False, argv=argv)
    assert got["num_gpu"] == 1 and want["num_gpu"] == jax.device_count()
    assert got["train"]["ema_decay"] == want["train"]["ema_decay"] == 0.999
    assert got["train"]["optim_g"]["lr"] == want["train"]["optim_g"]["lr"] == "2e-4"   # YAML 1.1


def test_stage1_base_model_jax_names(tmp_path):
    """``BaseSRModel.load_network_params`` (strict and loose), ``resume_training_state``,
    ``model_ema_flat`` (against JAX's on the same tensors) and
    ``VQWeightDehazeNet.codebook_scale`` (against the flax property)."""
    from glare_tpu.sr.archs.vq_weight_arch import VQWeightDehazeNet as JNet
    from glare_tpu.sr.models.base_model import BaseSRModel as JBase
    from glare_tpu_torch.sr.archs.vq_weight_arch import VQWeightDehazeNet
    from glare_tpu_torch.sr.models.base_model import BaseSRModel

    base = BaseSRModel({"path": {"models": str(tmp_path / "m"), "training_states": str(tmp_path / "s")}},
                       device="cpu")
    net = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.Linear(4, 2))
    path = base.save_network([net.state_dict()], "g", 7)
    other = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.Linear(4, 2))
    loaded = base.load_network_params(path, other)
    assert all(torch.equal(loaded[k], v) for k, v in net.state_dict().items())
    wider = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.Linear(4, 5))
    with pytest.raises(RuntimeError, match="1.weight"):
        base.load_network_params(path, wider)
    loose = base.load_network_params(path, wider, strict=False)
    assert torch.equal(loose["0.weight"], net[0].weight) and torch.equal(loose["1.weight"], wider[1].weight)

    state = {"iter": torch.tensor(3)}
    base.save_training_state(1, 5, state)
    payload = base.resume_training_state(str(tmp_path / "s" / "5.state"))
    assert payload["epoch"] == 1 and payload["iter"] == 5 and torch.equal(payload["state"]["iter"], state["iter"])

    params = [p.detach().clone() for p in net.parameters()]
    ema = torch.arange(sum(p.numel() for p in params), dtype=torch.float32) / 10
    got = BaseSRModel.model_ema_flat(params, ema, decay=0.9)
    # JAX ravels a dict in sorted key order: name the leaves so that it keeps this one
    tree = {f"p{i}": jnp.asarray(p.numpy()) for i, p in enumerate(params)}
    want = JBase.model_ema_flat(tree, jnp.asarray(ema.numpy()), decay=0.9)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
    base.init_ema(net)
    base.ema_flat.copy_(ema)
    base.model_ema(0.9)
    assert torch.allclose(base.ema_flat, got, rtol=1e-6, atol=1e-7)

    kw = dict(gt_resolution=32, codebook_params=((8, 64, 64),))
    assert VQWeightDehazeNet(**kw).codebook_scale == JNet(**kw).codebook_scale == 8
