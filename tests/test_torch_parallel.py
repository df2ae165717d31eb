"""Data parallelism in the port (``glare_tpu_torch/parallel``) against the JAX
package's mesh semantics and against the single-process step, on the CPU.

One spawned gloo group of two ranks (``torch_dp_jobs.Group``, a module fixture)
runs every two-rank job; the test functions read its results. While it runs, this
process computes the references: the same steps in one process on the global
batch, and JAX's ``initialize_actnorm`` on the full batch (its flow apply jitted).

  * Stage 3 (the mini model of tests/test_torch_train.py, batch 2, each rank one
    image, DDP, MS-SSIM's batch means over both ranks) and stage 2 (the mini
    model of tests/test_torch_train_stage2.py): one step against the
    single-process step, at JAX's bars of tests/test_parallel.py: the loss 1e-5
    relative, the parameters 2e-5 absolute (the lr is small: Adam's first update
    is lr * sign(g), also where g is rounding noise); the gradients within 1e-3 of
    the step's largest.
  * The stage-2 ActNorm init over the two ranks against JAX's
    ``initialize_actnorm`` on the full batch: 1e-5 of each tensor's largest (a
    bias that is rounding noise in exact arithmetic vanishes on both sides).
  * One stage-1 GAN iteration (the mini HQ model of
    tests/test_torch_train_stage1.py, batch 4, each rank two images, the explicit
    gradient average): the logged losses against the single process, 5e-4
    relative (JAX's bar for its sharded GAN steps).
  * FSDP2 (``make_fsdp_train_step``) on JAX's FSDP test problem: the step's loss
    1e-5 relative and parameters 1e-5 against one process, the placements from
    ``auto_shardings``; the 4-rank 2-D mesh case is marked slow. The mini
    stage-3 step sharded by FSDP2 is held as the DDP steps above.
  * ``shard_batch`` against JAX's ``P("data")`` shards on a 2-device mesh,
    ``auto_shardings`` against JAX's rule on the mini stage-3 parameter shapes,
    ``reduce_loss_dict`` / ``cross_replica_mean`` as the ranks' mean, and
    ``EnlargedSampler`` index for index against JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glare_tpu.models.llflow_model import LLFlowModel as JModel2
from glare_tpu.models.llflow_model import merge_actnorm_init
from glare_tpu.modules.llflow_vqgan2 import LLFlowVQGAN2 as JLLFlow
from glare_tpu.modules.vqmodel import VQModel as JVQModel
from glare_tpu.parallel import mesh as jmesh
from glare_tpu_torch import convert
from glare_tpu_torch.parallel import EnlargedSampler

import torch_dp_jobs as jobs
from torch_port_util import fill_tree

MINI3 = dict(enc_ch=32, decoder_ch=32, enc_num_res_blocks=1, dec_num_res_blocks=1)
MINI2 = dict(enc_ch=32, enc_num_res_blocks=1)
VQ = dict(ch=32, n_embed=64, num_res_blocks=1)
FLOW = {"K": 2, "L": 1, "additionalFlowNoAffine": 2}
SCHED = {"manual_seed": 1, "beta1": 0.9, "beta2": 0.99, "lr_scheme": "MultiStepLR", "warmup_iter": -1,
         "lr_steps": [20, 30], "lr_gamma": 0.5}
OPT3 = {"model": "VQLLFLOWD", "is_train": True,
        "network_G": {"which_model_G": "VQLLFLOWDeformable", "dcn_max_offset": 2, "flow": FLOW, **MINI3},
        "network_VQGAN": {"type": "VQModel", **VQ},
        "train": {**SCHED, "lr_G": 5e-6, "weight_decay_G": 0}}
OPT2 = {"model": "LLFlow", "is_train": True, "datasets": {"train": {"quant": 32, "log_low": True}},
        "network_G": {"which_model_G": "LLFlowVQGAN2", "flow": FLOW, **MINI2},
        "network_VQGAN": {"type": "VQModel", **VQ},
        "train": {**SCHED, "lr_G": 5e-6, "weight_decay_G": 1e-3, "weight_fl": 1, "weight_l1": 0}}
TAPS = {"relu1_2": 1.0, "relu2_2": 1.0, "relu3_3": 1.0}
OPT1 = {"is_train": True, "manual_seed": 0, "model_type": "VQDehazeModel",
        "network_g": {"type": "VQWeightDehazeNet", "gt_resolution": 32, "codebook_params": [[8, 64, 64]],
                      "LQ_stage": False, "use_weight": False, "norm_type": "gn", "act_type": "silu"},
        "network_d": {"type": "UNetDiscriminatorSN", "num_in_ch": 64, "num_feat": 32},
        "datasets": {"train": {"gt_size": 32}},
        "train": {"optim_g": {"type": "Adam", "lr": 2e-6}, "optim_d": {"type": "Adam", "lr": 2e-6},
                  "pixel_opt": {"type": "L1Loss", "loss_weight": 1.0, "reduction": "mean"},
                  "perceptual_opt": {"type": "PerceptualLoss", "layer_weights": dict(TAPS),
                                     "perceptual_weight": 1.0, "style_weight": 0},
                  "codebook_opt": {"loss_weight": 1.0},
                  "gan_opt": {"type": "GANLoss", "gan_type": "hinge", "real_label_val": 1.0,
                              "fake_label_val": 0.0, "loss_weight": 0.1},
                  "net_d_iters": 1, "net_d_init_iters": 0, "ema_decay": 0.999},
        "val": {"metrics": {"psnr": {"type": "psnr", "better": "higher"}}}}


def _low_light(rng, b, s):
    lq = np.log(np.clip(rng.uniform(0, 0.2, (b, s, s, 3)) + 1e-3, 1e-3, None)).astype(np.float32)
    gt = np.clip(np.exp(lq) * 4 + 0.05 * rng.standard_normal(lq.shape), 0, 1).astype(np.float32)
    return lq, gt


def _smooth(rng, b, s):
    """Smooth colour fields in (0.1, 0.9): no flat clamped regions, whose max-pool
    and hinge ties would decide apart between two batch layouts."""
    yy, xx = np.mgrid[0:s, 0:s] / s
    imgs = [np.stack([0.5 + 0.3 * np.sin(6 * xx * rng.uniform(0.5, 1.5) + rng.uniform(0, 6)) *
                      np.cos(5 * yy * rng.uniform(0.5, 1.5)) for _ in range(3)], -1) for _ in range(b)]
    return (np.stack(imgs) + 0.02 * rng.standard_normal((b, s, s, 3))).clip(0.1, 0.9).astype(np.float32)


def _jax_stage2(rng, lq, gt):
    """Seeded mini stage-2 weights (flax trees) and JAX's ActNorm init on the full batch."""
    net = JLLFlow(K=2, L=1, additional_flow_no_affine=2, **MINI2)
    vq = JVQModel(vq_backend="ref", **VQ)
    vq_s, net_s = jax.eval_shape(lambda: (
        vq.init(jax.random.PRNGKey(0), jnp.asarray(gt))["params"],
        net.init(jax.random.PRNGKey(0), jnp.zeros((2, 8, 8, 3)), jnp.asarray(lq),
                 method=JLLFlow.normal_flow)["params"]))
    vq_p, net_p = fill_tree(vq_s, rng), fill_tree(net_s, rng)

    def init():
        """``LLFlowModel.initialize_actnorm``'s two steps, the flow's ddinit apply
        jitted (eager it takes 13 s here, jitted 2 s; the same statistics to 6e-7)."""
        jm = JModel2.__new__(JModel2)
        jm.netG, jm.net_hq, jm.mesh, jm._jit_cache = net, vq, None, {}
        jm.vq_variables = {"params": jax.tree.map(jnp.asarray, vq_p)}
        params = jax.tree.map(jnp.asarray, net_p)
        stats = jax.jit(lambda p, lat, x: net.apply({"params": p}, lat, x, ddinit=True, method=JLLFlow.normal_flow,
                                                    mutable=["actnorm_init"])[1]["actnorm_init"])(
            params, jm.encode_gt_latent(jnp.asarray(gt)), jnp.asarray(lq))
        return convert.flax_to_torch_stage2(jax.tree.map(np.asarray, merge_actnorm_init(params, stats)))

    return convert.flax_to_torch_stage2(net_p), convert.flax_to_torch_vqgan(vq_p), init


@pytest.fixture(scope="module")
def run():
    rng = np.random.default_rng(0)
    lq3, gt3 = _low_light(rng, 2, 32)
    lq2, gt2 = _low_light(rng, 2, 32)
    img1 = _smooth(rng, 4, 32)
    s2_sd, vq_sd, jax_init = _jax_stage2(np.random.default_rng(21), lq2, gt2)
    s2_np = {k: v.numpy() for k, v in s2_sd.items()}
    vq_np = {k: v.numpy() for k, v in vq_sd.items()}
    payload = [("misc", "misc", {"opt3": OPT3}),
               ("fsdp", "fsdp", {}),
               ("s3", "stage3", {"opt": OPT3, "lq": lq3, "gt": gt3}),
               ("s3_fsdp", "stage3", {"opt": OPT3, "lq": lq3, "gt": gt3, "mode": "fsdp"}),
               ("s2", "stage2", {"opt": OPT2, "stage2_sd": s2_np, "vqgan_sd": vq_np, "lq": lq2, "gt": gt2}),
               ("gan", "gan", {"opt": OPT1, "lq": img1, "gt": img1})]
    group = jobs.Group(2, payload)
    ref = {"s3": jobs.single("stage3", opt=OPT3, lq=lq3, gt=gt3),
           "s2": jobs.single("stage2", opt=OPT2, stage2_sd=s2_np, vqgan_sd=vq_np, lq=lq2, gt=gt2),
           "gan": jobs.single("gan", opt=OPT1, lq=img1, gt=img1),
           "actnorm_jax": jax_init()}
    ranks = group.results()
    for r, res in enumerate(ranks):
        assert "error" not in res, f"rank {r}:\n{res['error']}"
    return ranks, ref


def _grads_close(got, want, tol=1e-3):
    top = max(float(np.abs(w).max()) for w in want.values())
    for n, w in want.items():
        err = float(np.abs(got[n] - w).max())
        assert err <= tol * top, (n, err, top)


@pytest.mark.parametrize("stage", ["s3", "s2", "s3_fsdp"])
def test_ddp_step_matches_single_process(run, stage):
    """DDP (stage 3, stage 2) and FSDP2 (stage 3, ``parallelize("fsdp")``) steps."""
    ranks, ref = run
    want = ref[stage.split("_")[0]]
    assert not want["ddp"]
    for res in ranks:
        got = res[stage]
        assert got["ddp"]
        assert abs(got["loss"] - want["loss"]) <= 1e-5 * abs(want["loss"]), (got["loss"], want["loss"])
        _grads_close(got["grads"], want["grads"])
        assert set(got["params"]) == set(want["params"])
        for n, w in want["params"].items():
            np.testing.assert_allclose(got["params"][n], w, atol=2e-5, rtol=0, err_msg=n)
    # both ranks hold the same weights after the step
    for n, p in ranks[0][stage]["params"].items():
        np.testing.assert_array_equal(ranks[1][stage]["params"][n], p)


def test_stage3_log_is_the_global_loss(run):
    """The logged losses are the ranks' mean: each part within 1e-4 relative of the
    single process's (the CPU tests' loss bar; the total is held at 1e-5 above)."""
    ranks, ref = run
    for res in ranks:
        for k, v in ref["s3"]["log"].items():
            assert abs(res["s3"]["log"][k] - v) <= 1e-4 * abs(v), k
        assert res["s3"]["moved"] == ref["s3"]["moved"] > 0


def test_actnorm_init_over_ranks_matches_jax_full_batch(run):
    """Each ActNorm's bias / logs from the two ranks' blocks within 1e-5 of each
    tensor's largest magnitude of JAX's init on the whole batch (a bias below 1e-6
    of the largest, rounding noise in exact arithmetic, vanishes on both sides)."""
    ranks, ref = run
    want = {n: v.numpy() for n, v in ref["actnorm_jax"].items() if ".actnorm." in n}
    assert len(want) == 2 * (4 + 2 * 4)
    for kind in ("bias", "logs"):
        names = [n for n in want if n.endswith(kind)]
        top_all = max(float(np.abs(want[n]).max()) for n in names)
        for res in ranks:
            got = res["s2"]["actnorm"]
            for n in names:
                w, top = want[n], float(np.abs(want[n]).max())
                if top <= 1e-6 * top_all:
                    assert float(np.abs(got[n]).max()) <= 1e-6 * top_all, n
                else:
                    assert float(np.abs(got[n] - w).max()) <= 1e-5 * top, n
    # and the same init in one process on the whole batch
    for n, v in ref["s2"]["actnorm"].items():
        np.testing.assert_allclose(ranks[0]["s2"]["actnorm"][n], v, atol=1e-5 * float(np.abs(v).max()) + 1e-7)


def test_gan_iteration_matches_single_process(run):
    ranks, ref = run
    want = ref["gan"]
    assert not want["dp"]
    keys = ("l_g_total", "l_codebook", "l_pix", "l_percep", "l_g_gan", "l_d_real", "l_d_fake")
    for res in ranks:
        got = res["gan"]
        assert got["dp"]
        for k in keys:
            assert abs(got["logs"][k] - want["logs"][k]) <= 5e-4 * abs(want["logs"][k]) + 1e-5, (
                k, got["logs"][k], want["logs"][k])
    for net in ("g", "d"):   # rank 0's weights on both ranks, the same update on both
        for n, p in ranks[0]["gan"][net].items():
            np.testing.assert_array_equal(ranks[1]["gan"][net][n], p)


def test_fsdp_step_matches_single_process(run):
    ranks, _ = run
    net, x, y = jobs.mlp_problem()
    opt = torch.optim.Adam(net.parameters(), lr=1e-2)
    loss = net.loss(x, y)
    loss.backward()
    opt.step()
    for res in ranks:
        got = res["fsdp"]
        assert abs(got["loss"] - float(loss)) <= 1e-5 * abs(float(loss))
        for n, p in net.named_parameters():
            np.testing.assert_allclose(got["params"][n], p.detach().numpy(), atol=1e-5, rtol=0, err_msg=n)
        # JAX's rule at min_size 1024: w1 [64, 128] on dim 1, w2 [128, 16] on dim 0;
        # b2 (16 elements) stays whole by the rule and is sharded on dim 0 by FSDP2
        assert got["specs"] == {"w1": (None, "data"), "w2": ("data", None), "b2": ()}
        assert got["placements"] == {"w1": "(Shard(dim=1),)", "w2": "(Shard(dim=0),)", "b2": "(Shard(dim=0),)"}
        assert got["local_w1"] == [64, 64]


def test_shard_batch_is_jax_data_layout(run):
    ranks, _ = run
    x = np.arange(8 * 4, dtype=np.float32).reshape(8, 4)
    xs = jax.device_put(jnp.asarray(x), jmesh.shard_batch(jmesh.make_mesh(2)))
    shards = sorted(xs.addressable_shards, key=lambda s: s.device.id)
    for r, res in enumerate(ranks):
        np.testing.assert_array_equal(res["misc"]["shard"], np.asarray(shards[r].data))
        np.testing.assert_array_equal(res["misc"]["shard_np"], np.asarray(shards[r].data))
        # a batch that does not divide stays whole, as the JAX models' _put_batch
        assert res["misc"]["odd"].shape == (3, 2)


def _strip(spec):
    spec = tuple(spec)
    while spec and spec[-1] is None:
        spec = spec[:-1]
    return spec


def test_auto_shardings_matches_jax_rule(run):
    ranks, _ = run
    misc = ranks[0]["misc"]
    tree = {n: np.zeros(s, np.float32) for n, s in misc["shapes"].items()}
    want = jmesh.auto_shardings(tree, jmesh.make_mesh(2))
    assert set(misc["specs"]) == set(want)
    assert any(_strip(s) for s in misc["specs"].values())      # some leaves are sharded
    assert any(s == () for s in misc["specs"].values())        # and some small ones whole
    for n, sh in want.items():
        assert _strip(misc["specs"][n]) == _strip(sh.spec), n
    assert ranks[1]["misc"]["specs"] == misc["specs"]


def test_reduce_loss_dict_and_cross_replica_mean(run):
    ranks, _ = run
    for res in ranks:
        assert res["misc"]["logs"] == {"l_a": 1.5, "l_b": 5.0, "note": 3.0}
        np.testing.assert_array_equal(res["misc"]["tree"]["a"], [0.5, 0.5, 0.5])
        np.testing.assert_array_equal(res["misc"]["tree"]["b"], [2.0])


@pytest.mark.parametrize("n,world,rank,ratio,epoch", [
    (10, 1, 0, 1, 0), (10, 2, 0, 1, 0), (10, 2, 1, 1, 3), (7, 3, 2, 1, 1), (7, 4, 3, 2, 5), (485, 8, 5, 3, 2)])
def test_enlarged_sampler_matches_jax(n, world, rank, ratio, epoch):
    a, b = EnlargedSampler(n, world, rank, ratio), jmesh.EnlargedSampler(n, world, rank, ratio)
    a.set_epoch(epoch)
    b.set_epoch(epoch)
    assert len(a) == len(b)
    np.testing.assert_array_equal(a.indices(), b.indices())
    np.testing.assert_array_equal(list(a), list(b))


@pytest.mark.slow
def test_fsdp_2d_mesh_four_ranks_matches_single_process():
    """dp=2 x model=2 (HSDP in FSDP2: replicated over 'data', sharded over 'model';
    JAX shards over both): the step's result equals one process's."""
    ranks = jobs.Group(4, [("fsdp", "fsdp", {"mesh_2d": (2, 2)})]).results()
    net, x, y = jobs.mlp_problem()
    opt = torch.optim.Adam(net.parameters(), lr=1e-2)
    loss = net.loss(x, y)
    loss.backward()
    opt.step()
    for r, res in enumerate(ranks):
        assert "error" not in res, res.get("error")
        assert abs(res["fsdp"]["loss"] - float(loss)) <= 1e-5 * abs(float(loss))
        for n, p in net.named_parameters():
            np.testing.assert_allclose(res["fsdp"]["params"][n], p.detach().numpy(), atol=1e-5, rtol=0)


def test_loader_draws_the_samplers_indices():
    from glare_tpu_torch.data.loader import DataLoader

    data = [{"i": np.full((1,), k)} for k in range(7)]
    sampler = EnlargedSampler(7, 2, 1, 2)
    sampler.set_epoch(4)
    loader = DataLoader(data, batch_size=3, shuffle=True, drop_last=True, sampler=sampler)
    got = np.concatenate([b["i"].ravel() for b in loader])
    np.testing.assert_array_equal(got, _jax_indices(7, 2, 1, 2, 4)[:len(loader) * 3])
    assert len(loader) == len(sampler) // 3


def _jax_indices(n, world, rank, ratio, epoch):
    s = jmesh.EnlargedSampler(n, world, rank, ratio)
    s.set_epoch(epoch)
    return s.indices()


def test_stage1_launcher_flags(tmp_path):
    """JAX's --launcher / --local_rank are accepted; 'none' is one process with the
    seed as given; 'jax' (the JAX package's multi-host init) raises."""
    from glare_tpu_torch.sr.utils.options import parse_options

    conf = tmp_path / "c.yml"
    conf.write_text("name: t\nmanual_seed: 7\ndatasets: {}\n")
    opt, _ = parse_options(str(tmp_path), argv=["-opt", str(conf), "--launcher", "none", "--local_rank", "0"])
    assert (opt["rank"], opt["world_size"], opt["dist"], opt["manual_seed"]) == (0, 1, False, 7)
    with pytest.raises(ValueError, match="torchrun"):
        parse_options(str(tmp_path), argv=["-opt", str(conf), "--launcher", "jax"])
