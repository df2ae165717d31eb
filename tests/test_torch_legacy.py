"""The last networks of the JAX package in the port, on the CPU: ``modules/
legacy_archs`` (RRDBNet, ColorEncoder, the base layers, the legacy losses) and
the ``GumbelQuantize`` / ``EMAVectorQuantizer`` variants of ``modules/quantize``.

Small sizes (RRDBNet ``nf`` 16, ``nb`` 2, ``gc`` 8, as ``tests/test_legacy_archs.py``),
seeded numpy inputs and weights carried by ``convert.flax_to_torch_*``; the JAX
sides jitted or, for a few operations, eager. Tolerances: every output within
1e-5 of its largest magnitude (RRDBNet and the U-Net 1e-5 too), BatchNorm
running statistics within 1e-6 of their largest; the losses within 1e-6
relative and their gradients within 1e-5 of the largest (the gradient
penalty's, a second-order gradient, within 1e-4); the EMA buffers
within 1e-6 of their largest. Quantizer indices equal (the eval Gumbel takes the
argmax of logits whose gaps are far above float32 noise at these inputs).

Training-mode Gumbel: the two packages draw their noise from different
generators, so, as ``tests/test_quantize_variants.py:45`` does for JAX, the
port's draw is held by its properties (gradients reach ``proj`` and ``embed``;
the noise has the Gumbel mean and variance); and the forward and its
gradients are held against JAX's on the same noise, handed to both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glare_tpu.modules import legacy_archs as jl
from glare_tpu.modules import quantize as jq
from glare_tpu_torch import convert
from glare_tpu_torch.modules import legacy_archs as pl
from glare_tpu_torch.modules import quantize as pq

from torch_port_util import fill_tree, nchw, nhwc, rel_err


def _shapes(module, *args, **kw):
    return jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args, **kw))


def _stats(shapes, rng):
    """Running statistics: means N(0, 0.1^2), variances in [0.5, 1.5]."""
    if "mean" in shapes:
        n = shapes["mean"].shape
        return {"mean": (0.1 * rng.standard_normal(n)).astype(np.float32),
                "var": rng.uniform(0.5, 1.5, n).astype(np.float32)}
    return {k: _stats(v, rng) for k, v in shapes.items()}


def _close(got, want, what, tol=1e-5):
    assert rel_err(got, want) <= tol, (what, rel_err(got, want))


# ---------------------------------------------------------------- RRDBNet --

@pytest.mark.parametrize("scale,fea_up0", [(4, False), (8, True)])
def test_rrdbnet_and_steps_match_jax(scale, fea_up0):
    rng = np.random.default_rng(scale)
    x = rng.uniform(0, 1, (1, 32, 40, 3)).astype(np.float32)
    kw = dict(nf=16, nb=2, gc=8, scale=scale, block_idxs=(0, 1), fea_up0=fea_up0)
    jm = jl.RRDBNet(**kw)
    params = fill_tree(_shapes(jm, jnp.asarray(x))["params"], rng)
    want = jax.jit(lambda p, t: jm.apply({"params": p}, t, get_steps=True))(params, x)
    net = pl.RRDBNet(**kw).eval()
    net.load_state_dict(convert.flax_to_torch_rrdbnet(params))
    assert "RRDB_trunk.1.RDB3.conv5.weight" in net.state_dict()
    with torch.no_grad():
        got = net(nchw(x), get_steps=True)
        out = net(nchw(x))
    assert set(got) == set(want)
    for k, v in want.items():
        if v is None:
            assert got[k] is None, k
        else:
            _close(nhwc(got[k]), v, k)
    assert torch.equal(out, got["out"])


def test_rdb_init_is_scaled_kaiming():
    g = torch.Generator().manual_seed(1)
    blk = pl.ResidualDenseBlock5C(nf=64, gc=32)
    for m in blk.modules():
        if hasattr(m, "seeded_reset"):
            m.seeded_reset(g)
    w = blk.conv5.weight.detach()
    assert abs(float(w.std()) / (0.1 * (2.0 / w[0].numel()) ** 0.5) - 1) < 0.02
    assert not blk.conv5.bias.detach().any()


# ----------------------------------------------------------- base layers --

def test_color_encoder_matches_jax():
    rng = np.random.default_rng(20)
    x = rng.uniform(0, 1, (2, 18, 22, 3)).astype(np.float32)  # odd pooled sizes: pad_concat pads
    jm = jl.ColorEncoder(nf=8, avg_kernel_size=5)
    params = fill_tree(_shapes(jm, jnp.asarray(x))["params"], rng)
    want = jax.jit(lambda p, t: jm.apply({"params": p}, t))(params, x)
    net = pl.ColorEncoder(nf=8, avg_kernel_size=5)
    net.load_state_dict(convert.flax_to_torch_legacy(params))
    with torch.no_grad():
        _close(nhwc(net(nchw(x))), want, "ColorEncoder")


@pytest.mark.parametrize("which", ["Conv2D", "ConvTranspose2D", "DoubleConv", "ChannelAttention",
                                   "SpatialAttention", "CBAM"])
def test_base_layer_matches_jax(which):
    rng = np.random.default_rng(21)
    x = rng.standard_normal((2, 8, 10, 16)).astype(np.float32)
    jm, pm = {
        "Conv2D": (jl.Conv2D(12, "relu"), pl.Conv2D(16, 12, "relu")),
        "ConvTranspose2D": (jl.ConvTranspose2D(12), pl.ConvTranspose2D(16, 12)),
        "DoubleConv": (jl.DoubleConv(12), pl.DoubleConv(16, 12)),
        "ChannelAttention": (jl.ChannelAttention(), pl.ChannelAttention(16)),
        "SpatialAttention": (jl.SpatialAttention(), pl.SpatialAttention()),
        "CBAM": (jl.CBAM(), pl.CBAM(16)),
    }[which]
    params = fill_tree(_shapes(jm, jnp.asarray(x))["params"], rng)
    want = jm.apply({"params": params}, jnp.asarray(x))
    pm.load_state_dict(convert.flax_to_torch_legacy(params))
    with torch.no_grad():
        got = pm(nchw(x))
    _close(nhwc(got), want, which)
    if which == "CBAM":  # the quirk: the channel-attended input, no spatial product
        with torch.no_grad():
            assert torch.equal(got, pm.ca(nchw(x)) * nchw(x))


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("which", ["ConvBNRelu", "ResConv"])
def test_batchnorm_layers_match_jax(which, train):
    """Eval: running statistics. Train: the batch's statistics and flax's update
    of the running ones (ResConv's bn1 updates twice: the quirk)."""
    rng = np.random.default_rng(22)
    x = rng.standard_normal((2, 8, 10, 16)).astype(np.float32)
    if which == "ConvBNRelu":
        jm, pm = jl.ConvBNRelu(16, use_running_average=not train), pl.ConvBNRelu(16, 16)
    else:
        jm, pm = jl.ResConv(16, use_running_average=not train), pl.ResConv(16, 16)
    shapes = _shapes(jm, jnp.asarray(x))
    params, stats = fill_tree(shapes["params"], rng), _stats(shapes["batch_stats"], rng)
    want, new = jm.apply({"params": params, "batch_stats": stats}, jnp.asarray(x), mutable=["batch_stats"])
    pm.load_state_dict(convert.flax_to_torch_legacy(params, stats))
    pm.train(train)
    with torch.no_grad():
        got = pm(nchw(x))
    _close(nhwc(got), want, which)
    bn = pm.conv_bn_relu[1] if which == "ConvBNRelu" else pm.bn1
    jbn = new["batch_stats"]["bn" if which == "ConvBNRelu" else "bn1"]
    _close(bn.running_mean.numpy(), jbn["mean"], "running_mean", 1e-6)
    _close(bn.running_var.numpy(), jbn["var"], "running_var", 1e-6)
    if which == "ResConv":
        assert int(bn.num_batches_tracked) == 2 * train and int(pm.bn2.num_batches_tracked) == 0


def test_msia_and_pad_concat_match_jax():
    rng = np.random.default_rng(23)
    r = rng.standard_normal((2, 16, 16, 8)).astype(np.float32)
    i_att = rng.uniform(0, 1, (2, 16, 16, 1)).astype(np.float32)
    jm = jl.MSIA(8)
    shapes = _shapes(jm, jnp.asarray(r), jnp.asarray(i_att))
    params, stats = fill_tree(shapes["params"], rng), _stats(shapes["batch_stats"], rng)
    want = jax.jit(lambda p, s, a, b: jm.apply({"params": p, "batch_stats": s}, a, b))(params, stats, r, i_att)
    pm = pl.MSIA(8).eval()
    pm.load_state_dict(convert.flax_to_torch_legacy(params, stats))
    with torch.no_grad():
        _close(nhwc(pm(nchw(r), nchw(i_att))), want, "MSIA")
    a, b = rng.standard_normal((1, 9, 11, 3)), rng.standard_normal((1, 6, 8, 2))
    assert np.array_equal(nhwc(pl.pad_concat(nchw(a), nchw(b))),
                          np.asarray(jl.pad_concat(jnp.asarray(a, jnp.float32), jnp.asarray(b, jnp.float32))))


# ------------------------------------------------------------------ losses --

def test_legacy_losses_and_gradients_match_jax():
    rng = np.random.default_rng(24)
    x, y = rng.standard_normal((2, 3, 4, 4)).astype(np.float32), rng.standard_normal((2, 3, 4, 4)).astype(np.float32)
    want, gwant = jax.value_and_grad(jl.charbonnier_sum_loss)(jnp.asarray(x), jnp.asarray(y))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = pl.charbonnier_sum_loss(xt, torch.from_numpy(y))
    got.backward()
    assert abs(got.item() - float(want)) <= 1e-6 * abs(float(want))
    _close(xt.grad.numpy(), gwant, "charbonnier grad")
    logits = (2 * rng.standard_normal((4, 1))).astype(np.float32)
    for gan_type in ("gan", "ragan", "lsgan", "wgan-gp"):
        for real in (True, False):
            w, gw = jax.value_and_grad(lambda t: jl.LegacyGANLoss(gan_type)(t, real))(jnp.asarray(logits))
            lt = torch.from_numpy(logits).requires_grad_(True)
            g = pl.LegacyGANLoss(gan_type)(lt, real)
            g.backward()
            assert abs(g.item() - float(w)) <= 1e-6 * max(abs(float(w)), 1e-6), (gan_type, real)
            _close(lt.grad.numpy(), gw, f"{gan_type} {real}")
    with pytest.raises(NotImplementedError):
        pl.LegacyGANLoss("hinge2")


def test_gradient_penalty_matches_jax():
    """The penalty and its gradient with respect to the critic's weights
    (``create_graph``: the penalty trains the critic)."""
    rng = np.random.default_rng(25)
    w = rng.standard_normal((12, 1)).astype(np.float32)
    interp = rng.standard_normal((3, 12)).astype(np.float32)
    want, gwant = jax.value_and_grad(
        lambda wt: jl.gradient_penalty_loss(lambda z: jnp.tanh(z ** 2 @ wt), jnp.asarray(interp)))(jnp.asarray(w))
    wt = torch.from_numpy(w).requires_grad_(True)
    got = pl.gradient_penalty_loss(lambda z: torch.tanh(z ** 2 @ wt), torch.from_numpy(interp))
    got.backward()
    assert abs(got.item() - float(want)) <= 1e-6 * abs(float(want))
    _close(wt.grad.numpy(), gwant, "gradient penalty grad", 1e-4)


# -------------------------------------------------------------- quantizers --

def _gumbel_pair(rng, remap=None, **kw):
    jm = jq.GumbelQuantize(num_hiddens=8, embedding_dim=4, n_embed=16, remap=remap, **kw)
    params = {"embed": rng.standard_normal((16, 4)).astype(np.float32),
              "proj": {"kernel": (rng.standard_normal((1, 1, 8, 16)) / np.sqrt(8)).astype(np.float32),
                       "bias": (0.1 * rng.standard_normal(16)).astype(np.float32)}}
    pm = pq.GumbelQuantize(num_hiddens=8, embedding_dim=4, n_embed=16, remap=remap, **kw)
    pm.load_state_dict({**convert.flax_to_torch_gumbel(params), **dict(pm.named_buffers())})
    return jm, pm, params


@pytest.mark.parametrize("remap", [None, [1, 3, 5, 7, 9, 11]], ids=["full", "remap"])
def test_gumbel_eval_matches_jax(remap):
    rng = np.random.default_rng(26)
    z = (3 * rng.standard_normal((2, 5, 6, 8))).astype(np.float32)
    jm, pm, params = _gumbel_pair(rng, remap)
    zq, diff, (_, _, ind), logits = jm.apply({"params": params}, jnp.asarray(z), return_logits=True)
    got = pm.eval()(nchw(z), return_logits=True)
    _close(nhwc(got[0]), zq, "z_q")
    assert abs(got[1].item() - float(diff)) <= 1e-5 * abs(float(diff))
    assert np.array_equal(got[2][2].numpy(), np.asarray(ind))
    _close(nhwc(got[3]), logits, "logits")
    entry = pm.get_codebook_entry(got[2][2].reshape(-1), (2, 5, 6, 4))
    want = jm.get_codebook_entry(params, jnp.asarray(ind).reshape(-1), (2, 5, 6, 4))
    _close(nhwc(entry), want, "get_codebook_entry")


def test_gumbel_train_on_shared_noise_matches_jax(monkeypatch):
    rng = np.random.default_rng(27)
    z = rng.standard_normal((2, 5, 6, 8)).astype(np.float32)
    w = rng.standard_normal((2, 5, 6, 4)).astype(np.float32)
    noise = np.asarray(jax.random.gumbel(jax.random.PRNGKey(3), (2, 5, 6, 16)))
    jm, pm, params = _gumbel_pair(rng)
    monkeypatch.setattr(jax.random, "gumbel", lambda key, shape, dtype=jnp.float32: jnp.asarray(noise, dtype))
    monkeypatch.setattr(pq, "sample_gumbel", lambda shape, *a, **k: torch.tensor(noise))

    def jloss(p, zz):
        zq, diff, _ = jm.apply({"params": p}, zz, deterministic=False, rngs={"gumbel": jax.random.PRNGKey(0)})
        return jnp.sum(zq * w) + diff

    want, (gp, gz) = jax.value_and_grad(jloss, argnums=(0, 1))(params, jnp.asarray(z))
    zt = nchw(z).requires_grad_(True)
    zq, diff, _ = pm.train()(zt, generator=torch.Generator().manual_seed(0))
    loss = (zq * nchw(w)).sum() + diff
    loss.backward()
    assert abs(loss.item() - float(want)) <= 1e-5 * abs(float(want))
    _close(nhwc(zt.grad), gz, "grad z")
    _close(pm.embed.weight.grad.numpy(), gp["embed"], "grad embed")
    _close(pm.proj.weight.grad.permute(2, 3, 1, 0).numpy(), gp["proj"]["kernel"], "grad proj")


def test_gumbel_train_noise_and_straight_through():
    """The port's own draw: Gumbel moments, and the straight-through gradient
    reaches ``proj`` and ``embed`` (the JAX test's property)."""
    g = torch.Generator().manual_seed(4)
    n = pq.sample_gumbel((200000,), g)
    assert abs(float(n.mean()) - 0.5772) < 0.01 and abs(float(n.var()) - np.pi ** 2 / 6) < 0.03
    _, pm, _ = _gumbel_pair(np.random.default_rng(28))
    zq, diff, (_, _, ind) = pm.train()(torch.randn(2, 8, 5, 6, generator=g), generator=g)
    ((zq ** 2).sum() + diff).backward()
    assert float(pm.proj.weight.grad.abs().sum()) > 0 and float(pm.embed.weight.grad.abs().sum()) > 0
    assert ind.shape == (2, 5, 6)


def test_remap_and_unmap_match_jax():
    used = np.array([3, 7, 11], np.int32)
    inds = np.array([[3, 7, 11, 5], [11, 2, 3, 3]], np.int32)
    for unknown in ("extra", 1):
        want = np.asarray(jq.remap_to_used(jnp.asarray(inds), jnp.asarray(used), unknown))
        got = pq.remap_to_used(torch.from_numpy(inds), torch.from_numpy(used), unknown)
        assert np.array_equal(got.numpy(), want)
        back = pq.unmap_to_all(got, torch.from_numpy(used))
        assert np.array_equal(back.numpy(), np.asarray(jq.unmap_to_all(jnp.asarray(want), jnp.asarray(used))))
    got = pq.remap_to_used(torch.from_numpy(inds), torch.from_numpy(used), "random",
                           generator=torch.Generator().manual_seed(0), re_embed=3)
    known = np.isin(inds, used)
    assert np.array_equal(got.numpy()[known], np.searchsorted(used, inds[known]))
    assert (got.numpy()[~known] < 3).all()


def test_ema_quantizer_update_matches_jax():
    """Two updating forwards (the EMA of cluster sizes and sums, the Laplace-
    smoothed refresh), then one without update; loss and straight-through."""
    rng = np.random.default_rng(29)
    jm = jq.EMAVectorQuantizer(n_embed=12, embedding_dim=4, decay=0.9)
    z0 = rng.standard_normal((2, 4, 5, 4)).astype(np.float32)
    ema = {"weight": rng.standard_normal((12, 4)).astype(np.float32),
           "cluster_size": rng.uniform(0, 2, 12).astype(np.float32)}
    ema["embed_avg"] = (ema["weight"] * rng.uniform(0.5, 1.5, (12, 1))).astype(np.float32)
    pm = pq.EMAVectorQuantizer(n_embed=12, embedding_dim=4, decay=0.9)
    pm.load_state_dict(convert.flax_to_torch_ema(ema))
    assert {n for n, _ in pm.named_buffers()} == {"embedding.weight", "embedding.cluster_size",
                                                   "embedding.embed_avg"}
    assert not list(pm.parameters())
    state = {"ema": {k: jnp.asarray(v) for k, v in ema.items()}}
    for step, update in enumerate((True, True, False)):
        z = (z0 + 0.3 * step).astype(np.float32)
        (zq, loss, (perp, enc, idx)), state = jm.apply(state, jnp.asarray(z), update=update, mutable=["ema"])
        zt = nchw(z).requires_grad_(True)
        got = pm(zt, update=update)
        assert np.array_equal(got[2][2].numpy(), np.asarray(idx)), step
        _close(nhwc(got[0]), zq, "z_q")
        assert abs(got[1].item() - float(loss)) <= 1e-6 * abs(float(loss))
        assert abs(got[2][0].item() - float(perp)) <= 1e-6 * float(perp)
        for k in ("weight", "cluster_size", "embed_avg"):
            _close(getattr(pm.embedding, k).numpy(), state["ema"][k], f"{k} after step {step}", 1e-6)
        got[0].sum().backward()  # straight-through: d z_q / d z = 1
        assert torch.equal(zt.grad, torch.ones_like(zt))
