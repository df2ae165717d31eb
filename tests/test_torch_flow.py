"""Port's normalizing flow vs the JAX package with carried weights (CPU, f32),
plus the flow's own oracle: encode o decode round trip < 1e-4 absolute and
logdet antisymmetry < 1e-3.

Cross-framework tolerance: 2e-4 relative to the largest output after up to 16
invertible steps in float32 (each a few convolutions and a division).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glare_tpu.modules.flow_step import FlowStep as JFlowStep
from glare_tpu.modules.flow_upsampler import FlowUpsamplerNet as JFlow
from glare_tpu_torch import convert
from glare_tpu_torch.modules.flow_layers import InvertibleConv1x1, _det_and_inv
from glare_tpu_torch.modules.flow_step import FlowStep
from glare_tpu_torch.modules.flow_upsampler import FlowUpsamplerNet

from torch_port_util import nchw, nhwc, random_params, rel_err


@pytest.fixture(autouse=True)
def _no_grad():
    with torch.no_grad():
        yield

B, H, W = 2, 6, 5


def _inputs(seed):
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((B, H, W, 3)).astype(np.float32)
    ft = rng.uniform(0, 1, (B, H, W, 64)).astype(np.float32)
    return rng, z, ft


@pytest.fixture(scope="module")
def flow_pair():
    rng, z, ft = _inputs(0)
    jflow = JFlow(K=6, L=2, additional_flow_no_affine=2)
    params = random_params(jflow, rng, jnp.asarray(z), {"cond_feat": jnp.asarray(ft)},
                           jnp.zeros((B,)), reverse=True)
    flow = FlowUpsamplerNet(K=6, L=2, additional_flow_no_affine=2)
    sd = {}
    convert._put_flow_upsampler(sd, "f", params)
    flow.load_state_dict({k[2:]: v for k, v in sd.items()})
    return jflow, params, flow.eval(), z, ft


def test_decode_matches_jax(flow_pair):
    jflow, params, flow, z, ft = flow_pair
    jx, jld = jax.jit(lambda p, a, c: jflow.apply(
        {"params": p}, a, {"cond_feat": c}, jnp.zeros((B,)), method=JFlow.decode))(
            params, jnp.asarray(z), jnp.asarray(ft))
    x, ld = flow.decode(nchw(z), {"cond_feat": nchw(ft)}, logdet=torch.zeros(B))
    assert rel_err(nhwc(x), np.asarray(jx)) < 2e-4
    assert rel_err(ld.numpy(), np.asarray(jld)) < 2e-4


def test_encode_matches_jax(flow_pair):
    jflow, params, flow, z, ft = flow_pair
    jz, jld = jax.jit(lambda p, a, c: jflow.apply(
        {"params": p}, a, {"cond_feat": c}, jnp.zeros((B,)), method=JFlow.encode))(
            params, jnp.asarray(z), jnp.asarray(ft))
    out, ld = flow.encode(nchw(z), {"cond_feat": nchw(ft)}, logdet=torch.zeros(B))
    assert rel_err(nhwc(out), np.asarray(jz)) < 2e-4
    assert rel_err(ld.numpy(), np.asarray(jld)) < 2e-4


def test_roundtrip_and_logdet_antisymmetry(flow_pair):
    _, _, flow, z, ft = flow_pair
    cond = {"cond_feat": nchw(ft)}
    lat, ld_f = flow(nchw(z), cond, logdet=torch.zeros(B), reverse=False)
    back, ld_r = flow(lat, cond, logdet=torch.zeros(B), reverse=True)
    assert (back - nchw(z)).abs().max() < 1e-4
    assert (ld_f + ld_r).abs().max() < 1e-3
    assert ld_f.shape == (B,) and float(ld_f.abs().min()) > 0


@pytest.mark.parametrize("coupling", ["noCoupling", "CondAffineSeparatedAndCond"])
@pytest.mark.parametrize("reverse", [False, True])
def test_flow_step_matches_jax(coupling, reverse):
    rng, z, ft = _inputs(1)
    jstep = JFlowStep(in_channels=3, flow_coupling=coupling)
    params = random_params(jstep, rng, jnp.asarray(z), jnp.zeros((B,)), ft=jnp.asarray(ft))
    jz, jld = jstep.apply({"params": params}, jnp.asarray(z), jnp.zeros((B,)), reverse=reverse,
                          ft=jnp.asarray(ft))
    step = FlowStep(3, flow_coupling=coupling)
    sd = {}
    convert._put_flow_upsampler(sd, "f", {"layers_0": params})
    step.load_state_dict({k[len("f.layers.0."):]: v for k, v in sd.items()})
    out, ld = step(nchw(z), torch.zeros(B), reverse=reverse, ft=nchw(ft))
    assert rel_err(nhwc(out), np.asarray(jz)) < 1e-4
    assert rel_err(ld.numpy(), np.asarray(jld)) < 1e-4


@pytest.mark.parametrize("c", [1, 2, 3, 4])
def test_det_and_inv_closed_form(c):
    w = torch.from_numpy(np.random.default_rng(c).standard_normal((c, c)).astype(np.float32)
                         + 2 * np.eye(c, dtype=np.float32))
    det, inv = _det_and_inv(w)
    assert abs(float(det) - float(torch.linalg.det(w.double()))) < 1e-4 * abs(float(det))
    assert (inv @ w - torch.eye(c)).abs().max() < 1e-5


def test_invconv_seeded_init_is_orthogonal():
    m = InvertibleConv1x1(3)
    m.seeded_reset(torch.Generator().manual_seed(0))
    assert (m.weight @ m.weight.t() - torch.eye(3)).abs().max() < 1e-5


def test_gaussian_diag_samplers_match_jax(monkeypatch):
    """``GaussianDiag.sample(generator, mean, logs, eps_std)`` and ``sample_eps``:
    a seeded generator gives the same draws twice; ``sample`` is ``mean + exp(logs)
    * eps`` with eps the ``sample_eps`` draw of the same seed; both against JAX's
    methods fed the same standard-normal draw (``jax.random.normal`` patched)."""
    from glare_tpu.modules.flow_layers import GaussianDiag as JGD
    from glare_tpu_torch.modules.flow_layers import GaussianDiag

    rng = np.random.default_rng(4)
    mean = torch.tensor(rng.standard_normal((2, 3, 5, 4)).astype(np.float32))
    logs = torch.tensor(0.3 * rng.standard_normal((2, 3, 5, 4)).astype(np.float32))
    gen = lambda: torch.Generator().manual_seed(7)  # noqa: E731
    a, b = GaussianDiag.sample(gen(), mean, logs, 0.5), GaussianDiag.sample(gen(), mean, logs, 0.5)
    assert torch.equal(a, b) and a.shape == mean.shape and a.dtype == mean.dtype
    eps = GaussianDiag.sample_eps(gen(), mean.shape, 0.5)
    assert torch.equal(a, mean + torch.exp(logs) * eps)
    unit = GaussianDiag.sample_eps(gen(), (2, 3, 5, 4))
    assert torch.equal(eps, unit * 0.5) and unit.dtype == torch.float32
    assert GaussianDiag.sample_eps(gen(), [4, 2], dtype=torch.float64).dtype == torch.float64
    wide = GaussianDiag.sample_eps(gen(), (200_000,), 0.3)
    assert abs(float(wide.std()) - 0.3) < 3e-3 and abs(float(wide.mean())) < 3e-3

    monkeypatch.setattr(jax.random, "normal", lambda key, shape, dtype: jnp.asarray(unit.numpy(), dtype))
    key = jax.random.PRNGKey(0)
    want = JGD.sample(key, jnp.asarray(mean.numpy()), jnp.asarray(logs.numpy()), eps_std=0.5)
    assert rel_err(a.numpy(), np.asarray(want)) <= 1e-6
    assert np.array_equal(np.asarray(JGD.sample_eps(key, unit.shape, 0.5)), eps.numpy())
