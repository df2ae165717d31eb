"""Port's VQGAN (encoder, codebook retrieval, decoder with its taps) vs the JAX
package with carried weights (CPU, f32, small widths).

``VQModel.decode`` on the same latent: ZERO codebook index flips (indices are
discrete; the latent and codebook are bit-identical on both sides), then the
decoded image and both ``code_decoder_output`` taps at 2e-4 relative (float32
sums in another order through ~10 convolutions and group norms).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glare_tpu.modules.condition_encoder import ConEncoder1 as JConEncoder1
from glare_tpu.modules.vqmodel import VQModel as JVQModel
from glare_tpu_torch import convert
from glare_tpu_torch.modules.condition_encoder import ConEncoder1
from glare_tpu_torch.modules.vqmodel import VQModel

from torch_port_util import nchw, nhwc, random_params, rel_err

KW = dict(ch=32, n_embed=64, num_res_blocks=1)


@pytest.fixture(autouse=True)
def _no_grad():
    with torch.no_grad():
        yield


@pytest.fixture(scope="module")
def vq_pair():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((1, 16, 16, 3)).astype(np.float32)
    jvq = JVQModel(vq_backend="ref", **KW)
    params = random_params(jvq, rng, jnp.asarray(x))
    vq = VQModel(**KW)
    vq.load_state_dict(convert.flax_to_torch_vqgan(params))
    return jvq, params, vq.eval(), rng


def test_decode_zero_flips_and_taps(vq_pair):
    jvq, params, vq, rng = vq_pair
    # latent near the codebook's scale so that many different codes are chosen
    lat = rng.standard_normal((2, 4, 4, 3)).astype(np.float32)
    jdec, jloss, jtaps = jax.jit(lambda p, a: jvq.apply({"params": p}, a, method=JVQModel.decode))(
        params, jnp.asarray(lat))
    _, _, (_, _, jidx) = jvq.bind({"params": params}).quantize(jnp.asarray(lat))
    dec, loss, taps = vq.decode(nchw(lat))
    idx = vq.quantize.last_indices.numpy()
    assert int((idx != np.asarray(jidx)).sum()) == 0
    assert len(set(idx.tolist())) > 8, "test latent should hit many codes"
    assert rel_err(nhwc(dec), np.asarray(jdec)) < 2e-4
    assert len(taps) == len(jtaps) == 2
    for t, jt in zip(taps, jtaps):
        assert rel_err(nhwc(t), np.asarray(jt)) < 2e-4
    assert abs(float(loss) - float(jloss)) < 1e-5 * max(1.0, abs(float(jloss)))


def test_encode_and_call(vq_pair):
    jvq, params, vq, rng = vq_pair
    x = rng.standard_normal((1, 16, 16, 3)).astype(np.float32)
    jh, _ = jax.jit(lambda p, a: jvq.apply({"params": p}, a, method=JVQModel.encode))(
        params, jnp.asarray(x))
    h, _ = vq.encode(nchw(x))
    assert h.shape == (1, 3, 4, 4)
    assert rel_err(nhwc(h), np.asarray(jh)) < 2e-4
    dec, diff = vq(nchw(x))
    assert dec.shape == (1, 3, 16, 16) and diff.dim() == 0


def test_condition_encoder_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
    jenc = JConEncoder1(ch=32, num_res_blocks=1)
    params = random_params(jenc, rng, jnp.asarray(x), mid_feat=True)
    want = jax.jit(lambda p, a: jenc.apply({"params": p}, a, mid_feat=True))(params, jnp.asarray(x))
    enc = ConEncoder1(ch=32, num_res_blocks=1)
    sd = {}
    convert._put_cond_encoder(sd, "e", params)
    enc.load_state_dict({k[2:]: v for k, v in sd.items()})
    got = enc(nchw(x), mid_feat=True)
    assert got["cond_feat"].shape == (2, 64, 4, 4)
    for key in ("cond_feat", "color_map"):
        assert rel_err(nhwc(got[key]), np.asarray(want[key])) < 2e-4
    assert len(got["mid_feat"]) == 2
    for t, jt in zip(got["mid_feat"], want["mid_feat"]):
        assert rel_err(nhwc(t), np.asarray(jt)) < 2e-4


def test_attention_levels_follow_config_resolution():
    """Attention sits where the CONFIG-derived resolution is in attn_resolutions:
    3 blocks in the encoder, 4 in the decoder at the shipped geometry."""
    from glare_tpu_torch.nn.layers import AttnBlock

    vq = VQModel(ch=32, n_embed=16, num_res_blocks=2)
    count = lambda m: sum(isinstance(s, AttnBlock) for s in m.modules())  # noqa: E731
    assert count(vq.encoder) == 3 and count(vq.decoder) == 4
