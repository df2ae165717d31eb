"""Port's fused-attention function and AttnBlock vs the JAX package (CPU).

The JAX kernel runs in Pallas interpret mode, as tests/test_attn.py runs it.
Tolerances: float32 -- both are online softmaxes in f32 with different tilings
and exp2 implementations: 2e-5 absolute on outputs of order 0.1-1. bf16 -- the
probabilities and the output are rounded to bf16 (8 bits) at the same points but
after sums in a different order, so single last-bit flips: 2e-2 relative to the
largest output (the bound tests/test_attn.py itself uses).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glare_tpu.nn.layers import AttnBlock as JAttnBlock
from glare_tpu.ops.attn_pallas import flash_attention_nhc as jflash
from glare_tpu_torch import convert
from glare_tpu_torch.nn.layers import AttnBlock
from glare_tpu_torch.ops import attn as tattn

from torch_port_util import need_gpu, nchw, nhwc, random_params, rel_err


@pytest.fixture(autouse=True)
def _no_grad():
    with torch.no_grad():
        yield


def _qkv(seed, b, n, c):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, n, c)).astype(np.float32) for _ in range(3)]


def _attn_sd(params):
    sd = {}
    convert._put_attn(sd, "a", params)
    return {k[2:]: v for k, v in sd.items()}


@pytest.mark.parametrize("n,n_true,bk", [(300, None, 128), (384, 301, 256)])
def test_ref_matches_pallas_interpret_f32(n, n_true, bk):
    q, k, v = _qkv(0, 2, n, 128)
    want = np.asarray(jflash(*map(jnp.asarray, (q, k, v)), bq=128, bk=bk, n_true=n_true,
                             interpret=True))
    got = tattn.flash_attention_nhc(*map(torch.from_numpy, (q, k, v)), n_true=n_true).numpy()
    nt = n if n_true is None else n_true
    assert np.max(np.abs(got[:, :nt] - want[:, :nt])) < 2e-5


def test_ref_matches_pallas_interpret_bf16():
    q, k, v = _qkv(1, 1, 300, 128)
    jq, jk, jv = [jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v)]
    want = np.asarray(jflash(jq, jk, jv, bq=128, bk=256, interpret=True).astype(jnp.float32))
    tq, tk, tv = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)]
    got = tattn.flash_attention_nhc(tq, tk, tv)
    assert got.dtype == torch.bfloat16
    assert rel_err(got.float().numpy(), want) < 2e-2


def test_ref_tile_invariance_and_dense_oracle():
    q, k, v = map(torch.from_numpy, _qkv(2, 2, 70, 32))
    a = tattn.flash_attention_nhc_ref(q, k, v, n_true=61, bk=16)
    b = tattn.flash_attention_nhc_ref(q, k, v, n_true=61, bk=1024)
    dense = torch.softmax((q @ k[:, :61].transpose(1, 2)) * 32 ** -0.5, -1) @ v[:, :61]
    assert (a - b).abs().max() < 2e-6 and (a - dense).abs().max() < 2e-6


@pytest.mark.parametrize("path", ["fused", "dense", "chunked"])
def test_attnblock_matches_jax_dense(path):
    """Port AttnBlock on each of its three paths vs the JAX block's dense path,
    same carried weights; f32, so all three agree to float32 rounding (1e-4
    relative after GroupNorm, four 1x1 convs and the softmax)."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 6, 7, 128)).astype(np.float32)
    jblk = JAttnBlock()
    params = random_params(jblk, rng, jnp.asarray(x))
    want = np.asarray(jax.jit(lambda p, a: jblk.apply({"params": p}, a))(params, jnp.asarray(x)))
    kw = {"fused": dict(use_fused=True, chunk_threshold=16),
          "dense": dict(use_fused=False),
          "chunked": dict(use_fused=False, chunk_threshold=16, q_chunk=10)}[path]
    blk = AttnBlock(128, **kw)
    blk.load_state_dict(_attn_sd(params))
    got = nhwc(blk(nchw(x)))
    assert rel_err(got, want) < 1e-4


def test_cuda_wrapper_refuses_cpu_and_bad_shapes():
    q, k, v = map(torch.from_numpy, _qkv(4, 1, 8, 16))
    with pytest.raises(ValueError):
        tattn.flash_attention_nhc_cuda(q, k, v)
    assert tattn.launches == 0


@pytest.mark.gpu
def test_kernel_matches_ref_on_gpu():
    need_gpu()
    q, k, v = [torch.from_numpy(a).cuda().to(torch.bfloat16) for a in _qkv(5, 2, 333, 128)]
    before = tattn.launches
    got = tattn.flash_attention_nhc(q, k, v, n_true=301)
    assert tattn.launches == before + 1
    want = tattn.flash_attention_nhc_ref(q, k, v, n_true=301)
    assert rel_err(got[:, :301].float().cpu(), want[:, :301].float().cpu()) < 2 ** -7
