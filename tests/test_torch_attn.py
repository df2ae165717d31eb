"""Port's fused-attention function and AttnBlock vs the JAX package (CPU).

The JAX kernel runs in Pallas interpret mode, as tests/test_attn.py runs it.
Tolerances: float32 -- both are online softmaxes in f32 with different tilings
and exp2 implementations: 2e-5 absolute on outputs of order 0.1-1. bf16 -- the
probabilities and the output are rounded to bf16 (8 bits) at the same points but
after sums in a different order, so single last-bit flips: 2e-2 relative to the
largest output (the bound tests/test_attn.py itself uses).

The float32 kernel entry (``hopper_f32``) takes every product as 3xTF32: a
torch model of that arithmetic (operands split into big = tf32(x) and small =
tf32(x - big), TF32 by rounding the low 13 mantissa bits to nearest, the three
products summed in float32) is held to a float64 dense oracle: at most 2x the
plain float32 version's own error, the bar the card holds the kernel to; TF32
alone (no small terms) misses it by orders of magnitude.
"""

import os

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


def test_route_choice_by_dtype_and_width():
    """The entry a CUDA call takes is fixed by dtype and head dimension before any
    launch: bf16 C = 512 -> hopper, other bf16 widths -> wmma, float32 (any C) ->
    hopper_f32; f32_simt only when named. A CPU tensor takes the plain version and
    moves no count."""
    def mk(c, dt):
        return torch.zeros((1, 4, c), dtype=dt)

    assert tattn.route(mk(512, torch.bfloat16)) == "hopper"
    assert tattn.route(mk(96, torch.bfloat16)) == "wmma"
    assert tattn.route(mk(256, torch.bfloat16)) == "wmma"
    assert tattn.route(mk(512, torch.float32)) == "hopper_f32"
    assert tattn.route(mk(96, torch.float32)) == "hopper_f32"
    assert set(tattn.launches_by_entry) == {"hopper", "wmma", "hopper_f32", "f32_simt"}
    q, k, v = [torch.from_numpy(a).to(torch.bfloat16) for a in _qkv(6, 1, 40, 512)]
    before = (tattn.launches, dict(tattn.launches_by_entry))
    got = tattn.flash_attention_nhc(q, k, v, n_true=37)
    assert (tattn.launches, tattn.launches_by_entry) == before
    assert torch.equal(got, tattn.flash_attention_nhc_ref(q, k, v, n_true=37))
    csrc = os.path.join(os.path.dirname(tattn.__file__), "..", "csrc")
    assert 'extern "C" int attn_hopper_bf16(' in open(os.path.join(csrc, "attn_hopper.cu")).read()
    src = open(os.path.join(csrc, "attn_hopper_f32.cu")).read()
    for fn in ("attn_hopper_f32(", "attn_hopper_f32_scratch_bytes(", "attn_hopper_f32_smem_bytes("):
        assert f'extern "C" ' in src and fn in src, fn


@pytest.mark.gpu
@pytest.mark.parametrize("b,n,c,n_true,entry", [(2, 333, 128, 301, "wmma"), (1, 2100, 512, 2047, "hopper"),
                                                (2, 333, 128, 301, "hopper_f32"),
                                                (1, 2100, 512, 2047, "hopper_f32")])
def test_kernel_matches_ref_on_gpu(b, n, c, n_true, entry):
    """bf16 within 2^-7 relative; float32 (hopper_f32) within 5e-5 absolute."""
    need_gpu()
    f32 = entry in tattn.F32_ENTRIES
    q, k, v = [torch.from_numpy(a).cuda().to(torch.float32 if f32 else torch.bfloat16)
               for a in _qkv(5, b, n, c)]
    before = (tattn.launches, dict(tattn.launches_by_entry))
    got = tattn.flash_attention_nhc(q, k, v, n_true=n_true)
    assert tattn.launches == before[0] + 1
    assert tattn.launches_by_entry == {e: m + (e == entry) for e, m in before[1].items()}
    want = tattn.flash_attention_nhc_ref(q, k, v, n_true=n_true)
    g, w = got[:, :n_true].float().cpu(), want[:, :n_true].float().cpu()
    if f32:
        assert float((g - w).abs().max()) < 5e-5
    else:
        assert rel_err(g, w) < 2 ** -7


def _tf32(x):
    """Round float32 to TF32 (10 mantissa bits), to nearest, ties away from 0."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _split(x):
    big = _tf32(x)
    return big, _tf32(x - big)


def _mm_3xtf32(a, b):
    (ab, as_), (bb, bs) = _split(a), _split(b.contiguous())
    return (as_ @ bb + ab @ bs) + ab @ bb


def _mm_tf32(a, b):
    return _tf32(a) @ _tf32(b.contiguous())


def _attn_model(q, k, v, nt, mm):
    """One key tile of flash_attention_nhc_ref's arithmetic with products ``mm``."""
    qs = tattn._scale_q(q)
    s = mm(qs, k[:, :nt].transpose(1, 2))
    p = torch.exp2(s - s.max(dim=-1, keepdim=True).values)
    return mm(p, v[:, :nt]) / p.sum(dim=-1, keepdim=True)


@pytest.mark.parametrize("c", [128, 512])
@pytest.mark.parametrize("n", [16, 32, 64])
def test_3xtf32_split_is_as_good_as_float32(n, c):
    q, k, v = map(torch.from_numpy, _qkv(10 + n + c, 2, n, c))
    nt = n - 3
    big, small = _split(q)
    assert not bool(((big.view(torch.int32) | small.view(torch.int32)) & 0x1FFF).any())
    assert bool(((q - big).abs() <= 2.0 ** -11 * q.abs()).all())
    oracle = torch.softmax((q[:, :nt].double() @ k[:, :nt].double().transpose(1, 2)) * c ** -0.5, -1) \
        @ v[:, :nt].double()
    err = {name: float((out.double() - oracle).abs().max()) for name, out in (
        ("plain", tattn.flash_attention_nhc_ref(q, k, v, n_true=nt)[:, :nt]),
        ("3xtf32", _attn_model(q, k, v, nt, _mm_3xtf32)[:, :nt]),
        ("tf32", _attn_model(q, k, v, nt, _mm_tf32)[:, :nt]))}
    assert err["3xtf32"] <= 2.0 * err["plain"], err
    assert err["tf32"] > 100.0 * err["plain"], err
