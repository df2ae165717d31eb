"""The DCN backward: the port's plain version (autograd of
``modulated_deform_conv_ref``) against ``jax.grad`` of the JAX package's ops,
the launch-side autograd rule of the kernel wrappers, and the DCN autograd
Function's dispatch, on the CPU.

Shapes of ``tests/test_dcn.py::TestChainOp``: B 2, 6x7, C 8, O 5, G 4.

Tolerance: 1e-5 of each gradient's largest magnitude. Both sides are float32
and sum the same terms in other orders (the JAX ops by gathers or shifted
slices, the port by gathers); no gradient here has more than 9*C = 72 terms a
sum.

bf16: the plain backward on bf16 x and grad_out (float32 offsets, mask and
weight, as the AFT decoder hands them over) against ``jax.vjp`` of the chain op
in bf16, both held to the float32 vjp on the same bf16-valued inputs by the
stage-ratio rule of PERF.md section 2.

The chain caveat: at offsets that are exactly integers (every offset of the
first stage-3 step: ``conv_offset`` starts at zero) ``jax.grad`` of the chain op
is not the DCNv2 derivative (``|.|`` has slope +1 at 0 and ``max(0, .)`` splits
ties 1/2 : 1/2, so the hat weights' slopes there are -1, +1/2 and -1/2). The
reference CUDA extension (``col2im_coord``), the JAX ``xla`` op and the port
take the floor-based derivative; the port does not copy the chain's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glare_tpu.ops.dcn import modulated_deform_conv as jax_xla
from glare_tpu.ops.dcn import modulated_deform_conv_chain as jax_chain
from glare_tpu_torch.ops import _build
from glare_tpu_torch.ops import attn as attn_ops
from glare_tpu_torch.ops import dcn as dcn_ops

NAMES = ("x", "offset", "mask", "weight", "bias")
TOL = 1e-5


def _inputs(seed=0, off_scale=1.2, off=None):
    rng = np.random.RandomState(seed)
    B, H, W, C, O, G = 2, 6, 7, 8, 5, 4
    x = rng.standard_normal((B, H, W, C)).astype(np.float32)
    offset = (off_scale * rng.standard_normal((B, H, W, G, 9, 2))).astype(np.float32)
    if off is not None:
        offset = np.full_like(offset, off)
    mask = rng.uniform(0.0, 1.0, (B, H, W, G, 9)).astype(np.float32)
    weight = (0.2 * rng.standard_normal((3, 3, C, O))).astype(np.float32)
    bias = rng.standard_normal((O,)).astype(np.float32)
    g_out = rng.standard_normal((B, H, W, O)).astype(np.float32)
    return (x, offset, mask, weight, bias), g_out


_VJP = {}  # one compiled vjp per op: every case here has the same shapes
# XLA's CPU backend without its expensive passes (the chain op's vjp is large)
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def _jax_grads(op, args, g_out, **kw):
    a = (jnp.asarray(g_out),) + tuple(jnp.asarray(t) for t in args)
    key = (op, tuple(sorted(kw.items())), tuple(str(t.dtype) for t in a))
    if key not in _VJP:
        fn = jax.jit(lambda g, *a_: jax.vjp(lambda *b: op(*b, **kw), *a_)[1](g))
        _VJP[key] = fn.lower(*a).compile(compiler_options=FAST_COMPILE)
    return [np.asarray(g) for g in _VJP[key](*a)]


def _port_grads(args, g_out, max_offset):
    t = [torch.tensor(a) for a in args]
    got = dcn_ops.modulated_deform_conv_backward_ref(torch.tensor(g_out), *t, max_offset=max_offset)
    return [g.numpy() for g in got]


def _close(got, want, name):
    scale = float(np.abs(want).max())
    assert scale > 0, name
    assert float(np.abs(got - want).max()) <= TOL * scale, name


@pytest.mark.parametrize("case", ["random", "zero", "integer"])
def test_plain_backward_matches_jax_xla(case):
    """Against the exact op, unclamped: random offsets, offsets exactly 0 (the
    zero-initialised step) and exactly integer (floor-based at every sample)."""
    off = {"random": None, "zero": 0.0, "integer": 1.0}[case]
    args, g_out = _inputs(seed=1, off_scale=1.5, off=off)
    want = _jax_grads(jax_xla, args, g_out)
    got = _port_grads(args, g_out, max_offset=None)
    for name, g, w in zip(NAMES, got, want):
        _close(g, w, name)


def test_plain_backward_matches_jax_chain_off_the_grid():
    """Against the chain op at R 2, offsets off the integer grid, some inside
    (-2, 2) and some beyond: the components beyond get exactly zero gradient."""
    args, g_out = _inputs(seed=2, off_scale=1.6)
    off = args[1]
    off[np.abs(off - np.round(off)) < 1e-3] += 0.01   # keep every sample off the grid
    want = _jax_grads(jax_chain, args, g_out, max_offset=2)
    got = _port_grads(args, g_out, max_offset=2)
    for name, g, w in zip(NAMES, got, want):
        _close(g, w, name)
    beyond = np.abs(off) > 2
    assert 0.1 < beyond.mean() < 0.5
    assert np.all(got[1][beyond] == 0) and np.all(want[1][beyond] == 0)
    assert np.abs(got[1][~beyond]).min() >= 0 and np.abs(got[1][~beyond]).max() > 0


def test_plain_backward_bf16_by_the_ratio_rule():
    """bf16 x and grad_out, offsets off the integer grid (clamp R 1: the smaller
    chain graph compiles in a third of the time of R 2): each
    gradient of the port's plain backward may be at most 1.25x as far from the
    float32 vjp of the chain op (relative RMS) as the bf16 vjp of the chain op
    is, + 1e-3. The two bf16 functions round at other places: the port's column
    once, with the weight in bf16 (as the Hopper forward); the chain op sums the
    column in bf16 over the (2R + 1)^2 shifts and keeps a float32 weight."""
    args, g_out = _inputs(seed=5, off_scale=1.0)
    off = args[1]
    off[np.abs(off - np.round(off)) < 0.05] += 0.1
    assert np.abs(off - np.round(off)).min() > 0.02
    bf = lambda a: torch.tensor(a).bfloat16()  # noqa: E731
    xb, gb = bf(args[0]), bf(g_out)
    as_f32 = lambda t: t.float().numpy()  # noqa: E731
    f32_args = (as_f32(xb),) + args[1:]
    want = _jax_grads(jax_chain, f32_args, as_f32(gb), max_offset=1)
    jb_args = (as_f32(xb).astype(jnp.bfloat16),) + args[1:]
    jax_bf16 = _jax_grads(jax_chain, jb_args, as_f32(gb).astype(jnp.bfloat16), max_offset=1)
    t = [torch.tensor(a) for a in args[1:]]
    got = dcn_ops.modulated_deform_conv_backward_ref(gb, xb, *t, max_offset=1)
    assert got[0].dtype == torch.bfloat16 and got[3].dtype == torch.float32
    for name, g, j, w in zip(NAMES, got, jax_bf16, want):
        w = w.astype(np.float64)
        rms = np.sqrt((w ** 2).mean())
        d = lambda a: float(np.sqrt(((np.asarray(a, np.float64) - w) ** 2).mean()) / rms)  # noqa: E731
        d_port, d_jax = d(g.float().numpy()), d(np.asarray(j, np.float32))
        assert d_port <= 1.25 * d_jax + 1e-3, (name, d_port, d_jax)


def test_public_chain_op_matches_jax_forward_and_off_grid_gradient():
    """``ops.dcn.modulated_deform_conv_chain``, the port's name for the JAX chain
    op: its forward at 16x16 (one jit of the JAX forward) and, off the integer
    grid, the gradient of every input through autograd (the compiled vjp above)."""
    rng = np.random.RandomState(9)
    B, H, W, C, O, G = 1, 16, 16, 8, 5, 4
    fwd = [rng.standard_normal((B, H, W, C)), 1.6 * rng.standard_normal((B, H, W, G, 9, 2)),
           rng.uniform(0.0, 1.0, (B, H, W, G, 9)), 0.2 * rng.standard_normal((3, 3, C, O)),
           rng.standard_normal((O,))]
    fwd = [a.astype(np.float32) for a in fwd]
    want = np.asarray(jax.jit(lambda *a: jax_chain(*a, max_offset=2))(*map(jnp.asarray, fwd)))
    got = dcn_ops.modulated_deform_conv_chain(*map(torch.from_numpy, fwd), max_offset=2).numpy()
    _close(got, want, "forward")

    args, g_out = _inputs(seed=2, off_scale=1.6)
    off = args[1]
    off[np.abs(off - np.round(off)) < 1e-3] += 0.01   # keep every sample off the grid
    want = _jax_grads(jax_chain, args, g_out, max_offset=2)
    t = [torch.tensor(a, requires_grad=True) for a in args]
    out = dcn_ops.modulated_deform_conv_chain(*t, max_offset=2)
    out.backward(torch.tensor(g_out))
    for name, a, w in zip(NAMES, t, want):
        _close(a.grad.numpy(), w, name)


def test_chain_caveat_at_zero_offsets():
    """At offsets exactly 0 the chain op's offset gradient is not the DCNv2
    derivative; the port's equals the xla op's."""
    args, g_out = _inputs(seed=3, off=0.0)
    chain = _jax_grads(jax_chain, args, g_out, max_offset=2)[1]
    xla = _jax_grads(jax_xla, args, g_out)[1]
    port = _port_grads(args, g_out, max_offset=2)[1]
    _close(port, xla, "offset")
    assert float(np.abs(chain - xla).max()) > 0.1 * float(np.abs(xla).max())
    # on a constant image the DCNv2 offset gradient vanishes at interior pixels;
    # the chain's does not
    const = (np.ones_like(args[0]),) + args[1:]
    c_chain = _jax_grads(jax_chain, const, g_out, max_offset=2)[1][:, 2:-2, 2:-2]
    c_port = _port_grads(const, g_out, max_offset=2)[1][:, 2:-2, 2:-2]
    assert float(np.abs(c_port).max()) < 1e-5 and float(np.abs(c_chain).max()) > 0.1


def test_clamp_slope_is_half_on_the_radius():
    """On the radius the clamp's slope is 1/2 (torch and XLA split min/max ties),
    which the kernel copies; beyond it, 0."""
    args, g_out = _inputs(seed=4, off_scale=0.5)
    off = args[1]
    off[..., 0] = 2.0
    off[..., 1] = np.clip(off[..., 1], -1.9, 1.9)
    got = _port_grads(args, g_out, max_offset=2)[1]
    free = _port_grads(args, g_out, max_offset=None)[1]
    np.testing.assert_allclose(got[..., 0], 0.5 * free[..., 0], rtol=1e-6, atol=1e-7)


class _Stub:
    """A tensor-shaped stand-in: what the launch-side rule reads of an input."""

    def __init__(self, requires_grad):
        self.requires_grad = requires_grad


@pytest.mark.parametrize("grad_enabled", [True, False])
def test_refuse_grad_rule(grad_enabled):
    """The rule: grad enabled and any input that requires grad -> RuntimeError
    naming the op; otherwise nothing (None inputs ignored)."""
    with torch.set_grad_enabled(grad_enabled):
        _build.refuse_grad("op", _Stub(False), None)
        if grad_enabled:
            with pytest.raises(RuntimeError, match="some_op"):
                _build.refuse_grad("some_op", _Stub(False), _Stub(True))
        else:
            _build.refuse_grad("some_op", _Stub(True))


def test_kernel_wrappers_refuse_grad_on_the_card(monkeypatch):
    """With the CUDA predicate stubbed, the dispatchers take the CUDA side for CPU
    tensors: attention and the cascade raise before any launch when an input
    requires grad, and the DCN forward goes through the autograd Function."""
    monkeypatch.setattr(_build, "on_card", lambda t: True)
    q = torch.randn(1, 16, 8, requires_grad=True)
    with pytest.raises(RuntimeError, match="flash_attention_nhc_cuda"):
        attn_ops.flash_attention_nhc(q, q, q)
    (x, off, mask, w, b), _ = _inputs()
    x, off, mask, w, b = (torch.tensor(a) for a in (x, off, mask, w, b))
    wr = w.clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match="modulated_deform_conv_cascade_cuda"):
        dcn_ops.modulated_deform_conv_cascade(x, off, mask, wr, b)
    with pytest.raises(RuntimeError, match="modulated_deform_conv_cuda"):
        dcn_ops.modulated_deform_conv_cuda(x, off, mask, wr, b)

    calls = []

    def fake_fwd(x_, off_, mask_, w_, b_, max_offset=None, return_overflow=False, entry=None):
        calls.append(("fwd", torch.is_grad_enabled()))
        return dcn_ops.modulated_deform_conv_ref(x_, off_, mask_, w_, b_, max_offset=max_offset,
                                                 return_overflow=return_overflow)

    def fake_bwd(g, x_, off_, mask_, w_, max_offset=None, need_x=False):
        calls.append(("bwd", need_x))
        gx, go, gm, gw, gb = dcn_ops.modulated_deform_conv_backward_ref(
            g, x_, off_, mask_, w_, torch.zeros(w_.shape[-1]), max_offset=max_offset)
        return (gx if need_x else None), go, gm, gw, gb

    monkeypatch.setattr(dcn_ops, "modulated_deform_conv_cuda", fake_fwd)
    monkeypatch.setattr(dcn_ops, "modulated_deform_conv_backward_cuda", fake_bwd)
    offr = off.clone().requires_grad_(True)
    out, ov = dcn_ops.modulated_deform_conv(x, offr, mask, wr, b, max_offset=2, return_overflow=True)
    out.square().sum().backward()
    assert calls == [("fwd", False), ("bwd", False)]
    assert ov.tolist() == dcn_ops.clamp_overflow(off, 2).tolist()
    ref_off, ref_w = off.clone().requires_grad_(True), w.clone().requires_grad_(True)
    dcn_ops.modulated_deform_conv_ref(x, ref_off, mask, ref_w, b, max_offset=2).square().sum().backward()
    torch.testing.assert_close(offr.grad, ref_off.grad)
    torch.testing.assert_close(wr.grad, ref_w.grad)
    # no grad wanted: the kernel path itself, once
    calls.clear()
    with torch.no_grad():
        dcn_ops.modulated_deform_conv(x, offr, mask, wr, b, max_offset=2)
    assert calls == [("fwd", False)]
    # bf16 x under autograd: the same Function (the bf16 backward entries on the card)
    calls.clear()
    out16 = dcn_ops.modulated_deform_conv(x.bfloat16(), offr, mask, wr, b, max_offset=2)
    assert out16.dtype == torch.bfloat16
    out16.float().sum().backward()
    assert calls == [("fwd", False), ("bwd", False)] and wr.grad.dtype == torch.float32
