"""The DCN backward's gather pass on the CPU: its plain version
(``dcn_backward_pass_ref``), composed with the two products by the backward's
own chunk loop (``_backward_by_pass``), against the plain backward (autograd of
``modulated_deform_conv_ref``, itself held to ``jax.grad`` of the JAX package's
ops in ``tests/test_torch_dcn_bwd.py``), at 16x16.

float32: every gradient within 1e-5 of its largest (the same float32 terms,
summed in another order by the split into grad_col, the pass and the
grad_weight product). bf16: the composition in bf16 may be at most 1.25 x as
far (relative RMS) from the float32 plain backward as the plain bf16 backward
is, + 1e-3 (the stage-ratio rule of PERF.md section 2).

Also: the pass's wrapper refuses what the kernel does not take before any
launch; the design study's text edits still apply to the shipped sources (the
tool raises on the card otherwise); and, on a card only (skipped here), the
pass kernel against its plain version.
"""

import numpy as np
import pytest
import torch

from glare_tpu_torch.ops import _build
from glare_tpu_torch.ops import dcn as dcn_ops
from torch_port_util import need_gpu

NAMES = ("x", "offset", "mask", "weight", "bias")
B, H, W, C, G, O = 2, 16, 16, 16, 4, 12
R = 2


def _inputs(case, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, H, W, C)).astype(np.float32)
    off = (1.5 * rng.standard_normal((B, H, W, G, 9, 2))).astype(np.float32)
    if case == "zero":
        off[:] = 0.0
    elif case == "integer":      # every sample on the pixel grid: the floor-based derivative
        off = np.round(off)
    elif case == "radius":       # dy exactly on the clamp radius (slope 1/2), dx inside
        off[..., 0] = np.where(rng.uniform(size=off.shape[:-1]) < 0.5, -R, R)
        off[..., 1] = np.clip(off[..., 1], -1.9, 1.9)
    elif case == "beyond":       # every component beyond the radius: offset gradient 0
        off = np.sign(off) * (R + 0.25 + np.abs(off)).astype(np.float32)
    mask = rng.uniform(0, 1, (B, H, W, G, 9)).astype(np.float32)
    w = (0.2 * rng.standard_normal((3, 3, C, O))).astype(np.float32)
    go = rng.standard_normal((B, H, W, O)).astype(np.float32)
    return [torch.from_numpy(a) for a in (x, off, mask, w, go)]


def _plain_pass(x, offset, mask, radii, grad_col, grad_offset, grad_mask, grad_x=None):
    """dcn_backward_pass_ref with the kernel wrapper's signature."""
    col, goff, gmask, gx = dcn_ops.dcn_backward_pass_ref(x, offset, mask, grad_col, radii,
                                                         need_x=grad_x is not None)
    grad_offset.copy_(goff)
    grad_mask.copy_(gmask)
    if grad_x is not None:
        grad_x += gx.float()
    return col


def _composed(x, off, mask, w, go, need_x):
    return dcn_ops._backward_by_pass(go, x, off, mask, w, dcn_ops.clamp_table(R, G), need_x, _plain_pass)


@pytest.mark.parametrize("case", ["random", "zero", "integer", "radius", "beyond"])
def test_pass_composed_equals_the_plain_backward(case):
    x, off, mask, w, go = _inputs(case)
    got = _composed(x, off, mask, w, go, need_x=True)
    want = dcn_ops.modulated_deform_conv_backward_ref(go, x, off, mask, w, torch.zeros(O), max_offset=R)
    for name, g, ww in zip(NAMES, got, want):
        scale = float(ww.abs().max())
        if case == "beyond" and name == "offset":
            assert scale == 0 and bool((g == 0).all())
            continue
        assert g.dtype == torch.float32 and scale > 0, name
        assert float((g - ww).abs().max()) <= 1e-5 * scale, name
    beyond = off.abs() > R
    assert bool((got[1][beyond] == 0).all())


def test_pass_column_is_the_forwards():
    """The pass's column times the weight, plus bias, is the plain forward."""
    x, off, mask, w, go = _inputs("random", seed=1)
    gcol = torch.zeros(B * H * W, 9 * C)
    col, _, _, gx = dcn_ops.dcn_backward_pass_ref(x, off, mask, gcol, R)
    assert gx is None and col.shape == (B * H * W, 9 * C)
    b = torch.linspace(-1, 1, O)
    want = dcn_ops.modulated_deform_conv_ref(x, off, mask, w, b, max_offset=R)
    assert torch.equal((col @ w.reshape(9 * C, O) + b).reshape(B, H, W, O), want)


def test_chunked_backward_sums_over_chunks(monkeypatch):
    """One image a chunk: the row and batch slices and the grad_weight sum."""
    x, off, mask, w, go = _inputs("random", seed=2)
    whole = _composed(x, off, mask, w, go, need_x=True)
    monkeypatch.setattr(dcn_ops, "BWD_CHUNK_BYTES", H * W * 9 * C * 4)
    calls = []

    def counting(*a):
        calls.append(a[0].shape[0])
        return _plain_pass(*a)

    chunked = dcn_ops._backward_by_pass(go, x, off, mask, w, dcn_ops.clamp_table(R, G), True, counting)
    assert calls == [1, 1]
    for name, a, b in zip(NAMES, whole, chunked):
        assert float((a - b).abs().max()) <= 1e-6 * float(a.abs().max()), name


def test_pass_composed_bf16_by_the_ratio_rule():
    x, off, mask, w, go = _inputs("random", seed=3)
    off[(off - off.round()).abs() < 0.05] += 0.1     # off the grid: no derivative jump between types
    xb, gb = x.bfloat16(), go.bfloat16()
    got = _composed(xb, off, mask, w, gb, need_x=True)
    plain = dcn_ops.modulated_deform_conv_backward_ref(gb, xb, off, mask, w, torch.zeros(O), max_offset=R)
    f32 = dcn_ops.modulated_deform_conv_backward_ref(gb.float(), xb.float(), off, mask, w, torch.zeros(O),
                                                     max_offset=R)
    assert got[0].dtype == torch.bfloat16 and got[3].dtype == torch.float32
    for name, g, p, ww in zip(NAMES, got, plain, f32):
        ww = ww.double()
        rms = float((ww ** 2).mean().sqrt())
        d = lambda a: float(((a.double() - ww) ** 2).mean().sqrt()) / rms  # noqa: E731
        assert d(g) <= 1.25 * d(p) + 1e-3, (name, d(g), d(p))


def test_design_study_edits_apply_to_the_shipped_sources():
    """tools/dcn_train_designs.py builds its designs by replacing text that must
    occur once in the shipped sources; a stale edit would only fail on the card."""
    from glare_tpu_torch.tools import dcn_train_designs as tool

    srcs = {name: open(_build.sources()[name]).read() for name in ("dcn_fwd", "dcn_bwd")}
    for name, edits in tool.FWD_DESIGNS.items():
        tool._edited(srcs["dcn_fwd"], edits, name)
    for name, edits in tool.PASS_DESIGNS.items():
        tool._edited(srcs["dcn_bwd"], edits, name)
    for entry in ("dcn_bwd_im2col", "dcn_bwd_coord", "dcn_bwd_im2col_bf16", "dcn_bwd_coord_bf16"):
        assert f'extern "C" int {entry}(' in tool.OLD_BWD_SRC, entry


@pytest.mark.parametrize("bad", ["cpu", "grad_col_rows", "grad_col_dtype", "offset_dtype", "radii",
                                 "grad_x_shape", "float16"])
def test_pass_wrapper_refuses_what_the_kernel_does_not_take(bad):
    """Refused before any launch (the counters untouched): tensors off the card,
    or shapes and dtypes the pass does not take."""
    x, off, mask, w, go = _inputs("random")
    radii = dcn_ops.clamp_table(R, G)
    gcol = torch.zeros(B * H * W, 9 * C)
    goff, gmask, gx = torch.empty_like(off), torch.empty_like(mask), torch.zeros(x.shape)
    if bad == "grad_col_rows":
        gcol = gcol[1:]
    elif bad == "grad_col_dtype":
        gcol = gcol.bfloat16()
    elif bad == "offset_dtype":
        off = off.double()
    elif bad == "radii":
        radii = radii[:, :8].contiguous()
    elif bad == "grad_x_shape":
        gx = gx[:1]
    elif bad == "float16":
        x, gcol = x.half(), gcol.half()
    before = (dcn_ops.bwd_launches, dict(dcn_ops.bwd_launches_by_entry))
    with pytest.raises(ValueError):
        dcn_ops.dcn_backward_pass_cuda(x, off, mask, radii, gcol, goff, gmask, gx)
    assert before == (dcn_ops.bwd_launches, dict(dcn_ops.bwd_launches_by_entry))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pass_kernel_matches_its_plain_version_on_gpu(dtype):
    need_gpu()
    x, off, mask, w, go = (t.cuda() for t in _inputs("random", seed=4))
    x = x.to(dtype)
    radii = dcn_ops.clamp_table(R, G).cuda()
    gcol = go.reshape(-1, O).to(dtype) @ w.reshape(9 * C, O).to(dtype).t()
    goff, gmask, gx = torch.empty_like(off), torch.empty_like(mask), torch.zeros(x.shape, device="cuda")
    before = dict(dcn_ops.bwd_launches_by_entry)
    col = dcn_ops.dcn_backward_pass_cuda(x, off, mask, radii, gcol, goff, gmask, gx)
    key = "pass_x" + ("_bf16" if dtype == torch.bfloat16 else "")
    assert dcn_ops.bwd_launches_by_entry == {k: n + (k == key) for k, n in before.items()}
    # the plain version in float32 on the same values (the kernel computes in float32)
    want = dcn_ops.dcn_backward_pass_ref(x.float(), off, mask, gcol.float(), radii, need_x=True)
    loose = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-4   # the bf16 column's one rounding
    for name, g, ww, tol in zip(("col", "offset", "mask", "x"), (col, goff, gmask, gx), want,
                                (loose, 1e-4, 1e-4, 1e-4)):
        assert float((g.float() - ww.float()).abs().max()) <= tol * float(ww.float().abs().max()), name
