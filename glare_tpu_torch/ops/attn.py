"""Fused single-head attention, forward only.

Counterpart of ``glare_tpu/ops/attn_pallas.py``. Layout as there: q, k, v are
``[B, N, C]`` (the natural reshape of a channels-last feature map), the result
is ``[B, N, C]`` in q's dtype.

  * :func:`flash_attention_nhc_ref` -- plain PyTorch: a key-tiled online
    softmax in float32 with the kernel's cast points (scale*log2(e) folded
    into q in f32 then cast back, exp2, probabilities cast to v's dtype before
    the PV product, keys >= ``n_true`` masked to -1e30).
  * :func:`flash_attention_nhc_cuda` -- the hand-written kernels that replace
    the Pallas ``_kernel`` / ``_kernel_pipe``, one of three entries chosen by
    :func:`route` from dtype and head dimension before the launch:
    ``hopper`` (``csrc/attn_hopper.cu``: TMA + wgmma, warp-specialised; bf16,
    C = 512, every attention block of the model), ``wmma``
    (``csrc/attn_fused.cu``: other bf16 widths, C % 16 == 0, C <= 512) and
    ``hopper_f32`` (``csrc/attn_hopper_f32.cu``: float32, any C <= 512, every
    product 3xTF32 on wgmma after a split pass). ``f32_simt``
    (``csrc/attn_fused.cu``: the earlier float32 kernel on the float32 units)
    is taken only when named.
  * :func:`flash_attention_nhc` -- dispatch by where the tensors lie: CUDA
    tensors launch a kernel (or raise), CPU tensors take the plain version.
    The kernels have no backward: with grad enabled, an input that requires
    grad makes the CUDA wrapper raise (``_build.refuse_grad``). Training never
    reaches them (at the training crop every block is dense, ``nn/layers.py``).

What bounds the kernels on an H100: tensor-core operations, ``4*B*N*N*C``
FLOP (three times that in TF32 for ``hopper_f32``); the design notes are in
the CUDA sources.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build

launches = 0  # +1 per kernel launch (any entry), nowhere else
launches_by_entry = {"hopper": 0, "wmma": 0, "hopper_f32": 0, "f32_simt": 0}  # +1 per launch of that entry
F32_ENTRIES = ("hopper_f32", "f32_simt")  # the entries that take float32 inputs

HOPPER_C = 512  # the one head dimension the Hopper entry serves

_NEG_INF = -1e30
_LOG2E = 1.4426950408889634


def _scale_q(q: torch.Tensor) -> torch.Tensor:
    scale = float(q.shape[-1]) ** -0.5 * _LOG2E
    return (q.float() * scale).to(q.dtype)


def flash_attention_nhc_ref(q, k, v, n_true: Optional[int] = None, bk: int = 1024):
    """Plain PyTorch online softmax; see module docstring."""
    b, n, c = q.shape
    n_true = n if n_true is None else int(n_true)
    qs = _scale_q(q).float()
    m = torch.full((b, n, 1), _NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, n, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, n, c), dtype=torch.float32, device=q.device)
    for j0 in range(0, n_true, bk):
        j1 = min(j0 + bk, n)
        s = qs @ k[:, j0:j1].float().transpose(1, 2)
        if j1 > n_true:
            dead = torch.arange(j0, j1, device=q.device) >= n_true
            s = s.masked_fill(dead[None, None, :], _NEG_INF)
        m_new = torch.maximum(m, s.max(dim=-1, keepdim=True).values)
        corr = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + p.to(v.dtype).float() @ v[:, j0:j1].float()
        m = m_new
    return (acc / l).to(q.dtype)


_entries = None


def _kernels() -> dict:
    """entry name -> ctypes function. One C signature (q, k, v, out, B, n,
    n_true, C, stream); ``hopper_f32`` takes a scratch pointer before the stream."""
    global _entries
    if _entries is None:
        fused, hopper = _build.load("attn_fused"), _build.load("attn_hopper")
        hopper32 = _build.load("attn_hopper_f32")
        entries = {"hopper": hopper.attn_hopper_bf16, "wmma": fused.attn_fused_bf16,
                   "hopper_f32": hopper32.attn_hopper_f32, "f32_simt": fused.attn_fused_f32}
        for name, fn in entries.items():
            scratch = [ctypes.c_void_p] if name == "hopper_f32" else []
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + scratch + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        _entries = entries
    return _entries


def hopper_smem_bytes() -> int:
    """Dynamic shared memory a block of the Hopper entry asks for."""
    lib = _build.load("attn_hopper")
    lib.attn_hopper_smem_bytes.restype = ctypes.c_int
    return int(lib.attn_hopper_smem_bytes())


def hopper_f32_smem_bytes() -> int:
    """Dynamic shared memory a block of the float32 Hopper entry asks for."""
    lib = _build.load("attn_hopper_f32")
    lib.attn_hopper_f32_smem_bytes.restype = ctypes.c_int
    return int(lib.attn_hopper_f32_smem_bytes())


def hopper_f32_scratch_bytes(b: int, n: int) -> int:
    """Device scratch the float32 Hopper entry needs for b images of n tokens
    (big and small parts of q, k and v^T, written by its split pass)."""
    fn = _build.load("attn_hopper_f32").attn_hopper_f32_scratch_bytes
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_longlong
    return int(fn(b, n))


def route(q: torch.Tensor) -> str:
    """The kernel entry a CUDA call with q's dtype and head dimension takes."""
    if q.dtype == torch.float32:
        return "hopper_f32"
    if q.shape[-1] == HOPPER_C:
        return "hopper"
    return "wmma"


def flash_attention_nhc_cuda(q, k, v, n_true: Optional[int] = None, entry: Optional[str] = None):
    """Launches the kernel entry ``route(q)`` picks; ``entry`` names another
    one that takes these inputs (the earlier ``wmma`` kernel at C = 512, or
    ``f32_simt`` for float32, to time the two side by side). ``hopper_f32``
    runs its split pass and its attention kernel in one launch of the entry,
    into a scratch buffer allocated here."""
    global launches
    _build.refuse_grad("flash_attention_nhc_cuda", q, k, v)
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("flash_attention_nhc_cuda needs CUDA tensors")
    if q.dim() != 3 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q, k, v must share one [B, N, C] shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"q, k, v must all be bfloat16 or all float32, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    b, n, c = q.shape
    n_true = n if n_true is None else int(n_true)
    if not 1 <= n_true <= n:
        raise ValueError(f"n_true={n_true} outside [1, {n}]")
    if c > 512 or (q.dtype == torch.bfloat16 and c % 16 != 0):
        raise ValueError(f"head dimension {c} not supported by the kernel "
                         "(at most 512; a multiple of 16 for bfloat16)")
    entry = route(q) if entry is None else entry
    if entry not in launches_by_entry or (entry in F32_ENTRIES) != (q.dtype == torch.float32) \
            or (entry == "hopper" and c != HOPPER_C):
        raise ValueError(f"entry {entry!r} does not take {q.dtype} inputs with C = {c}")
    qs = _scale_q(q).contiguous()
    k = k.contiguous()
    v = v.contiguous()
    if entry == "hopper":  # TMA needs 16-byte aligned bases
        k, v = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (k, v))
    out = torch.empty_like(qs)
    fn = _kernels()[entry]
    with torch.cuda.device(q.device):
        scratch = []
        if entry == "hopper_f32":
            buf = torch.empty(hopper_f32_scratch_bytes(b, n) // 4, dtype=torch.float32, device=q.device)
            scratch = [buf.data_ptr()]
        err = fn(qs.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, n, n_true, c,
                 *scratch, torch.cuda.current_stream().cuda_stream)
    _build.check(err, fn.__name__)
    launches += 1
    launches_by_entry[entry] += 1
    return out


def flash_attention_nhc(q, k, v, *, n_true: Optional[int] = None, pipeline: bool = False):
    """softmax(q k^T / sqrt(C)) v for ``[B, N, C]`` single-head inputs.

    ``n_true``: callers that carry padded tokens pass the real token count;
    keys/values beyond it are masked, padded query rows compute garbage and
    stay in the output for the caller to slice. ``pipeline`` is accepted for
    parity with the JAX entry (there it picks a software-pipelined schedule
    of the same function); the same CUDA kernel serves both.
    """
    del pipeline
    if _build.on_card(q):
        return flash_attention_nhc_cuda(q, k, v, n_true=n_true)
    return flash_attention_nhc_ref(q, k, v, n_true=n_true)
