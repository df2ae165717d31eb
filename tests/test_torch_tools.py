"""The port's model-driving tools (``glare_tpu_torch/tools/``) and
``utils/profiling.py`` on the CPU, at the mini sizes of the other port tests.

  * ``flops_audit``: the kernel rows equal the formulas of PERF.md section 6 on
    the shapes the mini stage-3 forward gives its kernels (DCN 2 * P * 9 * C * O
    from each pack's recorded shapes, ``vq_argmin`` 2 * N * K * (D + 1),
    attention 4 * n_true^2 * C), the plain versions' own products are taken out
    of the total, and the count does not depend on the device path.
  * ``offset_histogram``: ``offset_stats`` equals the JAX tool's
    ``tools/offset_histogram.offset_stats`` on the same arrays; the offsets its
    hooks capture give the statistics of ``VQLLFLOWDModel.audit_dcn_offsets``.
  * ``active_codebook.usage_counts`` equals a direct count of the quantizer's
    indices, in the JAX tool's grid layout.
  * ``profiling.timed`` / ``StepTimer`` behave as the JAX package's on the CPU;
    ``trace`` writes a Chrome trace; ``aggregate`` reads a CPU-only trace as no
    device time.
"""

import collections
import json
import os
import sys

import numpy as np
import pytest
import torch

from glare_tpu.utils import profiling as jprofiling
from glare_tpu_torch.tools import active_codebook, flops_audit, offset_histogram
from glare_tpu_torch.utils import profiling

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
from tools import offset_histogram as jax_offset_histogram  # noqa: E402

MINI3 = dict(enc_ch=32, decoder_ch=32, enc_num_res_blocks=1, dec_num_res_blocks=1,
             flow={"K": 2, "L": 1, "additionalFlowNoAffine": 2}, vq_ch=32, vq_n_embed=64, vq_num_res_blocks=1)


@pytest.fixture(scope="module")
def mini3():
    torch.manual_seed(0)
    return flops_audit.build_stage3(32, 48, "float32", "pallas", "cpu", **MINI3)


def test_flops_audit_kernel_rows_are_the_formulas(mini3):
    model, lq = mini3
    res = flops_audit.stage3_flops(model, lq)
    packs = model.netG.deformable_decoder.dcn_packs()
    want_dcn = 0
    for p in packs:
        b, h, w, c = p.last_shapes["x"]
        want_dcn += 2 * b * h * w * 9 * c * p.weight.shape[0]
    assert res["aft_half"]["kernels"] == {"dcn": want_dcn} and res["aft_half"]["calls"] == {"dcn": len(packs)}
    n_tok = (32 // 4) * (48 // 4)
    assert res["vq_decode"]["kernels"] == {"vq_argmin": 2 * n_tok * 64 * (3 + 1)}
    assert res["latent_half"]["kernels"] == {}   # 96 tokens: dense attention, no kernel
    assert res["total"] == sum(res[k]["total"] for k in ("latent_half", "vq_decode", "aft_half"))
    for k in ("latent_half", "vq_decode", "aft_half"):
        assert res[k]["total"] == res[k]["counted_outside_kernels"] + sum(res[k]["kernels"].values())
        assert res[k]["counted_outside_kernels"] > 0


def test_flops_audit_attention_row_and_plain_share_taken_out():
    from glare_tpu_torch.ops import attn

    q = torch.randn(2, 130, 16)
    r = flops_audit.count(lambda: attn.flash_attention_nhc(q, q, q, n_true=100))
    assert r == {"total": 4 * 2 * 100 * 100 * 16, "kernels": {"attention": 4 * 2 * 100 * 100 * 16},
                 "calls": {"attention": 1}, "counted_outside_kernels": 0}
    # a product outside the kernels is counted as it runs
    a = torch.randn(8, 16)
    assert flops_audit.count(lambda: a @ a.t())["total"] == 2 * 8 * 16 * 8
    assert flops_audit.ceiling(989e12 / 7.0, flops_audit.PEAK_BF16) == pytest.approx(7.0)


def test_offset_stats_matches_jax_tool():
    rng = np.random.default_rng(3)
    chunks = [rng.standard_normal((1, 13, 21, 4, 9, 2)).astype(np.float32) * s for s in (1.5, 3.0)]
    chunks.append(rng.standard_normal((2, 9, 21, 4, 9, 2)).astype(np.float32) * 0.7)
    assert offset_histogram.offset_stats(chunks) == jax_offset_histogram.offset_stats(chunks)


def test_offset_histogram_hooks_give_the_audit_stats(mini3):
    model, lq = mini3
    offs = offset_histogram.collect_offsets(model, lq)
    assert len(offs) == 2 and all(v.shape[-3:] == (4, 9, 2) for v in offs.values())
    audit = model.audit_dcn_offsets(lq, radii=(1, 2, 4, 8))
    for w, name in enumerate(sorted(offs, key=lambda n: [p for p, m in model.netG.named_modules()].index(n))):
        st, au = offset_histogram.offset_stats([offs[name]]), audit["warps"][f"warp_{w}"]
        assert st["max"] == round(au["tap_max"], 4) and st["p99"] == round(au["tap_p99"], 4)
        assert st["per_gk_max"] == [[round(v, 4) for v in row] for row in au["per_gk_max"]]
        for r in (1, 2, 4, 8):
            assert st["frac_exceed"][str(r)] == round(au["tap_frac_exceed"][r], 6)
            assert st["pix_frac_exceed"][str(r)] == round(au["pix_frac_exceed"][r], 6)
            for rpb in (8, 16):
                assert st["rowblk_frac_exceed_by_rpb"][str(rpb)][str(r)] == round(
                    au["rowblk_frac_exceed_by_rpb"][rpb][r], 6)
    lines = offset_histogram.histogram(model, [lq.numpy()])
    assert [ln["warp"] for ln in lines][-1] == "ALL" and len(lines) == 3
    json.dumps(lines)


def test_active_codebook_usage_counts_is_a_direct_count():
    from glare_tpu_torch.nn.layers import seed_init_
    from glare_tpu_torch.sr.archs import build_network

    net = build_network({"type": "VQWeightDehazeNet", "gt_resolution": 32, "codebook_params": [[8, 64, 64]],
                         "LQ_stage": False, "use_weight": False, "norm_type": "gn", "act_type": "silu"})
    seed_init_(net, torch.Generator().manual_seed(0))
    net.eval()
    rng = np.random.default_rng(4)
    images = [rng.random((32, 32, 3)).astype(np.float32) for _ in range(3)]
    image, active = active_codebook.usage_counts(net, images, 64)
    counts = collections.Counter()
    with torch.no_grad():
        for img in images:
            idx = net.encode_and_decode(torch.as_tensor(img).permute(2, 0, 1)[None])[5][0]
            counts.update(idx.reshape(-1).tolist())
    want = np.zeros((8, 8))
    for k, v in counts.items():
        want[int(k) // 8, int(k) % 8] = v
    np.testing.assert_array_equal(image, want)
    assert active == len(counts) and image.sum() == 3 * 8 * 8


def test_timed_and_step_timer_behave_as_jax(monkeypatch):
    calls = {"port": 0, "jax": 0}

    def make(key):
        def fn(x):
            calls[key] += 1
            return np.asarray([x, calls[key]], np.float32)
        return fn

    s_p, out_p = profiling.timed(make("port"), 2.0, iters=4, warmup=3)
    s_j, out_j = jprofiling.timed(make("jax"), 2.0, iters=4, warmup=3)
    assert calls == {"port": 7, "jax": 7}
    np.testing.assert_array_equal(out_p, out_j)
    assert s_p >= 0 and s_j >= 0
    # the same clock readings give the same rolling rate
    ticks = iter([0.0, 0.5, 1.0, 1.25, 2.0, 4.0, 5.0, 5.1] * 2)
    monkeypatch.setattr("time.perf_counter", lambda: next(ticks))
    a, b = profiling.StepTimer(window=3), jprofiling.StepTimer(window=3)
    for t in (a, b):
        for _ in range(4):
            t.tick()
            t.tock()
    assert a.times == b.times and a.steps_per_sec == b.steps_per_sec
    assert profiling.StepTimer().steps_per_sec == 0.0
    assert profiling.host_sync({"x": [torch.ones(2)]})["x"][0].sum() == 2


def test_trace_writes_chrome_trace_and_aggregate_reads_it(tmp_path):
    with profiling.trace(str(tmp_path / "tr"), cuda=False) as prof:
        torch.randn(64, 64) @ torch.randn(64, 64)
    assert (tmp_path / "tr" / "trace.json").exists()
    agg = profiling.aggregate(prof)
    assert agg["device_busy_ms"] == 0 and agg["kernel_launches"] == 0
    assert profiling.category("void attn_hopper_kernel<64>") == "attention (this repo)"
    assert profiling.category("sm90_xmma_gemm_bf16") == "conv / gemm (library)"
    assert profiling.memory_stats() == {} or torch.cuda.is_available()
    # the profile tools' per-image report of the same trace
    from glare_tpu_torch.tools import profile_stage3

    rep = profile_stage3.report(prof, 0.5, 4, "cpu")
    assert rep["wall_ms_per_img"] == 125.0 and rep["device_ms_per_img"] == 0.0
    assert rep["device_idle_share"] == 1.0 and rep["kernel_launches_per_img"] == 0
