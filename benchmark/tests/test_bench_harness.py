"""The harness's own parts: finding files by name, the traffic's seeds, the trace
arithmetic, the readers, and what the harness may import."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from benchmark.harness import bench, readers, trace
from benchmark.harness.registry import BENCH_DIR, ROOT, Registry

photos = Registry().generator("photos")


def test_a_new_cell_config_mix_and_metric_are_found_as_new_files(tmp_path):
    bench = tmp_path / "benchmark"
    shutil.copytree(BENCH_DIR, bench, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    (bench / "configs" / "cfg_new.json").write_text(json.dumps({"model": "X", "reduced": []}))
    (bench / "traffic" / "mix_new.json").write_text(json.dumps({"batch": 2, "sizes": []}))
    (bench / "workloads" / "cell_new.json").write_text(json.dumps(
        {"config": "cfg_new", "traffic": "mix_new", "entry": "paired_eval"}))
    (bench / "metrics" / "new_metric.cell.py").write_text("def read(run):\n    return 42.0\n")
    spec["workloads"].append({"name": "cell_new", "config": "cfg_new", "traffic": "mix_new", "chips": 1,
                              "why": "test"})
    spec["per_layer"].append({"name": "new_metric.cell", "unit": "%", "better": "higher",
                              "source": "device_trace", "layer": "device", "moves": "img_per_s",
                              "workloads": ["cell_new"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    reg = Registry(str(bench))
    assert reg.workload("cell_new")["config"] == "cfg_new"
    assert reg.config("cfg_new")["model"] == "X"
    assert reg.traffic("mix_new")["batch"] == 2
    assert [m["name"] for m in reg.metrics_of("cell_new", traced=True)] == ["new_metric.cell"]
    assert reg.metric("new_metric.cell").read(None) == 42.0
    # a metric with no workloads key is every cell's
    assert "setup_s" in [m["name"] for m in reg.metrics_of("cell_new", traced=False)]
    with pytest.raises(KeyError):
        reg.workload("cell_missing")


_TOY_GENERATOR = """
import numpy as np

def pool(mix, seed, device="cpu"):
    rng = np.random.default_rng(int(seed))
    return [rng.standard_normal(mix["length"]) for _ in range(mix["count"])]

def calls(mix, seed, pool):
    rng = np.random.default_rng([int(seed), 1])
    while True:
        yield [int(rng.integers(len(pool)))]
"""

_TOY_ENTRY = """
import numpy as np

def prepare(cfg, pool, seed, device, log):
    return {"scale": np.float64(cfg["scale"])}

class Program:
    def __init__(self, cfg, state, device, pool):
        self.scale = float(state["scale"])

    def __call__(self, items):
        return [np.cumsum(x) * self.scale for x in items]

def model_shape(item):
    return (1, len(item))

def reference(cfg, state, device, precision=None):
    return lambda items: [np.array([sum(x[:i + 1]) for i in range(len(x))]) * cfg["scale"] for x in items]

def count(config, cfg, h, w, stored=True):
    return {"flop": w}

def compare(answers, refs):
    return {"max_err": max(float(np.abs(a - r).max()) for a, r in zip(answers, refs))}
"""


def test_a_cell_with_its_own_generator_entry_and_reference_is_new_files_alone(tmp_path):
    bench_dir = tmp_path / "benchmark"
    shutil.copytree(BENCH_DIR, bench_dir, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    (bench_dir / "traffic" / "vectors.py").write_text(_TOY_GENERATOR)
    (bench_dir / "traffic" / "vectors_64.json").write_text(json.dumps(
        {"generator": "vectors", "loop": "closed", "length": 64, "count": 5}))
    (bench_dir / "entries" / "prefix_sum.py").write_text(_TOY_ENTRY)
    (bench_dir / "configs" / "toy.json").write_text(json.dumps({"scale": 3.0, "reduced": []}))
    (bench_dir / "workloads" / "toy_cell.json").write_text(json.dumps(
        {"config": "toy", "traffic": "vectors_64", "entry": "prefix_sum", "trace_calls": 2,
         "sample_calls": 3, "limits": {"max_err": 1e-9}}))
    (bench_dir / "metrics" / "calls_done.py").write_text("def read(run):\n    return float(len(run.calls))\n")
    spec["workloads"].append({"name": "toy_cell", "config": "toy", "traffic": "vectors_64", "chips": 1,
                              "why": "test"})
    spec["end_to_end"].append({"name": "calls_done", "unit": "calls", "better": "higher",
                               "source": "host_clock", "workloads": ["toy_cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    reg = Registry(str(bench_dir))
    quiet = lambda *a, **k: None
    r = bench.run("toy_cell", 2 ** 31 + 3, 0.05, False, device="cpu", registry=reg, log=quiet)
    assert r["correct"] is True and r["limits"]["max_err"]["value"] < 1e-9
    assert set(r["metrics"]) == {"setup_s", "calls_done"} and r["metrics"]["calls_done"]["value"] >= 1
    flip = lambda program, side: (lambda items: [-a for a in program(items)])
    r = bench.run("toy_cell", 2 ** 31 + 3, 0.05, False, device="cpu", registry=reg, fault=flip, log=quiet)
    assert r["correct"] is False


def test_a_mix_that_is_not_a_closed_loop_is_refused(tmp_path):
    bench_dir = tmp_path / "benchmark"
    shutil.copytree(BENCH_DIR, bench_dir, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    mix = json.load(open(bench_dir / "traffic" / "stage2_600x400.json"))
    (bench_dir / "traffic" / "stage2_600x400.json").write_text(json.dumps(dict(mix, loop="open")))
    with pytest.raises(ValueError, match="closed loop"):
        bench.run("s2_eval_f32", 1, 0.1, False, device="cpu", registry=Registry(str(bench_dir)))


def test_every_cell_names_files_that_exist():
    reg = Registry()
    spec = reg.spec()
    for w in spec["workloads"]:
        wl = reg.workload(w["name"])
        assert (wl["config"], wl["traffic"]) == (w["config"], w["traffic"])
        reg.config(wl["config"]), reg.entry(wl["entry"])
        reg.generator(reg.traffic(wl["traffic"])["generator"])
        for traced in (False, True):
            for m in reg.metrics_of(w["name"], traced):
                assert callable(reg.metric(m["name"]).read)


@pytest.mark.parametrize("mix", ["paired_600x400_b8", "unpaired_photos", "stage2_600x400"])
def test_traffic_repeats_by_seed_and_keeps_the_sizes(mix):
    spec = Registry().traffic(mix)
    small = dict(spec, sizes=[dict(s, hw=[s["hw"][0] // 8, s["hw"][1] // 8]) for s in spec["sizes"]])
    a = photos.pool(small, 2 ** 31 + 5, "cpu")
    b = photos.pool(small, 2 ** 31 + 5, "cpu")
    c = photos.pool(small, 2 ** 31 + 6, "cpu")
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not all(np.array_equal(x, y) for x, y in zip(a, c))
    assert [x.shape for x in a] == [x.shape for x in c]
    assert all(x.dtype == np.uint8 and x.mean() < 80 for x in a)      # low light
    take = lambda seed: [list(next(it)) for it in [photos.calls(small, seed, a)] for _ in range(12)]
    assert take(7) == take(7)
    batch = spec.get("batch", 1)
    for call in take(8):
        assert len(call) == batch and len({a[i].shape for i in call}) == 1


def test_a_pass_over_the_pool_holds_every_photo_once():
    pool = list(range(10))
    it = photos.order({}, 3, len(pool))
    assert sorted(next(it) for _ in range(10)) == pool


def _ev(name, cat, ts, dur):
    return {"name": name, "cat": cat, "ph": "X", "ts": ts, "dur": dur}


def test_trace_union_idle_and_gaps_on_a_synthetic_trace():
    events = [
        _ev(trace.WINDOW_SPAN, "user_annotation", 0, 1000),
        _ev("host.prep", "user_annotation", 0, 200),
        _ev("cudaStreamSynchronize", "cuda_runtime", 700, 300),
        _ev("attn_hopper_kernel", "kernel", 200, 200),        # 200-400
        _ev("elementwise_kernel", "kernel", 300, 200),        # 300-500 overlaps: counts once
        _ev("void cudnn::conv", "kernel", 600, 100),          # 600-700
        _ev("Memcpy DtoH", "gpu_memcpy", 950, 100),           # clipped to the window: 950-1000
        _ev("late_kernel", "kernel", 1200, 50),               # outside the window
    ]
    s = trace.Summary(events)
    assert s.window_s == pytest.approx(1e-3)
    assert s.busy_s == pytest.approx((300 + 100 + 50) * 1e-6)
    assert s.launches == 3
    assert s.category_s("attention (this repo)") == pytest.approx(200e-6)
    assert s.category_s("conv / gemm (library)") == pytest.approx(100e-6)
    b = s.breakdown()
    assert b["device_ops"][0] == ["attn_hopper_kernel", pytest.approx(200e-6)]
    gaps = dict((n, v) for n, v in b["idle_gaps"])
    assert gaps["host.prep"] == pytest.approx(200e-6)
    assert gaps["cudaStreamSynchronize"] == pytest.approx(250e-6)
    assert sum(gaps.values()) == pytest.approx(s.window_s - s.busy_s)


def test_cudnn_fft_kernels_are_library_convolutions():
    for name in ("regular_fft_pad", "vector_fft<1, 2>", "void region_transform_ABC_val", "gemvx<cfloat>"):
        assert trace.category(name) == "conv / gemm (library)"


class _Run:
    def __init__(self, calls, window_s, setup_s=3.0):
        self.calls, self.window_s, self.setup_s = calls, window_s, setup_s

    images = property(lambda self: sum(len(c["ids"]) for c in self.calls if c["ok"]))

    def latencies_s(self):
        return [c["t1"] - c["t0"] for c in self.calls if c["ok"] for _ in c["ids"]]


def test_the_rate_is_over_the_whole_window_and_the_tail_over_every_request():
    calls = [{"ids": [i], "ok": True, "t0": i * 0.1, "t1": i * 0.1 + (0.5 if i % 17 == 0 else 0.1)}
             for i in range(100)]
    run = _Run(calls, window_s=12.5)
    assert readers.img_per_s(run) == pytest.approx(100 / 12.5)
    lat = sorted(c["t1"] - c["t0"] for c in calls)
    assert readers.latency_p95_ms(run) == pytest.approx(np.percentile(lat, 95) * 1e3)
    assert readers.latency_p95_ms(run) == pytest.approx(500.0, rel=1e-6)  # 6 slow of 100: p95 is slow
    batched = _Run([{"ids": [0, 1, 2, 3], "ok": True, "t0": 0.0, "t1": 1.0}], window_s=2.0)
    assert readers.img_per_s(batched) == 2.0


_IMPORT_CHECK = """
import sys
sys.path.insert(0, {root!r})
import benchmark.harness.bench, benchmark.control
from benchmark.harness.registry import Registry
reg = Registry()
for w in reg.spec()["workloads"]:
    reg.entry(reg.workload(w["name"])["entry"])
import glare_tpu_torch.models, glare_tpu_torch.cli.infer_paired, glare_tpu_torch.cli.infer_unpaired
import run
bad = run.forbidden_modules()
print(bad)
sys.exit(1 if bad else 0)
"""


def test_nothing_the_harness_runs_imports_jax_or_the_jax_package():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    code = _IMPORT_CHECK.format(root=ROOT)
    r = subprocess.run([sys.executable, "-c", code], cwd=BENCH_DIR, env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


def test_the_forbidden_check_compares_whole_top_level_names(monkeypatch):
    sys.path.insert(0, BENCH_DIR)
    import run

    monkeypatch.setitem(sys.modules, "glare_tpu_torch_like", object())
    monkeypatch.delitem(sys.modules, "glare_tpu", raising=False)
    assert "glare_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "glare_tpu.ops", object())
    assert "glare_tpu" in run.forbidden_modules()


def test_the_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, {root!r}); import benchmark.reference.glare; "
            "import benchmark.harness.weights, benchmark.flops.count; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('glare_tpu', 'glare_tpu_torch', 'jax', 'flax')); print(bad); sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code.format(root=ROOT)], capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
