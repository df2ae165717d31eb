"""The port stands alone: nothing under ``glare_tpu_torch/`` nor ``chip_smoke.py``
imports jax, flax, optax or anything of ``glare_tpu``; heavy optional packages
(yaml, cv2, pandas, triton) are imported only inside the functions that use
them; and ``import glare_tpu_torch`` works without any of them and without a GPU.
Every public top-level name of a ``glare_tpu`` module has a counterpart of the same
name in the matching ``glare_tpu_torch`` module, but the names ``NOT_PORTED``
lists (by AST only: milliseconds).
"""

import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
PKG = os.path.join(ROOT, "glare_tpu_torch")
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "glare_tpu"}
LAZY_ONLY = {"yaml", "cv2", "pandas", "triton", "lmdb", "tensorboard", "wandb"}


def _sources():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(PKG):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _imports(tree, top_level_only):
    nodes = tree.body if top_level_only else ast.walk(tree)
    out = set()
    for node in nodes:
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
    return out


def test_sources_found():
    files = _sources()
    assert len(files) > 30
    rel = {os.path.relpath(f, ROOT) for f in files}
    assert {"chip_smoke.py", "glare_tpu_torch/ops/_build.py", "glare_tpu_torch/ops/dcn.py",
            "glare_tpu_torch/modules/llflow_vqgan2.py", "glare_tpu_torch/models/llflow_model.py",
            "glare_tpu_torch/cli/infer_paired.py", "glare_tpu_torch/cli/infer_unpaired.py",
            "glare_tpu_torch/cli/test_stages.py", "glare_tpu_torch/tools/dcn_train_designs.py",
            "glare_tpu_torch/sr/train.py", "glare_tpu_torch/sr/models/vq_model.py",
            "glare_tpu_torch/sr/archs/discriminator_arch.py", "glare_tpu_torch/measure.py",
            "glare_tpu_torch/ops/warp.py", "glare_tpu_torch/utils/lpips.py",
            "glare_tpu_torch/utils/niqe.py", "glare_tpu_torch/utils/matlab_functions.py",
            "glare_tpu_torch/sr/metrics_fid.py", "glare_tpu_torch/sr/archs/arch_util.py",
            "glare_tpu_torch/sr/archs/swinir_arch.py", "glare_tpu_torch/sr/data/haze_online_dataset.py",
            "glare_tpu_torch/sr/utils/diffjpeg.py", "glare_tpu_torch/sr/utils/img_process_util.py",
            "glare_tpu_torch/sr/utils/lmdb_util.py", "glare_tpu_torch/sr/utils/flow_util.py",
            "glare_tpu_torch/sr/utils/face_util.py", "glare_tpu_torch/modules/legacy_archs.py",
            "glare_tpu_torch/parallel/__init__.py", "glare_tpu_torch/parallel/mesh.py",
            "glare_tpu_torch/data/native.py", "glare_tpu_torch/utils/profiling.py",
            "glare_tpu_torch/tools/flops_audit.py", "glare_tpu_torch/tools/offset_histogram.py",
            "glare_tpu_torch/tools/active_codebook.py", "glare_tpu_torch/tools/profile_stage3.py",
            "glare_tpu_torch/tools/profile_stage1.py", "glare_tpu_torch/tools/train_offset_drive.py"} <= rel
    # every kernel source and header the build compiles (python3 chip_smoke.py builds them all)
    from glare_tpu_torch.ops import _build

    assert set(_build.sources()) == {"vq_argmin", "attn_hopper", "attn_hopper_f32", "attn_fused",
                                     "dcn_hopper", "dcn_fwd", "dcn_bwd"}
    assert [os.path.basename(h) for h in _build.headers()] == ["dcn_tap.cuh"]
    for name in ("dcn_fwd", "dcn_bwd"):
        assert '#include "dcn_tap.cuh"' in open(_build.sources()[name]).read(), name


def test_the_cascade_entry_is_exported_beside_the_plain_one():
    from glare_tpu_torch.ops import dcn

    for name in ("modulated_deform_conv_cascade", "modulated_deform_conv_cascade_ref",
                 "modulated_deform_conv_cascade_cuda", "cascade_selection", "cascade_row_radius",
                 "cascade_select_cuda", "route"):
        assert callable(getattr(dcn, name)), name
    assert isinstance(dcn.launches, int) and isinstance(dcn.cascade_launches, int)
    assert isinstance(dcn.select_launches, int)
    assert set(dcn.launches_by_entry) == set(dcn.cascade_launches_by_entry) == \
        {"hopper", "wmma", "f32", "f32_flat"}
    src = open(os.path.join(PKG, "csrc", "dcn_fwd.cu")).read()
    assert 'extern "C" int dcn_cascade_fwd(' in src and 'extern "C" int dcn_fwd(' in src
    src = open(os.path.join(PKG, "csrc", "dcn_bwd.cu")).read()
    for entry in ("dcn_bwd_pass", "dcn_bwd_pass_bf16"):
        assert f'extern "C" int {entry}(' in src, entry
    src = open(os.path.join(PKG, "csrc", "dcn_hopper.cu")).read()
    for entry in ("dcn_hopper_fwd", "dcn_hopper_cascade_fwd", "dcn_cascade_select"):
        assert f'extern "C" int {entry}(' in src, entry


@pytest.mark.parametrize("path", _sources(), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_and_nothing_of_the_jax_package(path):
    tree = ast.parse(open(path).read(), path)
    assert not (_imports(tree, top_level_only=False) & FORBIDDEN), path
    assert not (_imports(tree, top_level_only=True) & LAZY_ONLY), \
        f"{path}: yaml/cv2/pandas/triton/lmdb/tensorboard/wandb must be imported inside the function that uses them"


def test_no_library_kernels_on_any_path_of_the_port():
    banned = ("torch.compile", "scaled_dot_product_attention", "deform_conv2d", "torch.cdist",
              "torchvision")
    for path in _sources():
        if path.endswith("chip_smoke.py"):
            continue  # times library calls as yardsticks only
        src = open(path).read()
        for b in banned:
            assert b not in src, f"{b} in {path}"


def test_import_every_module_without_optional_packages_or_gpu():
    code = r"""
import importlib, os, pkgutil, sys
for name in ("yaml", "cv2", "pandas", "triton", "lmdb", "tensorboard", "wandb", "jax", "flax", "optax"):
    sys.modules[name] = None          # any import of these now raises ImportError
os.environ["CUDA_VISIBLE_DEVICES"] = ""
import glare_tpu_torch, torch
assert torch.backends.cuda.matmul.allow_tf32 is False
assert torch.backends.cudnn.allow_tf32 is False
n, sr = 0, set()
for m in pkgutil.walk_packages(glare_tpu_torch.__path__, "glare_tpu_torch."):
    importlib.import_module(m.name)
    n += 1
    if m.name.startswith("glare_tpu_torch.sr."):
        sr.add(m.name)
assert "glare_tpu" not in sys.modules
# the stage-1 framework's every module, registries filled by their auto-import
assert {"glare_tpu_torch.sr.train", "glare_tpu_torch.sr.test", "glare_tpu_torch.sr.models.vq_model",
        "glare_tpu_torch.sr.archs.discriminator_arch", "glare_tpu_torch.sr.archs.swin",
        "glare_tpu_torch.sr.data.paired_image_dataset", "glare_tpu_torch.sr.utils.file_client",
        "glare_tpu_torch.sr.metrics", "glare_tpu_torch.sr.archs.arch_util", "glare_tpu_torch.sr.archs.swinir_arch",
        "glare_tpu_torch.sr.data.haze_online_dataset", "glare_tpu_torch.sr.utils.diffjpeg",
        "glare_tpu_torch.sr.utils.img_process_util", "glare_tpu_torch.sr.utils.lmdb_util",
        "glare_tpu_torch.sr.utils.flow_util", "glare_tpu_torch.sr.utils.face_util"} <= sr, sorted(sr)
assert "glare_tpu_torch.modules.legacy_archs" in sys.modules
# the evaluation metrics and the flow warp, without cv2 (their numpy / scipy / torch parts)
for name in ("glare_tpu_torch.measure", "glare_tpu_torch.ops.warp", "glare_tpu_torch.utils.lpips",
             "glare_tpu_torch.utils.niqe", "glare_tpu_torch.utils.matlab_functions",
             "glare_tpu_torch.sr.metrics_fid"):
    assert name in sys.modules, name
from glare_tpu_torch.sr.registry import ARCH_REGISTRY, DATASET_REGISTRY, METRIC_REGISTRY, MODEL_REGISTRY
assert {"calculate_psnr", "calculate_ssim", "calculate_niqe", "calculate_fid"} <= set(METRIC_REGISTRY.keys())
assert {"VQWeightDehazeNet", "UNetDiscriminatorSN", "SwinIR"} <= set(ARCH_REGISTRY.keys())
assert "VQDehazeModel" in MODEL_REGISTRY
assert {"SingleImageDataset", "HazeOnlineDataset"} <= set(DATASET_REGISTRY.keys())
# the last slice: data parallelism, the native core, profiling and the model-driving tools
for name in ("glare_tpu_torch.parallel", "glare_tpu_torch.parallel.mesh", "glare_tpu_torch.data.native",
             "glare_tpu_torch.utils.profiling"):
    assert name in sys.modules, name
for name in ("flops_audit", "offset_histogram", "active_codebook", "profile_stage3", "profile_stage1",
             "train_offset_drive"):
    importlib.import_module("glare_tpu_torch.tools." + name)
    n += 1
# the last gaps against the JAX package: the prefetching loader, the wandb hook, the helpers
from glare_tpu_torch.data import PrefetchDataLoader
from glare_tpu_torch.sr.utils.logger import init_wandb_logger
from glare_tpu_torch.options import check_resume, save_opt
from glare_tpu_torch.utils import ScopeTimer, copy_tree_once
from glare_tpu_torch.utils.imgproc import from_nhwc_batch, to_float01, to_nhwc_batch
from glare_tpu_torch.nn import ResBlockGN
from glare_tpu_torch.ops.dcn import modulated_deform_conv_naive
from glare_tpu_torch.convert import flax_to_torch_resblock_gn
assert "glare_tpu" not in sys.modules and "jax" not in [k for k, v in sys.modules.items() if v is not None]
print("imported", n)
"""
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    assert int(res.stdout.split()[-1]) > 25


def test_chip_smoke_fails_loudly_without_a_gpu():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


JAX_PKG = os.path.join(ROOT, "glare_tpu")
# a module of glare_tpu whose counterpart has another file name in the port
PORT_FILE = {"ops/attn_pallas.py": "ops/attn.py", "ops/dcn_pallas.py": "ops/dcn.py"}
# public names of glare_tpu with no counterpart of the same name, each for the
# reason ROADMAP.md gives under "Not ported, and why" (keep the two lists alike)
NOT_PORTED = {
    # the Pallas kernels: ported as CUDA kernels under the port's own names
    "ops/vq.py": {"nearest_code_pallas"},
    "ops/dcn_pallas.py": {"modulated_deform_conv_pallas", "modulated_deform_conv_pallas_cascade"},
    # flax initializers that copy torch's defaults, which the port's modules have
    "nn/layers.py": {"torch_conv_kernel_init", "torch_conv_bias_init"},
    # a functional merge of a flax tree; ActNorm2d.initialize writes in place
    "modules/flow_layers.py": {"merge_actnorm_init"},
    # the port has ScaledKaimingConv
    "sr/archs/arch_util.py": {"scaled_kaiming_init"},
    # yaml classes built at import; the port imports yaml inside parse() / save_opt()
    "options/options.py": {"Loader", "Dumper"},
    # the port has utils/lpips.py
    "utils/lpips_jax.py": {"load_lpips", "probe_lpips_cache"},
    # nothing may be downloaded
    "sr/utils/download_util.py": {"download_file_from_google_drive", "get_confirm_token",
                                  "load_file_from_url", "save_response_content"},
}


def _top_level_names(path, with_imports):
    """def / class / assignment targets at module level (and imported names)."""
    out = set()
    for node in ast.parse(open(path).read(), path).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            for tgt in node.targets if isinstance(node, ast.Assign) else [node.target]:
                elts = tgt.elts if isinstance(tgt, ast.Tuple) else [tgt]
                out |= {e.id for e in elts if isinstance(e, ast.Name)}
        elif with_imports and isinstance(node, (ast.Import, ast.ImportFrom)):
            out |= {(a.asname or a.name).split(".")[0] for a in node.names}
    return out


def _jax_modules():
    for d, _, names in os.walk(JAX_PKG):
        for n in sorted(names):
            if n.endswith(".py"):
                yield os.path.relpath(os.path.join(d, n), JAX_PKG)


def test_every_public_name_of_the_jax_package_has_a_counterpart():
    gaps, stale = {}, {}
    for rel in _jax_modules():
        public = {n for n in _top_level_names(os.path.join(JAX_PKG, rel), False)
                  if not n.startswith("_")} - {"Dtype"}   # Dtype: a typing alias
        allowed = NOT_PORTED.get(rel, set())
        port = os.path.join(PKG, PORT_FILE.get(rel, rel))
        have = _top_level_names(port, True) if os.path.exists(port) else set()
        if public - allowed - have:
            gaps[rel] = sorted(public - allowed - have)
        if allowed - (public - have):
            stale[rel] = sorted(allowed - (public - have))
    assert not gaps, f"public names of glare_tpu with no counterpart in the port: {gaps}"
    assert not stale, f"NOT_PORTED names that are ported, or gone from glare_tpu: {stale}"
    assert len(list(_jax_modules())) > 80
