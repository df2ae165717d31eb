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


# ---------------------------------------------------------------------------
# Parameters and methods (by AST only). For each public function of a glare_tpu
# module, and each public method of a public class (``__init__`` and ``__call__``
# included; a flax ``__call__`` is the port's ``forward``), every parameter name is
# accepted by the port's counterpart (a ``**kwargs`` there does not count); every
# field of a flax / dataclass is accepted by the port class's ``__init__``; every
# public method exists in the port class: defined there, inherited from a port
# base, or assigned as ``self.<name>`` in ``__init__`` (flax properties).
# Differences that are only idiom are listed below, each as {JAX name: the port's
# name for it, or None}, with the reason; ROADMAP.md's "Not ported, and why"
# mirrors the categories. A listed name that is no longer a gap fails the test.
# ---------------------------------------------------------------------------

IDIOM = {}


def _idiom(rel, quals, names):
    for q in quals.split():
        IDIOM.setdefault((rel, q), {}).update(names)


# JAX threads explicit PRNG keys; the port draws from a caller's torch.Generator
_idiom("modules/flow_layers.py", "GaussianDiag.sample GaussianDiag.sample_eps", {"key": "generator"})
_idiom("modules/flow_upsampler.py", "FlowUpsamplerNet.__call__ FlowUpsamplerNet.decode",
       {"rng": "generator"})
_idiom("modules/split.py", "Split2d.__call__", {"rng": "generator"})
_idiom("modules/llflow_vqgan2.py", "LLFlowVQGAN2.normal_flow", {"noise_rng": "generator"})
_idiom("modules/quantize.py", "remap_to_used", {"rng": "generator"})
_idiom("sr/losses.py", "gradient_penalty_loss", {"rng": "generator"})

# flax parameter trees passed by value: the port's modules and models hold their
# own tensors (a torch module, a state_dict, the model's flat EMA)
_idiom("modules/quantize.py", "VectorQuantizer2.get_codebook_entry GumbelQuantize.get_codebook_entry",
       {"params": None})
_idiom("models/base_model.py", "BaseModel.save_network BaseModel.get_network_description",
       {"params": "network"})
_idiom("models/base_model.py", "BaseModel.save_training_state", {"state_pytree": "state"})
# flax deserialises into a template tree; torch.load needs none
_idiom("models/base_model.py", "BaseModel.load_training_state", {"template_state": None})
_idiom("sr/models/base_model.py", "BaseSRModel.resume_training_state", {"template_state": None})
_idiom("sr/models/base_model.py", "BaseSRModel.save_network", {"param_dicts": "state_dicts"})
_idiom("sr/models/base_model.py", "BaseSRModel.model_ema", {"params": None, "ema_params": None})
# the torch training API: DDP / FSDP2 wrap the network, the caller's loop runs the
# step and the optimizer (no step_fn, no parameter or optimizer tree, no axis names)
_idiom("parallel/mesh.py", "make_dp_train_step", {"step_fn": None})
_idiom("parallel/mesh.py", "make_fsdp_train_step",
       {"step_fn": None, "params": None, "opt_state": None, "n_batch_args": None,
        "data_axis": None, "param_axes": None})

# flax layer fields: flax infers the input width, names the output width
# `features`, strides `strides`, the bias `use_bias`, normalisation's epsilon
# `epsilon`; the port's layers take torch's (in, out, stride, bias, eps). `dtype` is
# the flax compute dtype: the port's modules compute in their weights' dtype, set
# by `.to()` / `set_compute_dtype` / `inference_dtype`. Dropout and BatchNorm
# follow `.train()` / `.eval()` (no `deterministic` / `use_running_average`).
_DTYPE = {
    "modules/condition_encoder.py": "ConEncoder1",
    "modules/deformable_decoder.py": "DCNv2Pack WarpBlock MultiScaleDecoder2",
    "modules/encoder_decoder.py": "Encoder Decoder",
    "modules/legacy_archs.py": "ResidualDenseBlock5C RRDB RRDBNet Conv2D ConvTranspose2D ConvBNRelu "
                               "DoubleConv ChannelAttention SpatialAttention CBAM ResConv MSIA ColorEncoder",
    "modules/llflow_vqgan2.py": "LLFlowVQGAN2",
    "modules/vqllflow_deformable.py": "VQLLFLOWDeformable",
    "modules/vqmodel.py": "VQModel",
    "nn/layers.py": "Conv Upsample Downsample ResnetBlock AttnBlock ResBlockGN",
    "sr/archs/arch_util.py": "ResidualBlockNoBN Upsample",
    "sr/archs/ridcp_utils.py": "ResBlock CombineQuantBlock",
    "sr/archs/swin.py": "WindowAttention Mlp SwinTransformerBlock BasicLayer RSTB SwinLayers",
    "sr/archs/swinir_arch.py": "SwinIR",
    "sr/archs/vgg_arch.py": "VGGFeatureExtractor",
    "sr/archs/vq_weight_arch.py": "MultiScaleEncoder DecoderBlock WarpBlock MultiScaleDecoder "
                                  "VQWeightDehazeNet",
    "models/networks.py": "define_Flow find_vqgan",
}
for _rel, _quals in _DTYPE.items():
    _idiom(_rel, _quals, {"dtype": None})
_idiom("nn/layers.py", "Conv", {"features": "out_channels", "strides": "stride", "use_bias": "bias",
                                "kernel_init": None, "feature_group_count": None})
_idiom("nn/layers.py", "GroupNorm32", {"epsilon": "eps"})
_idiom("nn/layers.py", "ResnetBlock", {"deterministic": None})
_idiom("modules/flow_layers.py", "Conv2dNormed Conv2dZeros", {"features": "out_channels"})
_idiom("modules/legacy_archs.py", "Conv2D", {"features": "out_channels", "strides": "stride"})
_idiom("modules/legacy_archs.py", "ConvTranspose2D DoubleConv", {"features": "out_channels"})
_idiom("modules/legacy_archs.py", "ConvBNRelu ResConv",
       {"features": "out_channels", "use_running_average": None})
_idiom("modules/quantize.py", "GumbelQuantize.__call__", {"deterministic": None})
_idiom("sr/archs/discriminator_arch.py", "SNConv",
       {"features": "out_channels", "strides": "stride", "use_bias": "bias"})
_idiom("sr/archs/vq_weight_arch.py", "DecoderBlock", {"out_channels": "out_channel"})

# TPU-only knobs: Pallas block sizes and interpret mode, the lax.map chunking of
# the JAX DCN, the XLA / Pallas backend switches, the stock Pallas flash kernel
# (the port's GLARE_ATTN_FLASH routes to its fused kernel, `use_fused`) and the
# unrolled fori_loop; the CUDA kernels have no such knob
_idiom("ops/attn_pallas.py", "flash_attention_nhc", {"bq": None, "bk": None, "interpret": None})
_idiom("ops/dcn.py", "modulated_deform_conv_hybrid", {"pixels_per_chunk": None})
_idiom("ops/vq.py", "nearest_code", {"backend": None})
_idiom("modules/quantize.py", "VectorQuantizer2", {"backend": None})
_idiom("modules/vqmodel.py", "VQModel", {"vq_backend": None})
_idiom("models/networks.py", "find_vqgan", {"vq_backend": None})
_idiom("modules/deformable_decoder.py", "DCNv2Pack", {"pixels_per_chunk": None})
_idiom("modules/deformable_decoder.py", "WarpBlock", {"dcn_pixels_per_chunk": None})
_idiom("nn/layers.py", "AttnBlock", {"use_flash": "use_fused", "unroll_chunks": None})

# the port's DCN op is the 3x3 "same" convolution every DCN of the model uses
_idiom("ops/dcn.py", "modulated_deform_conv",
       {"stride": None, "padding": None, "dilation": None, "pixels_per_chunk": None})
# the JAX module's __call__ takes x_latent and mid_feat and reads neither
_idiom("modules/vqllflow_deformable.py", "VQLLFLOWDeformable.__call__", {"x_latent": None, "mid_feat": None})
# the reference's nn.Sequential: torch's forward
_idiom("sr/archs/arch_util.py", "Upsample", {"__call__": None})


def _parsed(path, _cache={}):
    if path not in _cache:
        _cache[path] = ast.parse(open(path).read(), path) if os.path.exists(path) else None
    return _cache[path]


def _imported_module(root, path, node):
    """The file an ImportFrom inside the package ``root`` names (None: outside it)."""
    if node.level:
        base = os.path.dirname(path)
        for _ in range(node.level - 1):
            base = os.path.dirname(base)
        parts = node.module.split(".") if node.module else []
    elif node.module and node.module.split(".")[0] == os.path.basename(root):
        base, parts = root, node.module.split(".")[1:]
    else:
        return None
    p = os.path.join(base, *parts)
    return os.path.join(p, "__init__.py") if os.path.isdir(p) else p + ".py"


def _find(root, path, name, depth=0):
    """(file, def or class node) that ``name`` is bound to in module ``path``,
    through the package's imports and plain aliases; None when it is bound to
    something outside the package or to no def."""
    tree = _parsed(path)
    if tree is None or depth > 6:
        return None
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)) and node.name == name:
            return path, node
    for node in tree.body:
        if isinstance(node, ast.ImportFrom):
            for a in node.names:
                if (a.asname or a.name) == name:
                    mod = _imported_module(root, path, node)
                    return _find(root, mod, a.name, depth + 1) if mod else None
        elif isinstance(node, ast.Assign) and isinstance(node.value, ast.Name):
            if any(isinstance(t, ast.Name) and t.id == name for t in node.targets):
                return _find(root, path, node.value.id, depth + 1)
    return None


def _params(fn):
    """-> (parameter names without self / cls, has *args, has **kwargs)."""
    a = fn.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    if names and names[0] in ("self", "cls"):
        names = names[1:]
    return names, a.vararg is not None, a.kwarg is not None


def _class(root, path, cls):
    """-> (methods by name, dataclass fields, names set as self.<name> in
    ``__init__``), through the bases the package defines."""
    methods, fields, attrs = {}, [], set()
    for b in cls.bases:
        found = _find(root, path, b.id) if isinstance(b, ast.Name) else None
        if found and isinstance(found[1], ast.ClassDef):
            m, f, s = _class(root, *found)
            methods.update(m)
            fields += [x for x in f if x not in fields]
            attrs |= s
    for node in cls.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            methods[node.name] = node
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            if node.target.id not in fields:
                fields.append(node.target.id)
            attrs.add(node.target.id)
        elif isinstance(node, ast.Assign):
            attrs |= {t.id for t in node.targets if isinstance(t, ast.Name)}
    init = methods.get("__init__")
    for n in ast.walk(init) if init is not None else ():
        if isinstance(n, ast.Attribute) and isinstance(n.ctx, ast.Store) and \
                isinstance(n.value, ast.Name) and n.value.id == "self":
            attrs.add(n.attr)
    return methods, fields, attrs


def _is_flax(path, cls):
    for b in cls.bases:
        if ast.unparse(b) in ("nn.Module", "linen.Module"):
            return True
        found = _find(JAX_PKG, path, b.id) if isinstance(b, ast.Name) else None
        if found and isinstance(found[1], ast.ClassDef) and _is_flax(*found):
            return True
    return False


def _missing(want, fn):
    """Parameters of the JAX function ``want`` that the port's ``fn`` does not take."""
    names, var, kw = _params(want)
    have, pvar, pkw = _params(fn)
    out = [n for n in names if n not in have]
    if var and not pvar:
        out.append("*" + want.args.vararg.arg)
    if kw and not pkw:
        out.append("**" + want.args.kwarg.arg)
    return out, set(have)


def _api_gaps():
    """-> {(module, qualified name): {JAX name: set of the port's accepted names}}."""
    gaps = {}

    def gap(rel, qual, names, have):
        for n in names:
            gaps.setdefault((rel, qual), {})[n] = have

    for rel in _jax_modules():
        jpath = os.path.join(JAX_PKG, rel)
        ppath = os.path.join(PKG, PORT_FILE.get(rel, rel))
        skip = NOT_PORTED.get(rel, set())
        for node in _parsed(jpath).body:
            name = getattr(node, "name", "_")
            if name.startswith("_") or name in skip or not isinstance(
                    node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                continue
            found = _find(PKG, ppath, name)
            if found is None:
                gap(rel, name, ["<not a def or class of the port>"], set())
                continue
            if not isinstance(node, ast.ClassDef):
                fn = found[1]
                if isinstance(fn, ast.ClassDef):
                    fn = _class(PKG, *found)[0].get("__init__")
                if fn is None:
                    gap(rel, name, ["<no __init__>"], set())
                else:
                    gap(rel, name, *_missing(node, fn))
                continue
            if not isinstance(found[1], ast.ClassDef):
                gap(rel, name, ["<not a class in the port>"], set())
                continue
            methods, fields, attrs = _class(PKG, *found)
            init = methods.get("__init__")
            accepts = set(_params(init)[0]) if init is not None else set(fields)
            flax = _is_flax(jpath, node)
            if flax or any("dataclass" in ast.unparse(d) for d in node.decorator_list):
                jfields = [f for f in _class(JAX_PKG, jpath, node)[1] if f not in ("parent", "name")]
                gap(rel, name, [f for f in jfields if f not in accepts], accepts)
            for m in node.body:
                if not isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    continue
                if m.name == "__call__":
                    port_m = methods.get("forward") or methods.get("__call__")
                elif m.name == "__init__":
                    port_m = init
                elif m.name.startswith("_") or (flax and m.name == "setup"):
                    continue
                else:
                    port_m = methods.get(m.name)
                    if port_m is None and m.name in attrs:
                        continue
                if port_m is None:
                    gap(rel, name, [m.name], set(methods) | attrs)
                else:
                    gap(rel, f"{name}.{m.name}", *_missing(m, port_m))
    return gaps


def test_every_jax_parameter_field_and_method_has_a_counterpart_in_the_port():
    gaps, stale = {}, {}
    found = _api_gaps()
    for key, names in found.items():
        allowed = IDIOM.get(key, {})
        for n, have in names.items():
            if n not in allowed:
                gaps.setdefault(key, []).append(n)
            elif allowed[n] is not None and allowed[n] not in have:
                gaps.setdefault(key, []).append(f"{n} (the port's {allowed[n]!r} is missing too)")
    for key, allowed in IDIOM.items():
        for n in allowed:
            if n not in found.get(key, {}):
                stale.setdefault(key, []).append(n)
    assert not gaps, f"JAX parameters / fields / methods the port does not take or have: {gaps}"
    assert not stale, f"IDIOM entries that are no longer a difference (or gone from glare_tpu): {stale}"
    assert sum(len(v) for v in found.values()) > 50   # the walk saw the package


def _cli_flags(path):
    return {a.value for n in ast.walk(_parsed(path)) if isinstance(n, ast.Call)
            and getattr(n.func, "attr", "") == "add_argument"
            for a in n.args if isinstance(a, ast.Constant) and isinstance(a.value, str)}


def test_every_jax_cli_flag_is_a_port_flag():
    """Each ``add_argument`` flag of a glare_tpu module is one of its port counterpart's."""
    gaps, n = {}, 0
    for rel in _jax_modules():
        want = _cli_flags(os.path.join(JAX_PKG, rel))
        n += len(want)
        port = os.path.join(PKG, PORT_FILE.get(rel, rel))
        have = _cli_flags(port) if want and os.path.exists(port) else set()
        if want - have:
            gaps[rel] = sorted(want - have)
    assert not gaps, f"JAX command-line flags the port does not take: {gaps}"
    assert n > 15   # the walk saw the CLIs
