"""The port stands alone: nothing under ``glare_tpu_torch/`` nor ``chip_smoke.py``
imports jax, flax, optax or anything of ``glare_tpu``; heavy optional packages
(yaml, cv2, pandas, triton) are imported only inside the functions that use
them; and ``import glare_tpu_torch`` works without any of them and without a GPU.
"""

import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
PKG = os.path.join(ROOT, "glare_tpu_torch")
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "glare_tpu"}
LAZY_ONLY = {"yaml", "cv2", "pandas", "triton"}


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
    assert any(f.endswith("ops/_build.py") for f in files)


@pytest.mark.parametrize("path", _sources(), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_and_nothing_of_the_jax_package(path):
    tree = ast.parse(open(path).read(), path)
    assert not (_imports(tree, top_level_only=False) & FORBIDDEN), path
    assert not (_imports(tree, top_level_only=True) & LAZY_ONLY), \
        f"{path}: yaml/cv2/pandas/triton must be imported inside the function that uses them"


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
for name in ("yaml", "cv2", "pandas", "triton", "jax", "flax", "optax"):
    sys.modules[name] = None          # any import of these now raises ImportError
os.environ["CUDA_VISIBLE_DEVICES"] = ""
import glare_tpu_torch, torch
assert torch.backends.cuda.matmul.allow_tf32 is False
assert torch.backends.cudnn.allow_tf32 is False
n = 0
for m in pkgutil.walk_packages(glare_tpu_torch.__path__, "glare_tpu_torch."):
    importlib.import_module(m.name)
    n += 1
assert "glare_tpu" not in sys.modules
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
