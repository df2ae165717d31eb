"""``glare_tpu_torch.convert`` (flax tree -> torch state_dict) is the inverse of
``tools/torch2flax.py`` (torch state_dict -> flax tree): a round trip reproduces
every leaf bit for bit, and the produced names and shapes are exactly the port
modules' own ``state_dict``.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from glare_tpu.modules.vqllflow_deformable import VQLLFLOWDeformable as JNet
from glare_tpu.modules.vqmodel import VQModel as JVQModel
from glare_tpu_torch import convert
from glare_tpu_torch.modules.vqllflow_deformable import VQLLFLOWDeformable
from glare_tpu_torch.modules.vqmodel import VQModel

from torch_port_util import fill_tree

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import torch2flax  # noqa: E402

# tools/torch2flax.py walks the shipped depth (2 res-blocks per level); widths are free
MINI = dict(enc_ch=32, decoder_ch=32, enc_num_res_blocks=2, dec_num_res_blocks=2)
VQ = dict(ch=32, n_embed=64, num_res_blocks=2)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


@pytest.fixture(scope="module")
def trees():
    x = jnp.zeros((1, 16, 16, 3))
    net = JNet(K=2, L=2, additional_flow_no_affine=1, **MINI)
    vq = JVQModel(vq_backend="ref", **VQ)

    def shapes():
        key = jax.random.PRNGKey(0)
        vq_p = vq.init(key, x)["params"]
        lat_p = net.init(key, x, method=JNet.latent_half)["params"]
        x0, enc0 = net.apply({"params": lat_p}, x, method=JNet.latent_half)
        _, _, code0 = vq.apply({"params": vq_p}, x0, method=JVQModel.decode)
        aft_p = net.init(key, x0, code0, enc0["mid_feat"], method=JNet.aft_half)["params"]
        return vq_p, {**lat_p, **aft_p}

    vq_s, net_s = jax.eval_shape(shapes)
    rng = np.random.default_rng(0)
    return fill_tree(vq_s, rng), fill_tree(net_s, rng)


@pytest.mark.parametrize("kind", ["vqgan", "stage3"])
def test_round_trip_leaf_for_leaf(trees, kind):
    p = trees[0] if kind == "vqgan" else trees[1]
    if kind == "vqgan":
        back = torch2flax.convert_vqgan(convert.flax_to_torch_vqgan(p))
    else:
        back = torch2flax.convert_stage3(convert.flax_to_torch_stage3(p))
    want = dict(_leaves(p))
    got = dict(_leaves(back))
    assert set(got) == set(want)
    for path, leaf in want.items():
        assert got[path].shape == leaf.shape, path
        np.testing.assert_array_equal(got[path], leaf, err_msg="/".join(path))


@pytest.mark.parametrize("kind", ["vqgan", "stage3"])
def test_names_and_shapes_are_the_port_modules(trees, kind):
    if kind == "vqgan":
        sd, mod = convert.flax_to_torch_vqgan(trees[0]), VQModel(**VQ)
    else:
        sd = convert.flax_to_torch_stage3(trees[1])
        mod = VQLLFLOWDeformable(K=2, L=2, additional_flow_no_affine=1, **MINI)
    own = mod.state_dict()
    assert set(sd) == set(own)
    for k, v in own.items():
        assert tuple(sd[k].shape) == tuple(v.shape), k
    mod.load_state_dict(sd, strict=True)


def test_dcn_offset_permutation_is_torch2flax_and_inverts():
    perm = convert.dcn_offset_permutation(4, 9)
    np.testing.assert_array_equal(perm, torch2flax.dcn_offset_permutation(4, 9))
    inv = np.argsort(perm)
    np.testing.assert_array_equal(perm[inv], np.arange(108))
    # torch packing: channel g*18 + 2k is dy of (g, k), + 1 is dx
    assert perm[1 * 9 + 3] == 1 * 18 + 6 and perm[36 + 1 * 9 + 3] == 1 * 18 + 7


def test_convert_imports_numpy_and_torch_only():
    import ast

    src = open(convert.__file__).read()
    mods = set()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Import):
            mods |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods.add(node.module.split(".")[0])
    assert mods <= {"__future__", "re", "numpy", "torch"}, mods
