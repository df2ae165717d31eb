"""Shared pieces of the harness's tests: a miniature of each configuration and mix,
small enough for the CPU. Tests that need the card are marked ``gpu`` and decide
inside the test whether one is there."""

import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

MINI = {"network_G": {"enc_ch": 32, "decoder_ch": 32, "enc_num_res_blocks": 1, "dec_num_res_blocks": 1},
        "network_VQGAN": {"ch": 32, "n_embed": 64, "num_res_blocks": 1}}
MINI_MIX = {
    "s3_paired_eval_b8": {"sizes": [{"hw": [40, 60], "count": 4}], "batch": 2},
    "s3_unpaired_photos": {"sizes": [{"hw": [40, 60], "count": 2}, {"hw": [60, 40], "count": 1},
                                     {"hw": [25, 33], "count": 2}]},
    "s2_eval_f32": {"sizes": [{"hw": [40, 60], "count": 3}]},
}
BIG_SEED = 2 ** 31 + 977


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the cell's kernels have no CPU form")
    return torch.device("cuda")
