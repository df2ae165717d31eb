"""Vector quantizer of the GLARE codebook retrieval (counterpart of
``glare_tpu/modules/quantize.py``, ``VectorQuantizer2`` only; the weighted
stage-1 variant is not ported yet).

The argmin goes through :mod:`glare_tpu_torch.ops.vq` (the hand-written kernel
on a CUDA tensor).
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops import vq as vq_ops


class VectorQuantizer2(nn.Module):
    """Nearest-neighbour codebook with straight-through gradients.

    ``forward(z[B, C, H, W]) -> (z_q, loss, (None, None, indices))`` with the
    tuple shape of the reference forward. The codebook is
    ``embedding.weight [n_e, e_dim]`` (float32).
    """

    def __init__(self, n_e=8192, e_dim=3, beta=0.25, legacy=True, sane_index_shape=False):
        super().__init__()
        self.n_e, self.e_dim, self.beta = n_e, e_dim, beta
        self.legacy, self.sane_index_shape = legacy, sane_index_shape
        self.embedding = nn.Embedding(n_e, e_dim)
        self.last_indices = None  # int32 [B*H*W] of the last forward (for audits)

    def seeded_reset(self, generator):
        with torch.no_grad():
            self.embedding.weight.uniform_(-1.0 / self.n_e, 1.0 / self.n_e, generator=generator)

    def forward(self, z):
        b, c, h, w = z.shape
        assert c == self.e_dim, (z.shape, self.e_dim)
        z_nhwc = z.permute(0, 2, 3, 1)
        z_flat = z_nhwc.reshape(-1, self.e_dim)
        codebook = self.embedding.weight
        idx = vq_ops.nearest_code(z_flat.detach(), codebook.detach())
        self.last_indices = idx
        z_q = codebook[idx.long()].reshape(b, h, w, c).to(z.dtype)

        zf, zqf = z_nhwc.float(), z_q.float()
        if not self.legacy:
            loss = self.beta * torch.mean((zqf.detach() - zf) ** 2) + torch.mean((zqf - zf.detach()) ** 2)
        else:
            loss = torch.mean((zqf.detach() - zf) ** 2) + self.beta * torch.mean((zqf - zf.detach()) ** 2)

        z_q = z_nhwc + (z_q - z_nhwc).detach()  # straight-through
        z_q = z_q.permute(0, 3, 1, 2)
        if self.sane_index_shape:
            idx = idx.reshape(b, h, w)
        return z_q, loss, (None, None, idx)

    def get_codebook_entry(self, indices, shape=None):
        """indices [...] -> embeddings, optionally reshaped to NHWC ``shape``."""
        z_q = self.embedding.weight[indices.reshape(-1).long()]
        return z_q.reshape(shape) if shape is not None else z_q
