"""Vector quantizers (counterpart of ``glare_tpu/modules/quantize.py``:
``VectorQuantizer2`` and the stage-1 ``WeightedVectorQuantizer``; the
``GumbelQuantize`` / ``EMAVectorQuantizer`` variants are not ported yet).

``VectorQuantizer2``'s argmin goes through :mod:`glare_tpu_torch.ops.vq` (the
hand-written kernel on a CUDA tensor), which reads the flattened tokens as they
are: a view of the NHWC latent, in its dtype, with its strides.
``WeightedVectorQuantizer``'s does not: the JAX package computes it with dense
XLA outside any Pallas kernel (K 1024, D 512, where ``vq_argmin`` serves D 3),
so here it is a float32 ``matmul`` and ``argmin``.
"""

from __future__ import annotations

import torch
from torch import nn

from ..nn.layers import at_least_float32
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


class WeightedVectorQuantizer(nn.Module):
    """RIDCP weighted VQ (reference: dehaze_vq_weight_arch.py:24-131).

    ``forward(z[B, C, H, W], gt_indices=None, weight_alpha=None) -> (z_q NCHW,
    loss, indices [B, H, W])``. Distances |z|^2 + |e|^2 - 2 z.e in float32 (float64
    for a float64 input, as the losses),
    multiplied by ``exp(alpha * weight)`` (no gradient into ``weight``) when
    ``use_weight`` and ``LQ_stage``; the argmin; a straight-through ``z_q``.
    Loss: HQ ``mean((z_q - sg z)^2) + beta * mean((sg z_q - z)^2)``; LQ with
    ``gt_indices`` ``beta * mse(sg z_q_gt, z) + gram(z, sg z_q_gt)``.
    ``embedding.weight [n_e, e_dim]``; ``weight [n_e]`` is a parameter that no
    loss reaches (``requires_grad`` False: the JAX step's update of it is 0).
    """

    def __init__(self, n_e=8192, e_dim=3, beta=0.25, weight_alpha=1.0, use_weight=True,
                 LQ_stage=False):
        super().__init__()
        self.n_e, self.e_dim, self.beta = n_e, e_dim, beta
        self.weight_alpha, self.use_weight, self.LQ_stage = weight_alpha, use_weight, LQ_stage
        self.embedding = nn.Embedding(n_e, e_dim)
        self.weight = nn.Parameter(torch.zeros(n_e), requires_grad=False)

    def seeded_reset(self, generator):
        with torch.no_grad():
            self.embedding.weight.uniform_(-1.0 / self.n_e, 1.0 / self.n_e, generator=generator)
            self.weight.zero_()

    def distances(self, z_flat, weight_alpha=None):
        """[N, e_dim] tokens -> [N, n_e] float32 distances (weighted in the LQ stage)."""
        zf, emb = at_least_float32(z_flat), at_least_float32(self.embedding.weight)
        d = (zf ** 2).sum(dim=1, keepdim=True) + (emb ** 2).sum(dim=1)[None, :] - 2.0 * (zf @ emb.t())
        if self.use_weight and self.LQ_stage:
            alpha = self.weight_alpha if weight_alpha is None else weight_alpha
            d = d * torch.exp(alpha * self.weight.to(d.dtype))[None, :]
        return d

    def forward(self, z, gt_indices=None, weight_alpha=None):
        b, c, h, w = z.shape
        z_nhwc = z.permute(0, 2, 3, 1)
        with torch.no_grad():
            idx = torch.argmin(self.distances(z_nhwc.reshape(-1, c), weight_alpha), dim=1)
        z_q = self.embedding.weight[idx].reshape(b, h, w, c).to(z.dtype)
        zf = at_least_float32(z_nhwc)
        if self.LQ_stage and gt_indices is not None:
            zqgt = self.embedding.weight[gt_indices.reshape(-1).long()].reshape(b, h, w, c).detach().to(zf.dtype)
            loss = self.beta * torch.mean((zqgt - zf) ** 2) + _gram_loss(zf, zqgt)
        else:
            zqf = z_q.to(zf.dtype)
            loss = torch.mean((zqf - zf.detach()) ** 2) + self.beta * torch.mean((zqf.detach() - zf) ** 2)
        z_q = z_nhwc + (z_q - z_nhwc).detach()  # straight-through
        return z_q.permute(0, 3, 1, 2), loss, idx.reshape(b, h, w)

    def embed(self, indices, shape=None):
        """Codebook lookup: indices [...] -> embeddings, optionally reshaped to NHWC ``shape``."""
        z_q = self.embedding.weight[indices.reshape(-1).long()]
        return z_q.reshape(shape) if shape is not None else z_q


def _gram_loss(x, y):
    """Gram-matrix (texture) loss between NHWC feature maps
    (reference: dehaze_vq_weight_arch.py:101-118)."""

    def gram(t):
        b, h, w, c = t.shape
        f = t.reshape(b, h * w, c)
        return f.transpose(1, 2) @ f / (h * w * c)

    return torch.mean((gram(x) - gram(y)) ** 2)
