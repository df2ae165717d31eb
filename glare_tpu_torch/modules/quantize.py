"""Vector quantizers (counterpart of ``glare_tpu/modules/quantize.py``):
``VectorQuantizer2``, the stage-1 ``WeightedVectorQuantizer``, and the variants
no shipped conf uses, ``GumbelQuantize`` and ``EMAVectorQuantizer``, with
``remap_to_used`` / ``unmap_to_all``.

``VectorQuantizer2``'s argmin goes through :mod:`glare_tpu_torch.ops.vq` (the
hand-written kernel on a CUDA tensor), which reads the flattened tokens as they
are: a view of the NHWC latent, in its dtype, with its strides.
``WeightedVectorQuantizer``'s does not: the JAX package computes it with dense
XLA outside any Pallas kernel (K 1024, D 512, where ``vq_argmin`` serves D 3),
so here it is a float32 ``matmul`` and ``argmin``. The two variants are dense
too, as in JAX.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..nn.layers import Conv, at_least_float32
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


# The reference's legacy ``VectorQuantizer`` (its beta bug included) is
# VectorQuantizer2 with legacy=True: the JAX package names it so, and so here.
VectorQuantizer = VectorQuantizer2


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


def remap_to_used(inds, used, unknown_index, generator=None, re_embed=None):
    """Map full-codebook indices [B, ...] onto positions in ``used``. An index
    not in ``used`` becomes ``unknown_index``: "random" (a draw below
    ``re_embed`` from ``generator``), "extra" (``len(used)``) or an integer."""
    ishape = inds.shape
    flat = inds.reshape(ishape[0], -1)
    match = (flat[:, :, None] == used[None, None, :].to(flat.dtype)).long()
    new = match.argmax(dim=-1)
    unknown = match.sum(dim=2) < 1
    if unknown_index == "random":
        if re_embed is None:
            raise ValueError("remap_to_used: unknown_index 'random' needs re_embed")
        rand = torch.randint(0, re_embed, new.shape, generator=generator, device=new.device)
        new = torch.where(unknown, rand, new)
    else:
        fill = used.shape[0] if unknown_index == "extra" else int(unknown_index)
        new = torch.where(unknown, torch.full_like(new, fill), new)
    return new.reshape(ishape)


def unmap_to_all(inds, used):
    """Inverse of :func:`remap_to_used`; the extra token collapses to index 0."""
    ishape = inds.shape
    flat = inds.reshape(ishape[0], -1).long()
    flat = torch.where(flat >= used.shape[0], torch.zeros_like(flat), flat)
    return used.long()[flat].reshape(ishape)


def sample_gumbel(shape, generator=None, device=None, dtype=torch.float32):
    """Standard Gumbel noise ``-log(-log(u))``, u uniform in [tiny, 1), from ``generator``."""
    u = torch.rand(shape, generator=generator, device=device, dtype=dtype)
    u = torch.clamp(u, min=torch.finfo(dtype).tiny)
    return -torch.log(-torch.log(u))


class GumbelQuantize(nn.Module):
    """Gumbel-softmax quantizer (reference: quantize.py:110-209). NCHW.

    ``forward(z[B, num_hiddens, H, W], temp=None, return_logits=False,
    generator=None) -> (z_q [B, embedding_dim, H, W], kl_diff, (None, None,
    indices [B, H, W]))`` (``(z_q, kl_diff, indices)`` without
    ``use_vqinterface``; the logits NCHW after it with ``return_logits``).
    In training the Gumbel noise ([B, H, W, codes], JAX's shape) is drawn from
    ``generator`` (the caller's ``torch.Generator`` on z's device; None: torch's
    default one); in
    ``.eval()`` the categorical is a hard argmax of the logits, with no noise:
    the JAX module's documented deviation (PARITY.md), where the reference
    samples noise in eval too. ``proj`` (1x1 conv) and ``embed.weight``; with
    ``remap`` (an array of used indices) the buffer ``used``.
    """

    def __init__(self, num_hiddens, embedding_dim, n_embed, straight_through=True, kl_weight=5e-4,
                 temp_init=1.0, use_vqinterface=True, remap=None, unknown_index="random"):
        super().__init__()
        self.embedding_dim, self.n_embed = embedding_dim, n_embed
        self.straight_through, self.kl_weight, self.temperature = straight_through, kl_weight, temp_init
        self.use_vqinterface, self.unknown_index = use_vqinterface, unknown_index
        self.proj = Conv(num_hiddens, n_embed, 1)
        self.embed = nn.Embedding(n_embed, embedding_dim)
        self.remap = remap
        if remap is not None:
            self.register_buffer("used", torch.as_tensor(np.asarray(remap), dtype=torch.long))

    def seeded_reset(self, generator):
        with torch.no_grad():
            self.embed.weight.normal_(0.0, 1.0, generator=generator)

    def forward(self, z, temp=None, return_logits=False, generator=None):
        # the codes on the last axis (NHWC, as JAX): softmax, argmax and the one-hot
        # product read contiguous rows
        logits = self.proj(z.contiguous(memory_format=torch.channels_last)).permute(0, 2, 3, 1)
        if self.remap is not None:
            logits = logits[..., self.used]
        deterministic = not self.training
        hard = True if deterministic else self.straight_through
        temp = self.temperature if temp is None else temp
        if deterministic:
            y_soft = torch.softmax(logits / temp, dim=-1)
        else:
            g = sample_gumbel(logits.shape, generator, logits.device, logits.dtype)
            y_soft = torch.softmax((logits + g) / temp, dim=-1)
        if hard:
            one_hot = torch.zeros_like(y_soft).scatter_(-1, y_soft.argmax(dim=-1, keepdim=True), 1.0)
            soft_one_hot = y_soft + (one_hot - y_soft).detach()
        else:
            soft_one_hot = y_soft
        if self.remap is not None:
            full = torch.zeros((*soft_one_hot.shape[:-1], self.n_embed), dtype=soft_one_hot.dtype,
                               device=soft_one_hot.device)
            full[..., self.used] = soft_one_hot
            soft_one_hot = full
        z_q = (soft_one_hot @ self.embed.weight).permute(0, 3, 1, 2)
        # KL to the uniform prior; the log term takes the FULL codebook size, also
        # under remap, as the reference and JAX do
        qy = torch.softmax(logits, dim=-1)
        diff = self.kl_weight * torch.mean(torch.sum(qy * torch.log(qy * self.n_embed + 1e-10), dim=-1))
        ind = soft_one_hot.argmax(dim=-1)
        if self.remap is not None:
            # no generator in eval: 'extra' (never fires: the argmax lies in `used`)
            unk = self.unknown_index if not deterministic else "extra"
            ind = remap_to_used(ind, self.used, unk, generator=generator, re_embed=self.used.shape[0])
        if not self.use_vqinterface:
            return z_q, diff, ind
        if return_logits:
            return z_q, diff, (None, None, ind), logits.permute(0, 3, 1, 2)
        return z_q, diff, (None, None, ind)

    def get_codebook_entry(self, indices, shape):
        """(b*h*w,) indices -> embeddings [b, embedding_dim, h, w]; ``shape`` (b, h, w, c)."""
        b, h, w, _ = shape
        if b * h * w != indices.shape[0]:
            raise ValueError(f"get_codebook_entry: {indices.shape[0]} indices for shape {shape}")
        indices = indices.reshape(b, h, w)
        if self.remap is not None:
            indices = unmap_to_all(indices, self.used)
        one_hot = F.one_hot(indices.long(), self.n_embed).permute(0, 3, 1, 2).to(self.embed.weight.dtype)
        return torch.einsum("bnhw,nd->bdhw", one_hot, self.embed.weight)


class EmbeddingEMA(nn.Module):
    """The EMA codebook's state, all buffers: ``weight`` [n_embed, dim] (N(0, 1)),
    ``cluster_size`` [n_embed] (0) and ``embed_avg`` (the initial weight)."""

    def __init__(self, n_embed, embedding_dim):
        super().__init__()
        weight = torch.randn(n_embed, embedding_dim)
        self.register_buffer("weight", weight)
        self.register_buffer("cluster_size", torch.zeros(n_embed))
        self.register_buffer("embed_avg", weight.clone())

    def seeded_reset(self, generator):
        with torch.no_grad():
            self.weight.normal_(0.0, 1.0, generator=generator)
            self.embed_avg.copy_(self.weight)
            self.cluster_size.zero_()


class EMAVectorQuantizer(nn.Module):
    """Nearest-neighbour VQ whose codebook follows an exponential moving average
    (reference: quantize.py:331-445, broken as shipped; the JAX module is the
    working equivalent). NCHW.

    ``forward(z, update=False) -> (z_q (straight-through), beta * mse(sg z_q, z),
    (perplexity, one-hot encodings [N, n_embed], indices [B, H, W]))``. The
    argmin is a dense float32 distance. ``update=True`` (training) applies the
    cluster-size and embedding-average EMA (``decay``) and the Laplace-smoothed
    refresh ``weight = embed_avg / ((cluster + eps) / (n + n_embed * eps) * n)``;
    z_q is taken from the codebook before the update, as in JAX.
    """

    def __init__(self, n_embed, embedding_dim, beta=0.25, decay=0.99, eps=1e-5):
        super().__init__()
        self.n_embed, self.embedding_dim = n_embed, embedding_dim
        self.beta, self.decay, self.eps = beta, decay, eps
        self.embedding = EmbeddingEMA(n_embed, embedding_dim)

    def forward(self, z, update=False):
        b, c, h, w = z.shape
        if c != self.embedding_dim:
            raise ValueError(f"EMAVectorQuantizer: {c} channels, embedding_dim {self.embedding_dim}")
        z_nhwc = z.permute(0, 2, 3, 1)
        z_flat = z_nhwc.reshape(-1, c).float()
        emb = self.embedding.weight.float()
        with torch.no_grad():
            d = (z_flat ** 2).sum(dim=1, keepdim=True) + (emb ** 2).sum(dim=1)[None] - 2.0 * (z_flat @ emb.t())
            idx = torch.argmin(d, dim=1)
        z_q = emb[idx].reshape(b, h, w, c).to(z.dtype)
        encodings = F.one_hot(idx, self.n_embed).float()
        avg_probs = encodings.mean(dim=0)
        perplexity = torch.exp(-torch.sum(avg_probs * torch.log(avg_probs + 1e-10)))
        if update:
            with torch.no_grad():
                e = self.embedding
                new_cluster = e.cluster_size * self.decay + encodings.sum(dim=0) * (1 - self.decay)
                new_avg = e.embed_avg * self.decay + (encodings.t() @ z_flat.detach()) * (1 - self.decay)
                n = new_cluster.sum()
                smoothed = (new_cluster + self.eps) / (n + self.n_embed * self.eps) * n
                e.cluster_size.copy_(new_cluster)
                e.embed_avg.copy_(new_avg)
                e.weight.copy_(new_avg / smoothed[:, None])
        loss = self.beta * torch.mean((z_q.detach().float() - z_nhwc.float()) ** 2)
        z_q = z_nhwc + (z_q - z_nhwc).detach()
        return z_q.permute(0, 3, 1, 2), loss, (perplexity, encodings, idx.reshape(b, h, w))
