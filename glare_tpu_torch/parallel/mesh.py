"""Data parallelism over ``torch.distributed`` (counterpart of
``glare_tpu/parallel/mesh.py``).

The JAX package runs one SPMD program over a device mesh: the batch sharded on
its leading axis over the ``data`` axis, the parameters replicated (or
FSDP-sharded), XLA's all-reduce averaging the gradients. The port runs one
process per device instead (``torchrun``), joined by a process group: NCCL on
the card, gloo on the CPU.

  * :func:`init_distributed` joins the group that ``torchrun``'s environment
    describes (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``); :func:`make_mesh` / :func:`make_mesh_2d` return a
    ``DeviceMesh`` with the JAX axis names.
  * :func:`shard_batch` is the rank's contiguous block of the leading axis (the
    layout of JAX's ``P("data")``); a batch that does not divide stays whole on
    every rank, as the JAX models' ``_put_batch`` leaves it unsharded.
  * :func:`cross_replica_mean` averages tensors over the ``data`` axis
    (``pmean``); :func:`average_gradients` does it to ``.grad`` in place, for a
    step that takes the explicit average instead of DDP's reducer.
  * :func:`make_dp_train_step` wraps a network in ``DistributedDataParallel``:
    parameters replicated, gradients averaged by the all-reduce during backward.
    The network's methods are reached through :class:`CallThrough`, so that a
    method call (``aft_half``, ``normal_flow``) is the wrapper's forward.
  * :func:`auto_shardings` is JAX's per-leaf FSDP rule, and
    :func:`make_fsdp_train_step` applies it with ``fully_shard`` (FSDP2).
  * :class:`EnlargedSampler` gives exactly the JAX sampler's indices.

On a 2-D mesh (``data`` x ``model``) FSDP2 replicates over the first axis and
shards over the second (HSDP); JAX shards a parameter over both axes. The step's
result is the same (every rank of a ``model`` group sees the same block of the
batch, and averaging equal gradients changes nothing); the memory layout is not.
"""

from __future__ import annotations

import datetime
import inspect
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

MIN_SHARD_SIZE = 2 ** 12   # leaves below this many elements stay whole (JAX's min_size)


# ---------------------------------------------------------------- group --

def init_distributed(device="cuda", backend=None, timeout_s=600):
    """Join the process group of ``torchrun``'s environment (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) -> (rank,
    world size). ``backend`` defaults to NCCL when ``device`` is a CUDA device, else
    gloo. Each process takes the card ``LOCAL_RANK`` modulo the visible count (so
    two ranks may share one card over gloo). A group that is already up is
    returned as it is."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    dev = torch.device(device)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    rank = int(os.environ.get("RANK", "0"))
    local = int(os.environ.get("LOCAL_RANK", str(rank)))
    if dev.type == "cuda":
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(backend or ("nccl" if dev.type == "cuda" else "gloo"), init_method="env://",
                            rank=rank, world_size=world, timeout=datetime.timedelta(seconds=timeout_s))
    return rank, world


def local_device(device="cuda"):
    """The device of this rank: ``cuda:<LOCAL_RANK mod cards>`` for a CUDA device, else it."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")) % max(torch.cuda.device_count(), 1))
    return dev


def rank():
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def world_size():
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def is_data_parallel():
    """True when a process group of more than one rank is up."""
    return world_size() > 1


def make_mesh(n_devices: Optional[int] = None, axis_name: str = "data"):
    """1-D ``DeviceMesh`` over ``n_devices`` ranks (default: the whole group)."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(_mesh_device_type(), (n_devices or world_size(),), mesh_dim_names=(axis_name,))


def make_mesh_2d(n_data: int, n_model: int, axis_names: tuple = ("data", "model")):
    """2-D ``DeviceMesh`` (``data`` x ``model``); ranks fill it row-major, as JAX's
    ``reshape(n_data, n_model)`` of the device list."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(_mesh_device_type(), (n_data, n_model), mesh_dim_names=tuple(axis_names))


def _mesh_device_type():
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def _axis(mesh, axis_name):
    """(size, this rank's coordinate, process group) of ``axis_name`` (the world without a mesh)."""
    if mesh is None:
        return world_size(), rank(), None
    return mesh.size(mesh.mesh_dim_names.index(axis_name)), mesh.get_local_rank(axis_name), \
        mesh.get_group(axis_name)


# ---------------------------------------------------------------- data --

def shard_batch(x, mesh=None, axis_name: str = "data"):
    """The rank's contiguous block of the leading axis of ``x`` (a tensor or an
    array): JAX's ``P("data")`` layout. Unchanged when the axis has one rank or the
    leading axis does not divide by its size."""
    n, r, _ = _axis(mesh, axis_name)
    if n == 1 or x.shape[0] % n:
        return x
    b = x.shape[0] // n
    return x[r * b:(r + 1) * b]


def replicate(module: nn.Module, mesh=None, axis_name: str = "data"):
    """Broadcast ``module``'s parameters and buffers from the axis's first rank (JAX's
    replicated sharding): every rank starts from the same weights. -> ``module``."""
    n, _, group = _axis(mesh, axis_name)
    if n > 1:
        src = dist.get_global_rank(group, 0) if group is not None else 0
        with torch.no_grad():
            for t in list(module.parameters()) + list(module.buffers()):
                dist.broadcast(t.data, src, group=group)
    return module


def _leaves(tree):
    if torch.is_tensor(tree):
        return [tree]
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in _leaves(v)]
    return []


def _rebuild(tree, it):
    if torch.is_tensor(tree):
        return next(it)
    if isinstance(tree, dict):
        return {k: _rebuild(v, it) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, it) for v in tree)
    return tree


def cross_replica_mean(tree, mesh=None, axis_name: str = "data"):
    """The mean over the axis's ranks of every tensor in ``tree`` (a tensor, or a
    list / tuple / dict of them): one summing all-reduce per (dtype, device) over a
    flat buffer, then a division. New tensors; the inputs are left as they are."""
    n, _, group = _axis(mesh, axis_name)
    leaves = _leaves(tree)
    if n == 1:
        return _rebuild(tree, iter([t.detach().clone() for t in leaves]))
    out = [None] * len(leaves)
    buckets = {}
    for i, t in enumerate(leaves):
        buckets.setdefault((t.dtype, t.device), []).append(i)
    for idx in buckets.values():
        flat = torch.cat([leaves[i].detach().reshape(-1) for i in idx])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)   # gloo has no AVG
        flat /= n
        off = 0
        for i in idx:
            k = leaves[i].numel()
            out[i] = flat[off:off + k].view_as(leaves[i])
            off += k
    return _rebuild(tree, iter(out))


def average_gradients(params, mesh=None, axis_name: str = "data"):
    """``p.grad`` <- its mean over the axis's ranks, for every parameter with a
    gradient (the explicit average; DDP's reducer does the same during backward)."""
    params = [p for p in params if p.grad is not None]
    if _axis(mesh, axis_name)[0] == 1 or not params:
        return
    means = cross_replica_mean([p.grad for p in params], mesh, axis_name)
    for p, g in zip(params, means):
        p.grad.copy_(g)


class _AllReduceSum(torch.autograd.Function):
    """A summing all-reduce whose backward sums the incoming gradients the same way."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        t = t.clone()
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
        return t

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, op=dist.ReduceOp.SUM, group=ctx.group)
        return grad, None


def global_mean(t, mesh=None, axis_name: str = "data"):
    """``t.mean()`` over the whole data-parallel batch (the ranks hold equal blocks):
    the ranks' means summed by an all-reduce whose backward all-reduces the
    incoming gradient (``_AllReduceSum``), so that a network or loss that takes a
    mean over the batch (the AFT's ``mean(h) / mean(x_vq)``, MS-SSIM's level
    means) computes the whole batch's value on every rank, and DDP's average of
    the ranks' parameter gradients is the gradient of the whole batch's loss.
    Every rank must call it at the same point of its step."""
    m = t.mean()
    n, _, group = _axis(mesh, axis_name)
    if n == 1:
        return m
    return _AllReduceSum.apply(m, group) / n


def moments_over_ranks(x, dims, mesh=None, axis_name: str = "data"):
    """(mean, population variance) of ``x`` over ``dims`` and over the axis's ranks,
    keepdim, in two passes: the mean from the all-reduced sum and count, then the
    variance from the all-reduced sum of (x - mean)^2."""
    n, _, group = _axis(mesh, axis_name)
    count = torch.tensor([float(np.prod([x.shape[d] for d in dims]))], dtype=x.dtype, device=x.device)
    s = x.sum(dim=dims, keepdim=True)
    if n > 1:
        dist.all_reduce(s, group=group)
        dist.all_reduce(count, group=group)
    mean = s / count
    s2 = ((x - mean) ** 2).sum(dim=dims, keepdim=True)
    if n > 1:
        dist.all_reduce(s2, group=group)
    return mean, s2 / count


# ---------------------------------------------------------------- DDP --

class CallThrough(nn.Module):
    """``forward(method, *args, **kwargs)`` = ``net.<method>(*args, **kwargs)``: DDP
    and FSDP2 act around ``forward``, so a model's method call goes through here."""

    def __init__(self, net: nn.Module):
        super().__init__()
        self.net = net

    def forward(self, method, *args, **kwargs):
        return getattr(self.net, method)(*args, **kwargs)


def make_dp_train_step(net: nn.Module, mesh=None, axis_name: str = "data", **ddp_kwargs):
    """``DistributedDataParallel`` around ``CallThrough(net)``: the parameters are
    broadcast from rank 0 once, and each backward averages the gradients of the
    parameters that require one (frozen ones stay out of the reducer). Buffers are
    not re-broadcast at each forward (``forward_sync_buffers`` /
    ``broadcast_buffers`` False): the port's buffers are functions of the weights,
    equal on every rank."""
    from torch.nn.parallel import DistributedDataParallel

    _, _, group = _axis(mesh, axis_name)
    dev = next(net.parameters()).device
    # the newer name of the switch where this torch has it (the old one is deprecated)
    sync = ("forward_sync_buffers" if "forward_sync_buffers" in inspect.signature(DistributedDataParallel).parameters
            else "broadcast_buffers")
    kw = {sync: False, **ddp_kwargs}
    if dev.type == "cuda":
        kw.setdefault("device_ids", [dev.index if dev.index is not None else torch.cuda.current_device()])
    return DistributedDataParallel(CallThrough(net), process_group=group, **kw)


# ---------------------------------------------------------------- FSDP --

def auto_shardings(tree, mesh, axis_names=None, min_size: int = MIN_SHARD_SIZE):
    """JAX's FSDP rule per leaf: each mesh axis in turn takes the largest still
    unassigned dim (> 1) that divides by its size; leaves under ``min_size``
    elements stay whole. ``tree``: a module (its named parameters) or a dict of
    tensors or shapes. -> {name: spec}, spec a tuple with an axis name or None per
    dim (``()`` for a whole leaf), as JAX's ``PartitionSpec``."""
    axis_names = tuple(axis_names or mesh.mesh_dim_names)
    items = tree.named_parameters() if isinstance(tree, nn.Module) else tree.items()
    out = {}
    for name, x in items:
        shape = tuple(x.shape) if hasattr(x, "shape") else tuple(x)
        if int(np.prod(shape)) < min_size:
            out[name] = ()
            continue
        spec, taken = [None] * len(shape), set()
        for ax in axis_names:
            size = mesh.size(mesh.mesh_dim_names.index(ax))
            cands = [d for d in range(len(shape)) if d not in taken and shape[d] % size == 0 and shape[d] > 1]
            if not cands:
                continue
            d = max(cands, key=lambda d: shape[d])
            spec[d] = ax
            taken.add(d)
        out[name] = tuple(spec)
    return out


def contiguous_parameters_(net: nn.Module):
    """Every parameter of ``net`` in contiguous memory (channels_last weights
    converted): FSDP2 shards contiguous parameters only. -> ``net``."""
    with torch.no_grad():
        for p in net.parameters():
            if not p.is_contiguous():
                p.data = p.data.contiguous()
    return net


def make_fsdp_train_step(net: nn.Module, mesh, min_size: int = MIN_SHARD_SIZE, axis_names=None):
    """FSDP2 (``fully_shard``) over ``mesh`` around ``CallThrough(net)``. Each
    parameter is sharded on the dim that :func:`auto_shardings` gives the mesh's
    last axis (the one FSDP2 shards over; a 2-D mesh replicates over the first);
    a leaf under ``min_size`` elements, or one the rule leaves whole, is sharded on
    dim 0, where FSDP2 pads uneven shards, so that its gradient is reduced like the
    rest. Parameters in channels_last memory are made contiguous first
    (:func:`contiguous_parameters_`). Build the optimizer after this call, on the
    returned module's parameters.
    -> (the sharded ``CallThrough``, the specs of :func:`auto_shardings`)."""
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    specs = auto_shardings(net, mesh, axis_names, min_size)
    contiguous_parameters_(net)
    shard_axis = mesh.mesh_dim_names[-1]
    dims = {id(p): (specs[n].index(shard_axis) if shard_axis in specs[n] else 0)
            for n, p in net.named_parameters()}
    wrapper = CallThrough(net)
    fully_shard(wrapper, mesh=mesh, shard_placement_fn=lambda p: Shard(dims.get(id(p), 0)))
    return wrapper, specs


# ---------------------------------------------------------------- sampler --

class EnlargedSampler:
    """Rank-sharded, epoch-seeded shuffled indices with dataset enlargement
    (reference: basicsr/data/data_sampler.py:6-48); numpy, index for index the
    JAX package's sampler."""

    def __init__(self, num_samples: int, num_replicas: int, rank: int, ratio: int = 1):
        self.num_samples_raw = num_samples
        self.num_replicas = num_replicas
        self.rank = rank
        self.num_samples = int(np.ceil(num_samples * ratio / num_replicas))
        self.total_size = self.num_samples * num_replicas
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def indices(self):
        order = np.random.default_rng(self.epoch).permutation(self.total_size)
        order = order % self.num_samples_raw
        return order[self.rank:self.total_size:self.num_replicas]

    def __iter__(self):
        return iter(self.indices())

    def __len__(self):
        return self.num_samples
