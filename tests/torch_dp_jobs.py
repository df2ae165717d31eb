"""Jobs that the ranks of a spawned ``torch.distributed`` group (gloo, CPU) run for
tests/test_torch_parallel.py, and the same jobs in one process as the reference.

This module imports torch, numpy and glare_tpu_torch only, so that a spawned
rank starts in a second or two. ``Group`` starts the ranks, each runs every job of
the payload in order (one group for all of them) and sends back numpy results;
``single`` runs a job's single-process reference in the caller.

Jobs (``kind`` -> keyword arguments):
  * ``stage3``: the mini stage-3 model, one ``optimize_parameters`` step on the
    global batch (each rank takes its block, DDP, MS-SSIM over the whole batch);
    ``mode`` ``"fsdp"``: ``parallelize("fsdp")`` instead of DDP.
  * ``stage2``: the mini stage-2 model from given state dicts, the ActNorm init
    on the global batch, then one step.
  * ``gan``: the mini stage-1 HQ model, one iteration on the rank's block
    (explicit gradient average, ``reduce_loss_dict``).
  * ``fsdp``: a small MLP, one Adam step under ``make_fsdp_train_step`` (1-D
    mesh, or 2-D with ``mesh_2d``), the batch by ``shard_batch``.
  * ``misc``: ``shard_batch`` of an arange, ``auto_shardings`` of the mini
    stage-3 generator on ``make_mesh(2)``, ``reduce_loss_dict`` of rank-valued
    losses, ``cross_replica_mean`` of a tree.
"""

from __future__ import annotations

import os
import socket
import traceback

import numpy as np
import torch


def _np(t):
    return t.detach().float().cpu().numpy().copy()


def condition_heads(netG, seed=3):
    """Offsets off the integer grid (the DCN offset derivative jumps there): each
    offset channel a half-integer bias in [-2.5, 2.5], weights at std 1e-3, and the
    DCN biases raised by 1 (the AFT divides by mean(x_vq))."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for pack in netG.deformable_decoder.dcn_packs():
            co = pack.conv_offset
            n = 2 * pack.G * pack.K
            co.weight.copy_(torch.randn(co.weight.shape, generator=g) * 1e-3)
            co.bias.zero_()
            co.bias[:n] = torch.randint(-3, 3, (n,), generator=g).float() + 0.5
            pack.bias += 1.0


def stage3_model(opt):
    from glare_tpu_torch.models import create_model

    model = create_model(opt, device="cpu")
    condition_heads(model.netG)
    return model


def job_stage3(opt, lq, gt, mode=None):
    model = stage3_model({**opt, "use_dp": mode is None})
    if mode is not None:
        model.parallelize(mode)
    full = (lambda t: t.full_tensor()) if mode == "fsdp" else (lambda t: t)
    before = {n: full(p).detach().clone() for n, p in model.trainable_parameters()}
    loss = model.optimize_parameters({"LQ": lq, "GT": gt})
    return {"loss": float(loss[0]), "log": dict(model.get_current_log()),
            "grads": {n: _np(full(p.grad)) for n, p in model.trainable_parameters()},
            "params": {n: _np(full(p)) for n, p in model.trainable_parameters()},
            "moved": sum(not torch.equal(before[n], full(p)) for n, p in model.trainable_parameters()),
            "ddp": model.dp is not None}


def job_stage2(opt, stage2_sd, vqgan_sd, lq, gt):
    from glare_tpu_torch.models import create_model

    model = create_model(opt, device="cpu")
    model.load_state_dicts({k: torch.as_tensor(v) for k, v in stage2_sd.items()},
                           {k: torch.as_tensor(v) for k, v in vqgan_sd.items()})
    model.initialize_actnorm({"LQ": lq, "GT": gt})
    actnorm = {n: _np(t) for n, t in model.netG.state_dict().items() if ".actnorm." in n}
    loss = model.optimize_parameters({"LQ": lq, "GT": gt})
    return {"actnorm": actnorm, "loss": loss,
            "grads": {n: _np(p.grad) for n, p in model.trainable_parameters()},
            "params": {n: _np(p) for n, p in model.trainable_parameters()},
            "ddp": model.dp is not None}


def job_gan(opt, lq, gt):
    from glare_tpu_torch.parallel import shard_batch
    from glare_tpu_torch.sr.models import build_model

    model = build_model(opt, device="cpu")
    logs = model.optimize_parameters(1, {"lq": shard_batch(lq), "gt": shard_batch(gt)})
    return {"logs": dict(logs.items()), "dp": bool(getattr(model, "dp", False)),
            "g": {n: _np(p) for n, p in model.net_g.named_parameters()},
            "d": {n: _np(p) for n, p in model.net_d.named_parameters()}}


class MLP(torch.nn.Module):
    """JAX's FSDP test problem: tanh(x @ w1) @ w2 + b2."""

    def __init__(self, w1, w2):
        super().__init__()
        self.w1 = torch.nn.Parameter(torch.as_tensor(w1, dtype=torch.float32))
        self.w2 = torch.nn.Parameter(torch.as_tensor(w2, dtype=torch.float32))
        self.b2 = torch.nn.Parameter(torch.zeros(16))

    def loss(self, x, y):
        return ((torch.tanh(x @ self.w1) @ self.w2 + self.b2 - y) ** 2).mean()


def mlp_problem():
    """The weights and batch of JAX's test, drawn in its order from RandomState(0)."""
    rng = np.random.RandomState(0)
    w1, w2 = rng.randn(64, 128) * 0.05, rng.randn(128, 16) * 0.05
    x = torch.as_tensor(rng.randn(16, 64), dtype=torch.float32)
    y = torch.as_tensor(rng.randn(16, 16), dtype=torch.float32)
    return MLP(w1, w2), x, y


def job_fsdp(mesh_2d=None):
    from torch.distributed.tensor import DTensor

    from glare_tpu_torch.parallel import make_fsdp_train_step, make_mesh, make_mesh_2d, shard_batch

    net, x, y = mlp_problem()
    mesh = make_mesh_2d(*mesh_2d) if mesh_2d else make_mesh()
    wrapper, specs = make_fsdp_train_step(net, mesh, min_size=1024)
    opt = torch.optim.Adam(wrapper.parameters(), lr=1e-2)
    loss = wrapper("loss", shard_batch(x, mesh), shard_batch(y, mesh))
    loss.backward()
    opt.step()
    placements = {n: str(p.placements) for n, p in wrapper.net.named_parameters() if isinstance(p, DTensor)}
    params = {n: _np(p.full_tensor()) for n, p in wrapper.net.named_parameters()}
    from glare_tpu_torch.parallel import cross_replica_mean

    return {"loss": float(cross_replica_mean(loss.detach(), mesh)), "params": params,
            "placements": placements, "specs": specs,
            "local_w1": list(wrapper.net.w1.to_local().shape)}


def job_misc(opt3):
    from glare_tpu_torch.models import create_model
    from glare_tpu_torch.parallel import (auto_shardings, cross_replica_mean, make_mesh, rank,
                                          shard_batch)
    from glare_tpu_torch.sr.models.base_model import BaseSRModel

    x = torch.arange(8 * 4, dtype=torch.float32).reshape(8, 4)
    odd = torch.arange(3 * 2, dtype=torch.float32).reshape(3, 2)
    model = create_model({**opt3, "is_train": False}, device="cpu")
    mesh = make_mesh(2)
    specs = auto_shardings(model.netG, mesh)
    r = rank()
    base = BaseSRModel.__new__(BaseSRModel)
    logs = base.reduce_loss_dict({"l_a": torch.tensor(float(r + 1)), "l_b": torch.tensor(10.0 * r),
                                  "note": 3.0})
    tree = cross_replica_mean({"a": torch.full((3,), float(r)), "b": [torch.tensor([2.0 * r + 1])]})
    return {"shard": _np(shard_batch(x)), "shard_np": shard_batch(x.numpy()).copy(),
            "odd": _np(shard_batch(odd)), "specs": specs,
            "shapes": {n: list(p.shape) for n, p in model.netG.named_parameters()},
            "logs": dict(logs.items()), "tree": {"a": _np(tree["a"]), "b": _np(tree["b"][0])}}


JOBS = {"stage3": job_stage3, "stage2": job_stage2, "gan": job_gan, "fsdp": job_fsdp, "misc": job_misc}


def _rank_main(rank, world, port, payload, queue):
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK=str(rank),
                      WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
    torch.set_num_threads(2)
    import torch.distributed as dist

    from glare_tpu_torch.parallel import init_distributed

    init_distributed("cpu", timeout_s=120)
    out = {}
    try:
        for name, kind, kwargs in payload:
            out[name] = JOBS[kind](**kwargs)
    except Exception:
        out["error"] = traceback.format_exc()
    queue.put((rank, out))
    dist.destroy_process_group()


class Group:
    """``world`` spawned gloo ranks running ``payload`` ([(name, kind, kwargs)]);
    the caller works on while they run and reads them with :meth:`results`."""

    def __init__(self, world, payload):
        import torch.multiprocessing as mp

        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        self.world = world
        self.queue = mp.get_context("spawn").SimpleQueue()
        self.procs = mp.start_processes(_rank_main, args=(world, port, payload, self.queue),
                                        nprocs=world, join=False, start_method="spawn")

    def results(self):
        """-> [per rank {name: result}], after every rank has exited."""
        out = [None] * self.world
        for _ in range(self.world):
            r, res = self.queue.get()
            out[r] = res
        self.procs.join()
        return out


def single(kind, **kwargs):
    """A job in this process, with no process group: the single-process reference."""
    return JOBS[kind](**kwargs)
