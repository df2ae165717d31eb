"""Learning-rate schedules as pure functions of the update count (counterpart of
``glare_tpu/models/lr_scheduler.py``).

Closed forms of the reference's MultiStepLR_Restart and
CosineAnnealingLR_Restart (code/models/lr_scheduler.py:8-65) with the linear
warmup of BaseModel.update_learning_rate. The optimizer applies ``schedule(k)``
on its k-th update, counting from 0, as optax does: with ``warmup_iter`` > 0 the
first update is exactly zero.
"""

from __future__ import annotations

import bisect
import math
from typing import Optional, Sequence


def multistep_restart_schedule(base_lr: float, milestones: Sequence[int], gamma: float = 0.5,
                               restarts: Optional[Sequence[int]] = None,
                               restart_weights: Optional[Sequence[float]] = None,
                               warmup_iter: int = -1):
    """lr(step) = base * weight(last restart <= step) * gamma^(milestones in
    (last restart, step]), linear warmup over the first ``warmup_iter`` steps."""
    milestones = sorted(int(m) for m in (milestones or []))
    restarts = sorted(int(r) for r in (restarts or [0]))
    weights = [float(w) for w in (restart_weights if restart_weights is not None
                                  else [1.0] * len(restarts))]
    if restarts[0] != 0:
        restarts, weights = [0] + restarts, [1.0] + weights

    def schedule(step):
        step = int(step)
        ri = bisect.bisect_right(restarts, step) - 1
        n = sum(1 for m in milestones if restarts[ri] < m <= step)
        lr = base_lr * weights[ri] * gamma ** n
        if warmup_iter > 0 and step < warmup_iter:
            lr = base_lr * step / warmup_iter
        return lr

    return schedule


def cosine_restart_schedule(base_lr: float, T_period: Sequence[int], eta_min: float = 0.0,
                            restarts: Optional[Sequence[int]] = None,
                            restart_weights: Optional[Sequence[float]] = None,
                            warmup_iter: int = -1):
    """Cosine annealing with warm restarts (closed form of the reference)."""
    starts = [0] + [int(r) for r in (restarts or [])]
    weights = [1.0] + [float(w) for w in (restart_weights or [1.0] * (len(starts) - 1))]
    periods = [float(t) for t in T_period]

    def schedule(step):
        step = int(step)
        ri = bisect.bisect_right(starts, step) - 1
        t = step - starts[ri]
        lr = eta_min + (base_lr * weights[ri] - eta_min) * (1 + math.cos(math.pi * t / periods[ri])) / 2
        if warmup_iter > 0 and step < warmup_iter:
            lr = base_lr * step / warmup_iter
        return lr

    return schedule


def build_schedule(train_opt: dict):
    """The schedule a GLARE train conf names (reference: LLFlow_model.py:121-139)."""
    scheme = train_opt.get("lr_scheme", "MultiStepLR")
    base_lr = float(train_opt["lr_G"])
    warmup = int(train_opt.get("warmup_iter") or -1)
    if scheme == "MultiStepLR":
        return multistep_restart_schedule(
            base_lr, train_opt.get("lr_steps") or [], gamma=float(train_opt.get("lr_gamma") or 0.1),
            restarts=train_opt.get("restarts"), restart_weights=train_opt.get("restart_weights"),
            warmup_iter=warmup)
    if scheme == "CosineAnnealingLR_Restart":
        return cosine_restart_schedule(
            base_lr, train_opt["T_period"], eta_min=float(train_opt.get("eta_min") or 0.0),
            restarts=train_opt.get("restarts"), restart_weights=train_opt.get("restart_weights"),
            warmup_iter=warmup)
    raise NotImplementedError(f"lr_scheme {scheme}")
