"""Learning-rate schedules from mmcv-style ``lr_config`` dicts.

Counterpart of ``distillbev_tpu/training/schedules.py:build_lr_schedule``
(:131) for the ``step`` policy of the distill recipes (``step_lr``
:47-66: epoch milestones, optional ``min_lr`` floor) and the
``CosineAnnealing`` policy of the BEVFormer recipe, with mmcv's warmups.
A schedule maps the optimizer step (0 for the first update, as optax
counts) to a learning rate.  The ``cyclic`` policy is not ported.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

Schedule = Callable[[int], float]


def _warmup_wrap(schedule: Schedule, warmup: Optional[str],
                 warmup_iters: int, warmup_ratio: float,
                 base_lr: float) -> Schedule:
    """mmcv's warmup over the first ``warmup_iters`` steps."""
    if warmup is None:
        return schedule
    if warmup not in ("linear", "exp", "constant"):
        raise NotImplementedError(f"warmup {warmup!r}")

    def sched(step: int) -> float:
        if step >= warmup_iters:
            return schedule(step)
        frac = min(max(step / max(warmup_iters, 1), 0.0), 1.0)
        if warmup == "linear":
            k = 1.0 - (1.0 - frac) * (1.0 - warmup_ratio)
        elif warmup == "exp":
            k = warmup_ratio ** (1 - frac)
        else:
            k = warmup_ratio
        return base_lr * k

    return sched


def step_lr(base_lr: float, steps_per_epoch: int, step: Sequence[int],
            gamma: float = 0.1, min_lr: Optional[float] = None,
            warmup: Optional[str] = None, warmup_iters: int = 500,
            warmup_ratio: float = 1.0 / 3) -> Schedule:
    """``base_lr`` times ``gamma`` for every epoch milestone in ``step``
    that the step has reached (``step >= epoch * steps_per_epoch``, as
    optax's ``piecewise_constant_schedule``), floored at ``min_lr``."""
    boundaries = sorted({int(e * steps_per_epoch) for e in step})

    def sched(s: int) -> float:
        v = base_lr * gamma ** sum(s >= b for b in boundaries)
        return max(v, min_lr) if min_lr is not None else v

    return _warmup_wrap(sched, warmup, warmup_iters, warmup_ratio, base_lr)


def cosine_annealing_lr(base_lr: float, total_steps: int,
                        min_lr_ratio: float = 1e-3,
                        warmup: Optional[str] = "linear",
                        warmup_iters: int = 500,
                        warmup_ratio: float = 1.0 / 3) -> Schedule:
    """CosineAnnealing from ``base_lr`` to ``base_lr * min_lr_ratio``
    after mmcv's warmup."""
    min_lr = base_lr * min_lr_ratio

    def sched(step: int) -> float:
        frac = min(max(step / max(total_steps, 1), 0.0), 1.0)
        return min_lr + (base_lr - min_lr) * 0.5 * (1 + math.cos(
            math.pi * frac))

    return _warmup_wrap(sched, warmup, warmup_iters, warmup_ratio, base_lr)


def build_lr_schedule(lr_config: dict, base_lr: float, total_steps: int,
                      steps_per_epoch: int) -> Schedule:
    cfg = dict(lr_config)
    policy = cfg.pop("policy", "step").lower()
    warmup = cfg.get("warmup")
    warmup_iters = cfg.get("warmup_iters", 500)
    warmup_ratio = cfg.get("warmup_ratio", 1.0 / 3)
    if policy == "step":
        return step_lr(base_lr, steps_per_epoch, cfg.get("step", []),
                       cfg.get("gamma", 0.1), cfg.get("min_lr"), warmup,
                       warmup_iters, warmup_ratio)
    if policy == "cosineannealing":
        return cosine_annealing_lr(base_lr, total_steps,
                                   cfg.get("min_lr_ratio", 1e-3), warmup,
                                   warmup_iters, warmup_ratio)
    raise NotImplementedError(policy)
