"""Learning-rate schedules from mmcv-style ``lr_config`` dicts.

Counterpart of ``distillbev_tpu/training/schedules.py:build_lr_schedule``
(:131) for the ``CosineAnnealing`` policy of the BEVFormer recipe, with
mmcv's linear warmup.  A schedule maps the optimizer step (0 for the
first update, as optax counts) to a learning rate.  The ``step`` and
``cyclic`` policies of the distill recipes come with their train steps.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

Schedule = Callable[[int], float]


def cosine_annealing_lr(base_lr: float, total_steps: int,
                        min_lr_ratio: float = 1e-3,
                        warmup: Optional[str] = "linear",
                        warmup_iters: int = 500,
                        warmup_ratio: float = 1.0 / 3) -> Schedule:
    """CosineAnnealing from ``base_lr`` to ``base_lr * min_lr_ratio``;
    during the first ``warmup_iters`` steps the linear warmup's
    ``base_lr * (1 - (1 - t / warmup_iters) * (1 - warmup_ratio))``."""
    if warmup not in (None, "linear"):
        raise NotImplementedError(f"warmup {warmup!r}")
    min_lr = base_lr * min_lr_ratio

    def sched(step: int) -> float:
        if warmup is not None and step < warmup_iters:
            frac = min(max(step / max(warmup_iters, 1), 0.0), 1.0)
            return base_lr * (1.0 - (1.0 - frac) * (1.0 - warmup_ratio))
        frac = min(max(step / max(total_steps, 1), 0.0), 1.0)
        return min_lr + (base_lr - min_lr) * 0.5 * (1 + math.cos(
            math.pi * frac))

    return sched


def build_lr_schedule(lr_config: dict, base_lr: float, total_steps: int,
                      steps_per_epoch: int) -> Schedule:
    cfg = dict(lr_config)
    policy = cfg.pop("policy", "step").lower()
    if policy != "cosineannealing":
        raise NotImplementedError(policy)
    return cosine_annealing_lr(base_lr, total_steps,
                               cfg.get("min_lr_ratio", 1e-3),
                               cfg.get("warmup"), cfg.get("warmup_iters", 500),
                               cfg.get("warmup_ratio", 1.0 / 3))
