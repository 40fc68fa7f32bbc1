"""AdamW with paramwise ``lr_mult`` and global-norm gradient clipping.

Counterpart of ``distillbev_tpu/training/optim.py:build_optimizer``
(:34-95).  ``paramwise_cfg.custom_keys`` maps substrings of the
parameter names to an ``lr_mult`` (the longest matching key wins;
``backbone`` matches the port's ``img_backbone.*`` as it matches the JAX
``backbone/*``); each multiplier is one AdamW parameter group.
Parameters with ``requires_grad=False`` (frozen stages, frozen norms)
are left out.  Clipping follows optax's ``clip_by_global_norm``: when the
global norm reaches ``max_norm`` every gradient becomes
``g / norm * max_norm`` (``torch.nn.utils.clip_grad_norm_`` adds 1e-6 to
the norm and differs).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch


def _match_mult(name: str, custom_keys: Dict[str, Dict]) -> float:
    best = None
    for key, spec in custom_keys.items():
        if key in name and (best is None or len(key) > best[0]):
            best = (len(key), spec.get("lr_mult", 1.0))
    return best[1] if best else 1.0


@torch.no_grad()
def clip_by_global_norm_(params: List[torch.Tensor],
                         max_norm: Optional[float]) -> torch.Tensor:
    """Global L2 norm of the gradients of ``params`` (before clipping);
    scales them in place as optax does when it is ``>= max_norm``."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.sqrt(sum((g.to(torch.float32) ** 2).sum() for g in grads))
    if max_norm and bool(norm >= max_norm):
        for g in grads:
            g.div_(norm).mul_(max_norm)
    return norm


class Optimizer:
    """``step(step_index)``: clip, set every group's learning rate to
    ``lr_schedule(step_index) * lr_mult`` and apply one AdamW update.
    Returns the global gradient norm before clipping."""

    def __init__(self, optimizer_cfg: dict, lr_schedule: Callable[[int],
                                                                  float],
                 model: torch.nn.Module, grad_clip: Optional[dict] = None):
        cfg = dict(optimizer_cfg)
        opt_type = cfg.pop("type", "AdamW").lower()
        if opt_type != "adamw":
            raise NotImplementedError(opt_type)
        paramwise = dict(cfg.pop("paramwise_cfg", {}) or {})
        custom_keys = {k: dict(v) for k, v in
                       dict(paramwise.get("custom_keys", {})).items()}
        groups: Dict[float, List[torch.Tensor]] = {}
        for name, p in model.named_parameters():
            if p.requires_grad:
                groups.setdefault(_match_mult(name, custom_keys), []).append(p)
        self.lr_schedule = lr_schedule
        self.max_norm = dict(grad_clip or {}).get("max_norm")
        self.params = [p for ps in groups.values() for p in ps]
        self.adamw = torch.optim.AdamW(
            [dict(params=ps, lr_mult=m) for m, ps in groups.items()],
            lr=cfg.pop("lr", 1e-4), betas=tuple(cfg.pop("betas",
                                                        (0.9, 0.999))),
            eps=cfg.pop("eps", 1e-8),
            weight_decay=cfg.pop("weight_decay", 0.01))

    def zero_grad(self):
        self.adamw.zero_grad(set_to_none=True)

    def step(self, step_index: int) -> torch.Tensor:
        norm = clip_by_global_norm_(self.params, self.max_norm)
        lr = self.lr_schedule(step_index)
        for group in self.adamw.param_groups:
            group["lr"] = lr * group["lr_mult"]
        self.adamw.step()
        return norm


def build_optimizer(optimizer_cfg: dict, lr_schedule: Callable[[int], float],
                    model: torch.nn.Module,
                    grad_clip: Optional[dict] = None) -> Optimizer:
    return Optimizer(optimizer_cfg, lr_schedule, model, grad_clip)
