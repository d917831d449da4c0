"""LR schedulers (a copy of dbw_tpu/train/scheduler.py, reference
src/scheduler.py): closed-form epoch -> per-group LRs on the host, the
reference's MultiStepLR (one gamma per param group, linear warmup) plus
cosine and exponential. ``set_lrs`` writes them into the optimizer's param
groups by name."""

from __future__ import annotations

import math
from bisect import bisect_right


class MultiStepLR:
    def __init__(self, base_lrs: dict, milestones=None, gamma=0.1, warmup=0):
        self.base_lrs = dict(base_lrs)
        self.groups = list(base_lrs)
        self.milestones = sorted(milestones or [])
        if isinstance(gamma, (int, float)):
            gamma = [float(gamma)] * len(self.groups)
        if len(gamma) != len(self.groups):
            raise ValueError(
                f"need one gamma per param group {self.groups}, got {gamma}")
        self.gamma = {g: float(gm) for g, gm in zip(self.groups, gamma)}
        self.warmup = warmup

    def lrs(self, epoch):
        """LRs in effect DURING `epoch` (0-based; the reference steps the
        scheduler at the end of each epoch)."""
        if self.warmup > epoch:
            return {
                g: lr / self.warmup * (epoch + 1) for g, lr in self.base_lrs.items()
            }
        k = bisect_right(self.milestones, epoch)
        return {g: lr * self.gamma[g] ** k for g, lr in self.base_lrs.items()}


class CosineAnnealingLR:
    def __init__(self, base_lrs: dict, T_max, eta_min=0.0):
        self.base_lrs = dict(base_lrs)
        self.T_max = T_max
        self.eta_min = eta_min

    def lrs(self, epoch):
        c = (1 + math.cos(math.pi * min(epoch, self.T_max) / self.T_max)) / 2
        return {
            g: self.eta_min + (lr - self.eta_min) * c
            for g, lr in self.base_lrs.items()
        }


class ExponentialLR:
    def __init__(self, base_lrs: dict, gamma=0.95):
        self.base_lrs = dict(base_lrs)
        self.gamma = gamma

    def lrs(self, epoch):
        return {g: lr * self.gamma**epoch for g, lr in self.base_lrs.items()}


def create_scheduler(cfg, base_lrs):
    """``base_lrs``: {group name: lr}, e.g. from ``base_lrs(optimizer)``."""
    kwargs = dict(cfg["training"].get("scheduler") or {})
    name = kwargs.pop("name", "multi_step") or "multi_step"
    cls = {
        "multi_step": MultiStepLR,
        "cosine_annealing": CosineAnnealingLR,
        "exponential": ExponentialLR,
    }[name]
    return cls(base_lrs, **kwargs)


def base_lrs(optimizer):
    """{group name: lr} of an optimizer built by ``create_optimizer``."""
    return {g["name"]: g["lr"] for g in optimizer.param_groups}


def set_lrs(optimizer, lrs: dict):
    """Write the LRs of ``lrs`` ({group name: lr}) into the param groups."""
    for g in optimizer.param_groups:
        g["lr"] = lrs[g["name"]]
