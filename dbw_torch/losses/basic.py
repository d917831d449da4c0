"""Pixel losses and TV norms (PyTorch port of dbw_tpu/losses/basic.py)."""

import torch

from ..ops.safe_math import safe_pow


def mse_loss(a, b):
    return torch.mean((a - b) ** 2)


def l1_loss(a, b):
    return torch.mean(torch.abs(a - b))


# TV norms reduce the CHANNEL axis of a diff tensor (..., C) -> (...)
tv_norm_funcs = {
    "l1": lambda t: t.abs().sum(-1),
    "l2": lambda t: safe_pow((t**2).sum(-1), 0.5),
    "l2sq": lambda t: (t**2).sum(-1),
}

LOSSES = {"mse": mse_loss, "l2": mse_loss, "l1": l1_loss}


def get_loss(name):
    if name not in LOSSES:
        raise NotImplementedError(
            f"loss {name!r} is not ported (available: {sorted(LOSSES)})")
    return LOSSES[name]
