"""Pixel losses and TV norms (PyTorch port of dbw_tpu/losses/basic.py).

Each pixel loss takes ``slots``: for a batch of slots * B views, slot-major
(the batched seed step), it returns the (slots,) per-slot means."""

import torch

from ..ops.safe_math import safe_pow


def _mean(x, slots=None):
    """The mean of x, or with ``slots`` the (slots,) means of its slot-major
    parts (each slot's views of a batch of slots * B)."""
    return torch.mean(x) if slots is None else x.reshape(slots, -1).mean(1)


def mse_loss(a, b, slots=None):
    return _mean((a - b) ** 2, slots)


def l1_loss(a, b, slots=None):
    return _mean(torch.abs(a - b), slots)


def huber_loss(a, b, delta=1.0, slots=None):
    d = a - b
    ad = torch.abs(d)
    return _mean(torch.where(ad < delta, 0.5 * d * d, delta * (ad - 0.5 * delta)), slots)


def bce_with_logits_loss(logits, targets, slots=None):
    return _mean(torch.maximum(logits, torch.zeros_like(logits)) - logits * targets
                 + torch.log1p(torch.exp(-torch.abs(logits))), slots)


def mse2psnr(x):
    """PSNR in dB of a mean squared error on [0, 1] images."""
    return -10.0 * torch.log(torch.as_tensor(x)) / torch.log(torch.tensor(10.0))


# TV norms reduce the CHANNEL axis of a diff tensor (..., C) -> (...)
tv_norm_funcs = {
    "l1": lambda t: t.abs().sum(-1),
    "l2": lambda t: safe_pow((t**2).sum(-1), 0.5),
    "l2sq": lambda t: (t**2).sum(-1),
}

def total_variation(imgs):
    """Isotropic squared TV of (B, H, W, C) images."""
    dx = torch.diff(imgs, dim=2) ** 2
    dy = torch.diff(imgs, dim=1) ** 2
    return dx.mean() + dy.mean()
