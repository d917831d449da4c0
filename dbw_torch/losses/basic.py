"""Pixel losses and TV norms (PyTorch port of dbw_tpu/losses/basic.py)."""

import torch

from ..ops.safe_math import safe_pow


def mse_loss(a, b):
    return torch.mean((a - b) ** 2)


def l1_loss(a, b):
    return torch.mean(torch.abs(a - b))


def huber_loss(a, b, delta=1.0):
    d = a - b
    ad = torch.abs(d)
    return torch.mean(torch.where(ad < delta, 0.5 * d * d, delta * (ad - 0.5 * delta)))


def bce_with_logits_loss(logits, targets):
    return torch.mean(torch.maximum(logits, torch.zeros_like(logits)) - logits * targets
                      + torch.log1p(torch.exp(-torch.abs(logits))))


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
