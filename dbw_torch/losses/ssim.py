"""SSIM with an 11x11 Gaussian window (PyTorch port of
dbw_tpu/losses/ssim.py): a depthwise ``conv2d`` per statistic. Images are
(B, H, W, C) in [0, 1]; ``ssim_loss`` returns the per-image dissimilarity
1 - SSIM. Whether the convolutions run in TF32 is set by the caller; the
variance terms cancel catastrophically at low precision, and the Trainer
turns TF32 off."""

import numpy as np
import torch
import torch.nn.functional as Fn


def gaussian_window(window_size=11, sigma=1.5):
    g = np.exp(-((np.arange(window_size) - window_size // 2) ** 2) / (2 * sigma**2))
    g = g / g.sum()
    return np.outer(g, g).astype(np.float32)


def _depthwise_conv(x, w2d, padding):
    """x (B, C, H, W) convolved per channel with w2d (k, k)."""
    C = x.shape[1]
    filt = w2d[None, None].expand(C, 1, *w2d.shape)
    return Fn.conv2d(x, filt, padding=padding, groups=C)


def ssim_loss(img1, img2, window_size=11, padding=True):
    """Per-image mean of the 1 - SSIM map: (B,)."""
    w = torch.as_tensor(gaussian_window(window_size), device=img1.device)
    pad = window_size // 2 if padding else 0
    x1, x2 = img1.permute(0, 3, 1, 2), img2.permute(0, 3, 1, 2)
    conv = lambda x: _depthwise_conv(x, w, pad)
    mu1, mu2 = conv(x1), conv(x2)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    s1 = conv(x1 * x1) - mu1_sq
    s2 = conv(x2 * x2) - mu2_sq
    s12 = conv(x1 * x2) - mu12
    c1, c2 = 0.01**2, 0.03**2
    ssim_map = ((2 * mu12 + c1) * (2 * s12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (s1 + s2 + c2))
    return (1.0 - ssim_map).reshape(img1.shape[0], -1).mean(dim=1)


class SSIM:
    """Callable per-image SSIM dissimilarity (the reference's SSIMLoss)."""

    def __init__(self, window_size=11, padding=True):
        self.window_size = window_size
        self.padding = padding

    def __call__(self, img1, img2, slots=None):
        """(B,) per image; with ``slots``, the (slots,) means of the
        slot-major parts of a batch of slots * B views."""
        d = ssim_loss(img1, img2, self.window_size, self.padding)
        return d if slots is None else d.reshape(slots, -1).mean(1)
