"""Layered soft alpha compositing (PyTorch port of dbw_tpu/render/blend.py).

Dense front-to-back blend over the K fragment slots with ``cumprod``.
"""

import torch


def layered_blend(colors, alpha, background_color):
    """colors (..., K, 3), alpha (..., K) -> RGBA (..., 4):
    rgb = sum_k prod_{j<k}(1 - a_j) a_k c_k + prod(1 - a) bkg,
    alpha channel = 1 - prod_k (1 - a_k)."""
    occ = torch.cumprod(1.0 - alpha, dim=-1)
    occ_before = torch.cat([torch.ones_like(occ[..., :1]), occ[..., :-1]], -1)
    rgb = torch.sum(occ_before[..., None] * alpha[..., None] * colors, dim=-2)
    bg = occ[..., -1:]
    rgb = rgb + bg * torch.as_tensor(background_color, dtype=rgb.dtype,
                                     device=rgb.device)
    a = 1.0 - occ[..., -1]
    return torch.cat([rgb, a[..., None]], dim=-1)
