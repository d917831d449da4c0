"""Superquadric surface and implicit field (PyTorch port of
dbw_tpu/ops/superquadric.py), on the gradient-safe powers of ``safe_math``.
"""

import torch

from .safe_math import safe_pow, signed_pow


def parametric_sq(eta, omega, eps1, eps2):
    """Superquadric surface point for spherical angles eta in [-pi/2, pi/2],
    omega in [-pi, pi]; eps broadcast against them. Returns (..., 3)."""
    ce, se = signed_pow(torch.cos(eta), eps1), signed_pow(torch.sin(eta), eps1)
    co, so = signed_pow(torch.cos(omega), eps2), signed_pow(torch.sin(omega), eps2)
    ce, se, co, so = torch.broadcast_tensors(ce, se, co, so)
    return torch.stack([ce * so, se, ce * co], dim=-1)


def implicit_sq(points, eps1=1.0, eps2=1.0, as_sdf=False):
    """Inside-outside function F(x) - 1, or a pseudo-SDF.

    Valid for eps in [0.1, 2]; points are clamped to [-5, 5] and the even
    powers are taken as (x^2)^(1/eps), as in the reference.
    as_sdf=False -> F - 1; True -> radial distance; 2 -> F**(eps1/2) - 1."""
    points = torch.clamp(points, -5.0, 5.0)
    x2 = points[..., 0] ** 2
    y2 = points[..., 1] ** 2
    z2 = points[..., 2] ** 2
    x = safe_pow(x2, 1.0 / eps2)
    y = safe_pow(y2, 1.0 / eps1)
    z = safe_pow(z2, 1.0 / eps2)
    res = safe_pow(x + z, eps2 / eps1) + y
    if as_sdf:
        if as_sdf is True:
            r = torch.linalg.vector_norm(points, dim=-1)
            return r * (1.0 - 1.0 / (safe_pow(res, eps1 / 2.0) + 1e-6))
        return safe_pow(res, eps1 / 2.0) - 1.0
    return res - 1.0


def sample_sq(eps1, eps2, scale, n_points, generator=None):
    """Random (non-uniform) surface samples, drawn from ``generator``. The
    axis order differs from parametric_sq as in the reference (z = sin eta;
    src/utils/superquadric.py:50-57). eps1/eps2: (N, 1), scale: (N, 3).
    Returns (N, n_points, 3)."""
    n = eps1.shape[0]
    dev = eps1.device
    eta = (torch.rand((n, n_points), generator=generator, device=dev)
           * torch.pi - torch.pi / 2)
    omega = (torch.rand((n, n_points), generator=generator, device=dev)
             * 2 * torch.pi - torch.pi)
    ce, se = signed_pow(torch.cos(eta), eps1), signed_pow(torch.sin(eta), eps1)
    co, so = signed_pow(torch.cos(omega), eps2), signed_pow(torch.sin(omega), eps2)
    points = torch.stack([ce * so, ce * co, se], dim=-1)
    return points * scale[:, None]

