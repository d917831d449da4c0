"""Camera model (PyTorch port of dbw_tpu/render/cameras.py).

Convention (PyTorch3D NDC): world -> view is the row-vector action
``x_view = x_world @ R + T``, the camera looks along +Z with +X left and +Y
up; ``x_ndc = fx * x / z + px`` with the short image side spanning [-1, 1];
pixel (row i, col j) sits at ``((W - 1 - 2j) / S, (H - 1 - 2i) / S)``,
``S = min(H, W)``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class Camera(NamedTuple):
    """Pinhole intrinsics in NDC units, shared across views (python floats)."""

    fx: float
    fy: float
    px: float
    py: float

    @staticmethod
    def from_K_ndc(K):
        """From a 4x4 NDC K; values are rounded to float32 like the JAX
        camera's scalars."""
        f32 = lambda v: float(np.float32(v))
        return Camera(f32(K[0][0]), f32(K[1][1]), f32(K[0][2]), f32(K[1][2]))


def world_to_view(verts, R, T):
    """(..., V, 3) @ (..., 3, 3) + (..., 1, 3) -> view-space points."""
    return verts @ R + T[..., None, :]


def view_to_ndc(v_view, cam: Camera, eps=1e-8):
    """View-space points -> (x_ndc, y_ndc, z_view); z is clamped away from
    zero with its sign kept."""
    z = v_view[..., 2]
    z_safe = torch.where(z.abs() < eps,
                         torch.where(z < 0, -eps, eps).to(z.dtype), z)
    x = cam.fx * v_view[..., 0] / z_safe + cam.px
    y = cam.fy * v_view[..., 1] / z_safe + cam.py
    return torch.stack([x, y, z], dim=-1)


def ndc_pixel_centers(image_size, device=None):
    """NDC x of each pixel column (W,) and y of each pixel row (H,), float32
    (the CUDA selection kernel evaluates the same expression)."""
    H, W = image_size
    s = min(H, W)
    j = torch.arange(W, dtype=torch.float32, device=device)
    i = torch.arange(H, dtype=torch.float32, device=device)
    return (W - 1.0 - 2.0 * j) / s, (H - 1.0 - 2.0 * i) / s
