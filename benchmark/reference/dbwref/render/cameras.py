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
    """Pinhole intrinsics in NDC units: python floats shared across views
    (the default), or (B, 1) float32 tensors, one row per view, that
    broadcast against the views' (B, V) coordinates (``view_camera``: the
    batched (scene, seed) program, where each scene has its own
    intrinsics)."""

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


def view_camera(cams, n_views, device=None):
    """One Camera of (sum(n_views), 1) float32 tensors: ``cams[i]`` for
    each of the next ``n_views[i]`` views."""
    col = lambda f: torch.tensor(np.repeat([getattr(c, f) for c in cams], n_views),
                                 dtype=torch.float32, device=device)[:, None]
    return Camera(*(col(f) for f in Camera._fields))


def world_to_view(verts, R, T):
    """(..., V, 3) @ (..., 3, 3) + (..., 1, 3) -> view-space points. Slots:
    verts (S, V, 3) seen by S * B views R (S * B, 3, 3), T (S * B, 3), slot
    s by views s * B .. s * B + B - 1 -> (S * B, V, 3)."""
    if verts.ndim == 3:
        verts = verts.repeat_interleave(R.shape[0] // verts.shape[0], dim=0)
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


def ndc_pixel_centers(image_size, device=None, row_range=None):
    """NDC x of each pixel column (W,) and y of each pixel row (H,), float32
    (the CUDA selection kernel evaluates the same expression, bit for bit).

    ``row_range=(row0, Hb)``: y of the Hb rows from row0 only, in the full
    image's coordinates, so a band's pixels get the full image's values
    bit for bit; rows past the image's last are allowed."""
    H, W = image_size
    s = min(H, W)
    # float64, rounded once to float32: the correctly rounded float32
    # quotient on every device, as the kernel's division gives it (on CUDA,
    # PyTorch divides a tensor by a python scalar as a multiply by its
    # reciprocal, which is off by an ulp at a quarter of the columns)
    f64 = dict(dtype=torch.float64, device=device)
    j = torch.arange(W, **f64)
    i = torch.arange(H, **f64) if row_range is None else (
        float(row_range[0]) + torch.arange(row_range[1], **f64))
    return (((W - 1.0 - 2.0 * j) / s).to(torch.float32),
            ((H - 1.0 - 2.0 * i) / s).to(torch.float32))


# -- host-side conversions of the dataset loaders (numpy) --------------------


def decompose_projection(P):
    """3x4 projection matrix -> OpenCV (K 4x4, R 3x3, T 3), numpy: an RQ
    decomposition (through a QR of the flipped transpose), K's diagonal made
    positive; R is returned transposed and T is the camera centre, the
    reference's convention (its cv2 decomposition)."""
    P = np.asarray(P, dtype=np.float64)
    M = P[:3, :3]
    rev = np.eye(3)[::-1]
    q, r = np.linalg.qr((rev @ M).T)
    K = rev @ r.T @ rev
    R = rev @ q.T
    sgn = np.sign(np.diag(K))
    sgn[sgn == 0] = 1.0
    D = np.diag(sgn)
    K = K @ D
    R = D @ R
    if np.linalg.det(R) < 0:
        K = -K
        R = -R
    c = -np.linalg.inv(M) @ P[:3, 3]  # the camera centre
    K4 = np.eye(4, dtype=np.float32)
    K4[:3, :3] = (K / K[2, 2]).astype(np.float32)
    return K4, R.T.astype(np.float32), c.astype(np.float32)


def camera_from_opencv_projection(P, image_size_hw):
    """3x4 P (pixels, OpenCV convention) -> (K_ndc 4x4, R, T) in the
    internal convention: world->camera inversion, the x and y flips of the
    screen orientation, pixel->NDC rescale of K."""
    K, R, T = decompose_projection(P)
    # dataset convention: x_world = R @ x_cam + T -> x_cam = R.T (x_world - T)
    R = R.T
    T = -R @ T

    H, W = image_size_hw
    s = min(H, W) / 2.0
    cx, cy = W / 2.0, H / 2.0
    K_ndc = np.zeros((4, 4), dtype=np.float32)
    K_ndc[0, 0], K_ndc[1, 1] = K[0, 0] / s, K[1, 1] / s
    K_ndc[0, 2], K_ndc[1, 2] = -(K[0, 2] - cx) / s, -(K[1, 2] - cy) / s
    K_ndc[2, 3] = 1.0
    K_ndc[3, 2] = 1.0

    R_out = R.T.copy()  # row-vector convention
    T_out = T.copy()
    R_out[:, :2] *= -1
    T_out[:2] *= -1
    return K_ndc, R_out.astype(np.float32), T_out.astype(np.float32)


def opencv_projection_from_camera(K_ndc, R, T, image_size_hw):
    """The inverse of ``camera_from_opencv_projection``: (K_ndc 4x4, R, T)
    of the internal convention -> the 3x4 OpenCV projection in pixels of an
    image of ``image_size_hw``, float64."""
    K_ndc = np.asarray(K_ndc, np.float64)
    H, W = image_size_hw
    s = min(H, W) / 2.0
    K = np.array([[K_ndc[0, 0] * s, 0.0, W / 2.0 - K_ndc[0, 2] * s],
                  [0.0, K_ndc[1, 1] * s, H / 2.0 - K_ndc[1, 2] * s],
                  [0.0, 0.0, 1.0]])
    R_cv = np.array(R, np.float64)
    T_cv = np.array(T, np.float64)
    R_cv[:, :2] *= -1  # undo the screen-orientation flips
    T_cv[:2] *= -1
    return K @ np.concatenate([R_cv.T, T_cv[:, None]], axis=1)
