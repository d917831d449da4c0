"""Rotation parameterizations (PyTorch port of dbw_tpu/ops/rotations.py).

Matrices act on ROW vectors, ``x' = x @ R``. The numpy helpers build host
constants (the world frame, the initial block rotations) with the same
float32 arithmetic as the JAX package, so seeded inits replay bit for bit.
"""

import numpy as np
import torch


def rotation_6d_to_matrix(d6):
    """6D -> 3x3 by Gram-Schmidt; rows are the two orthonormalized vectors
    and their cross product ([1,0,0,0,1,0] gives the identity)."""
    a1, a2 = d6[..., :3], d6[..., 3:]
    b1 = a1 / torch.linalg.vector_norm(a1, dim=-1, keepdim=True).clamp(min=1e-12)
    a2p = a2 - torch.sum(b1 * a2, dim=-1, keepdim=True) * b1
    b2 = a2p / torch.linalg.vector_norm(a2p, dim=-1, keepdim=True).clamp(min=1e-12)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-2)


def matrix_to_rotation_6d(R):
    return torch.cat([R[..., 0, :], R[..., 1, :]], dim=-1)


def quaternion_to_matrix_np(q):
    """Unit quaternion (w, x, y, z) -> rotation matrix (row-vector action),
    numpy float32."""
    q = np.asarray(q, np.float32)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    two = np.float32(2.0)
    one = np.float32(1.0)
    m = np.stack(
        [
            one - two * (y * y + z * z), two * (x * y + z * w), two * (x * z - y * w),
            two * (x * y - z * w), one - two * (x * x + z * z), two * (y * z + x * w),
            two * (x * z + y * w), two * (y * z - x * w), one - two * (x * x + y * y),
        ],
        axis=-1,
    )
    return m.reshape(q.shape[:-1] + (3, 3)).astype(np.float32)


def random_rotations(n, rng: np.random.Generator):
    """N uniform random rotations from normalized Gaussian quaternions drawn
    from a numpy Generator (host init path)."""
    q = rng.standard_normal((n, 4)).astype(np.float32)
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    return quaternion_to_matrix_np(q)


def _axis_rot_np(a, kind):
    c, s = np.cos(a), np.sin(a)
    z, o = np.zeros_like(c), np.ones_like(c)
    rows = {
        "azim": [c, z, s, z, o, z, -s, z, c],
        "elev": [o, z, z, z, c, s, z, -s, c],
        "roll": [c, s, z, -s, c, z, z, z, o],
    }[kind]
    return np.stack(rows, axis=-1).reshape(a.shape + (3, 3)).astype(np.float32)


def euler_world_matrix(elev_deg, azim_deg, roll_deg):
    """World-frame rotation elev @ azim @ roll from the config's
    ``R_world: [elev, azim, roll]`` (numpy float32)."""
    deg = lambda v: np.deg2rad(np.asarray(v, np.float32)).astype(np.float32)
    E = _axis_rot_np(-deg(elev_deg), "elev")
    A = _axis_rot_np(deg(azim_deg), "azim")
    Rr = _axis_rot_np(deg(roll_deg), "roll")
    return (E @ A @ Rr).astype(np.float32)


def look_at_rotation(dist, elev_deg, azim_deg):
    """Camera (R, T) looking at the origin from spherical coordinates
    (pytorch3d look_at_view_transform convention). Returns float32 tensors
    R (..., 3, 3) with row-vector action and T (..., 3)."""
    elev = torch.deg2rad(torch.as_tensor(elev_deg, dtype=torch.float32))
    azim = torch.deg2rad(torch.as_tensor(azim_deg, dtype=torch.float32))
    elev, azim = torch.broadcast_tensors(elev, azim)
    x = dist * torch.cos(elev) * torch.sin(azim)
    y = dist * torch.sin(elev)
    z = dist * torch.cos(elev) * torch.cos(azim)
    eye = torch.stack([x, y, z], dim=-1)
    up = torch.tensor([0.0, 1.0, 0.0]).expand(eye.shape)
    z_axis = -eye
    z_axis = z_axis / torch.linalg.vector_norm(
        z_axis, dim=-1, keepdim=True).clamp(min=1e-12)
    x_axis = torch.linalg.cross(up, z_axis, dim=-1)
    x_norm = torch.linalg.vector_norm(x_axis, dim=-1, keepdim=True)
    x_axis = torch.where(
        x_norm > 1e-5, x_axis / x_norm.clamp(min=1e-12),
        torch.tensor([1.0, 0.0, 0.0]).expand(eye.shape),
    )
    y_axis = torch.linalg.cross(z_axis, x_axis, dim=-1)
    R = torch.stack([x_axis, y_axis, z_axis], dim=-1)
    T = -torch.einsum("...i,...ij->...j", eye, R)
    return R, T
