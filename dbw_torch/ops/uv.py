"""Spherical UV atlases with seam/pole fixing (host-side numpy).

A sphere unwrapped with the equirectangular map has two defects that the
reference fixes by rewriting the face->uv topology (reference:
src/utils/mesh.py:127-169):

1. *seam continuity*: faces that straddle the u = 0/1 seam would interpolate
   across the whole texture; each such face gets duplicate uv-verts shifted
   by +-1 so all three corners sit on the same side,
2. *pole distortion*: faces touching v ~ 0/1 get a new uv-vert at the pole
   whose u is centered between the two non-pole corners.

The resulting uv coordinates extend slightly outside [0, 1] in u; the model
then computes a circular texture padding (p_left, p_right) and rescales u
into [0, 1] of the padded atlas (reference: src/model/dbw.py:88-96). That
padding is what makes the texture seam-continuous under bilinear sampling
and is load-bearing for the seam-aware TV loss.

Everything runs at init on host; outputs are plain arrays.
"""

import numpy as np

__all__ = [
    "spherical_uv_from_points",
    "points_from_spherical_uv",
    "icosphere_uv_atlas",
    "pad_u_atlas",
    "cube_uv_atlas",
]


def spherical_uv_from_points(x, eps=1e-7, normalize=True):
    """Points -> equirectangular uv in [0,1]^2; v measures the angle from -Y
    (reference: src/utils/mesh.py:78-89)."""
    x = np.asarray(x, dtype=np.float64)
    if normalize:
        r = np.linalg.norm(x, axis=-1).clip(eps)
        y = np.clip(x[..., 1] / r, -1 + eps, 1 - eps)
    else:
        y = x[..., 1]
    theta = np.arccos(-y)
    phi = np.arctan2(x[..., 0], x[..., 2])
    return np.stack([(phi + np.pi) / (2 * np.pi), theta / np.pi], axis=-1).astype(
        np.float32
    )


def points_from_spherical_uv(uv, radius=1.0, half_sphere=False):
    """Inverse map (reference: src/utils/mesh.py:92-101)."""
    uv = np.asarray(uv, dtype=np.float64)
    phi = np.pi * (uv[..., 0] * 2 - 1)
    theta = np.pi * uv[..., 1]
    if half_sphere:
        theta = theta / 2
    z = np.sin(theta) * np.cos(phi)
    x = np.sin(theta) * np.sin(phi)
    y = -np.cos(theta)
    return (np.stack([x, y, z], axis=-1) * radius).astype(np.float32)


def icosphere_uv_atlas(verts, faces, fix_continuity=True, fix_poles=True, eps=1e-8):
    """Build (faces_uvs, verts_uvs) for an icosphere with seam and pole fixes.

    Same defect-repair semantics as the reference (src/utils/mesh.py:127-169)
    but recomputed from first principles:

    - a face is seam-crossing when its corners' u values differ by > 0.5;
      the minority-side corner(s) get duplicated uv-verts moved by the sign
      of the majority side (u +- 1),
    - a face is polar when any corner has v > 0.99 or v < 0.01; the polar
      corner(s) get a duplicated uv-vert whose u is the half-sum of the
      non-polar corners' u.

    Returns int32 (F, 3) uv-face indices and float32 (V', 2) uv-verts; u may
    lie slightly outside [0, 1] (handled by `pad_u_atlas`).
    """
    verts_uvs = spherical_uv_from_points(verts)
    faces_uvs = np.asarray(faces, dtype=np.int64).copy()

    if fix_continuity:
        fu = verts_uvs[faces_uvs]  # (F, 3, 2)
        u = fu[..., 0]
        spread = np.abs(np.diff(np.concatenate([u, u[:, :1]], axis=1), axis=1)).max(1)
        bad = spread > 0.5
        if bad.any():
            ub = u[bad] - 0.5 + eps
            side = np.sign(ub).sum(axis=1)  # which half 2-of-3 corners sit on
            minority = np.sign(ub) != side[:, None]
            new_u = u[bad] + side[:, None] * minority  # move minority by +-1
            add_uvs = np.stack(
                [new_u[minority], fu[bad][..., 1][minority]], axis=-1
            )
            base = len(verts_uvs)
            verts_uvs = np.concatenate([verts_uvs, add_uvs.astype(np.float32)])
            fixed = faces_uvs[bad]
            fixed[minority] = base + np.arange(minority.sum())
            faces_uvs[bad] = fixed

    if fix_poles:
        fu = verts_uvs[faces_uvs]
        v = fu[..., 1]
        bad = np.logical_or(v.max(1) > 0.99, v.min(1) < 0.01)
        if bad.any():
            vb = v[bad]
            polar = np.logical_or(vb > 0.99, vb < 0.01)
            u_center = ((1 - polar.astype(np.float64)) * fu[bad][..., 0]).sum(1) / 2
            # one new uv-vert per polar corner occurrence, u centered
            n_polar_per_face = polar.sum(1)
            u_rep = np.repeat(u_center, n_polar_per_face)
            add_uvs = np.stack([u_rep, vb[polar]], axis=-1)
            base = len(verts_uvs)
            verts_uvs = np.concatenate([verts_uvs, add_uvs.astype(np.float32)])
            fixed = faces_uvs[bad]
            fixed[polar] = base + np.arange(polar.sum())
            faces_uvs[bad] = fixed

    return faces_uvs.astype(np.int32), verts_uvs.astype(np.float32)


def pad_u_atlas(verts_uvs, txt_size):
    """Compute the circular texture padding and rescale u into the padded
    atlas (reference: src/model/dbw.py:89-93).

    Returns (verts_uvs', (p_left, p_right)); the model pads its (TS, TS)
    texture maps to (TS, p_left + TS + p_right) with wrap-around columns at
    sampling time so bilinear lookups are seam-continuous."""
    u = verts_uvs[..., 0]
    p_left = abs(int(np.floor(u.min() * txt_size)))
    p_right = int(np.ceil((u.max() - 1) * txt_size))
    new_u = (u * txt_size + p_left) / (txt_size + p_left + p_right)
    out = np.stack([new_u, verts_uvs[..., 1]], axis=-1).astype(np.float32)
    return out, (p_left, p_right)


def cube_uv_atlas():
    """Cross-layout uv atlas for the 12-tri cube (reference:
    src/utils/mesh.py:176-207)."""
    faces_uvs = np.array(
        [
            [1, 3, 0], [7, 5, 4], [4, 9, 8], [11, 2, 10], [2, 7, 3], [12, 7, 13],
            [1, 2, 3], [7, 6, 5], [4, 5, 9], [11, 6, 2], [2, 6, 7], [12, 3, 7],
        ],
        dtype=np.int32,
    )
    verts_uvs = np.array(
        [
            [0.0, 3 / 8], [0.0, 5 / 8], [0.25, 5 / 8], [0.25, 3 / 8],
            [0.75, 3 / 8], [0.75, 5 / 8], [0.5, 5 / 8], [0.5, 3 / 8],
            [1.0, 3 / 8], [1.0, 5 / 8], [0.25, 7 / 8], [0.5, 7 / 8],
            [0.25, 1 / 8], [0.5, 1 / 8],
        ],
        dtype=np.float32,
    )
    return faces_uvs, verts_uvs
