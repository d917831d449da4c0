"""Write a scene as a DTU scan in the IDR layout, the layout ``load_dtu``
and the official protocol read (no real scan is in the repository):

    <root>/<scanXX>/image/000000.png ...
    <root>/<scanXX>/cameras.npz          world_mat_i, scale_mat_i
    <root>/Points/stl/stlXXX_total.ply   GT points in millimetres
    <root>/ObsMask/ObsMaskXX_10.mat      ObsMask, BB, Res
    <root>/ObsMask/PlaneXX.mat           P (the GT keeps P . [x, 1] > 0)

The views are given in the normalized world of the port's cameras; each
``world_mat_i`` is chosen so that ``world_mat_i @ scale_mat`` is that
camera's projection at DTU's raw 1200x1600 pixels, and the points are
written in the millimetre world of ``scale_mat``."""

from __future__ import annotations

from pathlib import Path

import numpy as np
from PIL import Image

from ..render.cameras import opencv_projection_from_camera
from ..utils.obj_io import save_ply
from .dtu import RAW_IMG_SIZE


# the ObsMask grid: the GT's bounding box plus a margin, in cubic cells of
# the smallest size that keeps the uint8 grid within OBS_MAX_CELLS bytes
OBS_MARGIN_MM = 20.0
OBS_MAX_CELLS = 32 * 2**20


def write_idr_scan(root, scan_id, imgs, K_ndc, R, T, scale_mat, points=None):
    """Write scan ``scan_id`` under ``root``: ``imgs`` (N, H, W, 3) in [0,
    1], the views' internal cameras (K_ndc (4, 4) or (N, 4, 4), R (N, 3, 3),
    T (N, 3)), ``scale_mat`` (4, 4); with ``points`` (P, 3) in the
    normalized world, the GT cloud, an all-observed ObsMask over it and a
    ground plane below it. Returns the scan directory."""
    from scipy.io import savemat

    root = Path(root)
    scan = root / f"scan{scan_id}"
    (scan / "image").mkdir(parents=True, exist_ok=True)
    S = np.asarray(scale_mat, np.float64)
    S_inv = np.linalg.inv(S)
    K_ndc = np.asarray(K_ndc)
    cams = {}
    for i, img in enumerate(np.asarray(imgs)):
        Image.fromarray((np.clip(img, 0, 1) * 255 + 0.5).astype(np.uint8)).save(
            scan / "image" / f"{i:06d}.png")
        Ki = K_ndc if K_ndc.ndim == 2 else K_ndc[i]
        world = np.eye(4)
        world[:3] = opencv_projection_from_camera(Ki, R[i], T[i], RAW_IMG_SIZE)
        cams[f"world_mat_{i}"] = world @ S_inv
        cams[f"scale_mat_{i}"] = S
    np.savez(scan / "cameras.npz", **cams)
    if points is None:
        return scan

    pts = np.asarray(points, np.float64) @ S[:3, :3].T + S[:3, 3]  # in mm
    (root / "Points" / "stl").mkdir(parents=True, exist_ok=True)
    save_ply(root / "Points" / "stl" / f"stl{scan_id:03}_total.ply", pts)
    lo, hi = pts.min(0) - OBS_MARGIN_MM, pts.max(0) + OBS_MARGIN_MM
    obs_res = float(np.cbrt(np.prod(hi - lo) / OBS_MAX_CELLS)) * 1.01
    shape = tuple(int(n) for n in np.ceil((hi - lo) / obs_res).astype(int) + 1)
    (root / "ObsMask").mkdir(parents=True, exist_ok=True)
    savemat(root / "ObsMask" / f"ObsMask{scan_id}_10.mat",
            {"ObsMask": np.ones(shape, np.uint8), "BB": np.stack([lo, hi]),
             "Res": np.array([[obs_res]])})
    # a plane below the cloud along the scan's y axis keeps every GT point
    savemat(root / "ObsMask" / f"Plane{scan_id}.mat",
            {"P": np.array([[0.0], [1.0], [0.0], [-(lo[1] - 1.0)]])})
    return scan
