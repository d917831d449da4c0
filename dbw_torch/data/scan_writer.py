"""Write a scene as a capture in a dataset's layout (no real scan or
capture is in the repository): a nerfstudio capture as ``load_nerfstudio``
reads it (``write_nerfstudio_capture``), or a DTU scan in the IDR layout,
the layout ``load_dtu`` and the official protocol read:

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


_GL_FLIP = np.diag([-1.0, 1.0, -1.0])  # internal (pytorch3d) cam <-> OpenGL cam


def write_nerfstudio_capture(root, tag, imgs, K_ndc, R, T, points=None):
    """Write capture ``tag`` under ``root`` in nerfstudio's processed-data
    layout: ``images/frame_XXXXX.png`` from ``imgs`` (N, H, W, 3) in [0,
    1], ``transforms.json`` with the pixel intrinsics ``fl_x fl_y cx cy w
    h`` of the NDC ``K_ndc`` (4, 4) and each view's OpenGL camera-to-world
    ``transform_matrix`` of the internal (R, T), and, with ``points`` (P,
    3), ``point_cloud.ply``. The inverse of ``load_nerfstudio``'s
    conversions. Returns the capture directory."""
    import json

    base = Path(root) / tag
    (base / "images").mkdir(parents=True, exist_ok=True)
    imgs = np.asarray(imgs)
    H, W = imgs.shape[1:3]
    s = min(H, W) / 2.0
    K = np.asarray(K_ndc, np.float64)
    frames = []
    for i, img in enumerate(imgs):
        name = f"images/frame_{i:05d}.png"
        Image.fromarray((np.clip(img, 0, 1) * 255 + 0.5).astype(np.uint8)).save(base / name)
        R_wc = _GL_FLIP @ np.asarray(R[i], np.float64).T  # world -> OpenGL cam
        t_wc = _GL_FLIP @ np.asarray(T[i], np.float64)
        c2w = np.eye(4)
        c2w[:3, :3] = R_wc.T
        c2w[:3, 3] = -R_wc.T @ t_wc
        frames.append({"file_path": name, "transform_matrix": c2w.tolist()})
    meta = {"fl_x": K[0, 0] * s, "fl_y": K[1, 1] * s,
            "cx": W / 2.0 - K[0, 2] * s, "cy": H / 2.0 - K[1, 2] * s,
            "w": int(W), "h": int(H), "frames": frames}
    (base / "transforms.json").write_text(json.dumps(meta))
    if points is not None:
        save_ply(base / "point_cloud.ply", np.asarray(points, np.float32))
    return base
