"""DTU loader (PyTorch port of dbw_tpu/data/dtu.py, reference
src/dataset/dtu.py).

The IDR layout: ``<root>/<scanXX>/image/*.png`` and ``cameras.npz`` with
``world_mat_i`` and ``scale_mat_i`` per view, the GT cloud at
``<root>/Points/stl/stlXXX_total.ply`` in millimetres, brought into the
normalized world by the inverse scale matrix. Host-side numpy; the
dataset's arrays go to the device with each batch."""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ..render.cameras import camera_from_opencv_projection
from ..utils.misc import get_files_from, path_exists, use_seed
from ..utils.obj_io import load_ply
from ..utils.path import DATASETS_PATH
from .base import IMG_EXTENSIONS, MultiViewDataset, load_image

EVAL_SCAN_IDS = [f"scan{i}" for i in [24, 31, 40, 45, 55, 59, 63, 75, 83, 105]]
RAW_IMG_SIZE = (1200, 1600)


def idr_cameras(cam, ids, raw_size):
    """(K, R, T) stacks of the views ``ids`` of an IDR ``cameras.npz``."""
    K_list, R_list, T_list = [], [], []
    for i in ids:
        P = (cam[f"world_mat_{i}"] @ cam[f"scale_mat_{i}"])[:3, :4]
        K, R, T = camera_from_opencv_projection(P, raw_size)
        K_list.append(K), R_list.append(R), T_list.append(T)
    return np.stack(K_list), np.stack(R_list), np.stack(T_list)


def load_dtu(split, img_size, tag, view_ids=None, root=None, device=None, **kwargs):
    """One DTU scan's split (``device`` is accepted for the factory; the
    arrays stay on the host)."""
    if kwargs:
        raise ValueError(f"unknown dtu dataset keys: {sorted(kwargs)}")
    root = Path(root) if root else (DATASETS_PATH / "DTU")
    data_path = path_exists(root / tag / "image")
    files = get_files_from(data_path, IMG_EXTENSIONS, recursive=True, sort=True)
    n = len(files)
    img_size = (img_size, img_size) if isinstance(img_size, int) else tuple(img_size)

    ids = list(range(n)) if (split == "test" or view_ids is None) else list(view_ids)
    if split != "train":
        # a deterministic shuffle keyed on split + tag (reference dtu.py:38-40)
        with use_seed(len(split + tag)):
            np.random.shuffle(ids)

    cam = np.load(data_path.parent / "cameras.npz")
    K, R, T = idr_cameras(cam, ids, RAW_IMG_SIZE)
    imgs = np.stack([load_image(files[i], img_size) for i in ids])

    scan_num = tag.replace("scan", "").zfill(3)
    ply_path = root / "Points" / "stl" / f"stl{scan_num}_total.ply"
    scale_mat = cam["scale_mat_0"].astype(np.float32)
    pc_gt = None
    if ply_path.exists():
        inv = np.linalg.inv(scale_mat)
        pc_gt = load_ply(ply_path) @ inv[:3, :3].T + inv[:3, 3]
    return MultiViewDataset(imgs, K, R, T, pc_gt=pc_gt, scale_mat=scale_mat,
                            tag=tag, name="dtu")
