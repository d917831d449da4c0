"""BlendedMVS loader (PyTorch port of dbw_tpu/data/bmvs.py, reference
src/dataset/bmvs.py): DTU's IDR camera layout at 576x768, no GT cloud, the
val split capped at 5 views and the test split at 10."""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ..utils.misc import get_files_from, path_exists
from ..utils.path import DATASETS_PATH
from .base import IMG_EXTENSIONS, MultiViewDataset, load_image
from .dtu import idr_cameras

RAW_IMG_SIZE = (576, 768)


def load_bmvs(split, img_size, tag, view_ids=None, root=None, device=None, **kwargs):
    """One BlendedMVS scene's split (``device`` is accepted for the factory;
    the arrays stay on the host)."""
    if kwargs:
        raise ValueError(f"unknown bmvs dataset keys: {sorted(kwargs)}")
    root = Path(root) if root else (DATASETS_PATH / "BlendedMVS")
    data_path = path_exists(root / tag / "image")
    files = get_files_from(data_path, IMG_EXTENSIONS, recursive=True, sort=True)
    img_size = (img_size, img_size) if isinstance(img_size, int) else tuple(img_size)
    ids = list(view_ids) if view_ids is not None else list(range(len(files)))
    if split == "val":
        ids = ids[: min(5, len(ids))]
    elif split == "test":
        ids = ids[: min(10, len(ids))]

    cam = np.load(data_path.parent / "cameras.npz")
    K, R, T = idr_cameras(cam, ids, RAW_IMG_SIZE)
    imgs = np.stack([load_image(files[i], img_size) for i in ids])
    return MultiViewDataset(imgs, K, R, T, pc_gt=None, tag=tag, name="bmvs")
