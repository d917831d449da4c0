"""Nerfstudio capture loader (PyTorch port of dbw_tpu/data/nerfstudio.py,
reference src/dataset/nerfstudio.py; host-side numpy, like the other
loaders).

Two paths, importable without the nerfstudio package:

1. **Trained-pipeline path** (reference parity, nerfstudio.py:36,81-86):
   when the ``nerfstudio`` package is importable and a trained nerfacto run
   is found (``model_dir`` config key, or auto-discovered under
   ``<root>/outputs/<tag>/**/config.yml``), the pipeline is loaded with
   ``eval_setup`` — cameras + image list come from its datamanager and the
   pseudo-GT point cloud is *generated from the NeRF* with
   ``generate_point_cloud`` over the reference's (-4, 4) bounding box.
2. **transforms.json fallback**: the standard nerfstudio data-processing
   layout (colmap-style poses + intrinsics), with an optional pre-existing
   ``point_cloud.ply`` next to it.

Camera conversion: nerfstudio stores OpenGL-style camera-to-world (x right,
y up, z backward); the internal convention is pytorch3d-style row-vector
(x left, y up, z forward), so world-to-cam gets the reference's
``diag(-1, 1, -1)`` flip (nerfstudio.py:70-77); the conversion inverts
``ops.rotations.look_at_rotation``'s cameras (tests/test_torch_nerfstudio.py)."""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from ..utils.logger import print_log
from ..utils.misc import path_exists, use_seed
from ..utils.path import DATASETS_PATH
from ..utils.obj_io import load_ply
from .base import MultiViewDataset, load_image

# reference bounding box for NeRF point-cloud generation (nerfstudio.py:26-27)
BBOX_MIN = (-4.0, -4.0, -4.0)
BBOX_MAX = (4.0, 4.0, 4.0)

_FLIP = np.diag([-1.0, 1.0, -1.0])  # OpenGL cam -> internal (pytorch3d) cam


def _c2w_to_internal(c2w):
    """(.., 3|4, 4) OpenGL cam2world -> internal row-vector (R, T)."""
    R_c2w = np.asarray(c2w, np.float64)[:3, :3]
    t = np.asarray(c2w, np.float64)[:3, 3]
    R_wc = R_c2w.T
    t_wc = -R_wc @ t
    R_int = (_FLIP @ R_wc).T
    t_int = _FLIP @ t_wc
    return R_int.astype(np.float32), t_int.astype(np.float32)


def _ndc_K(fx, fy, cx, cy, W, H):
    s = min(H, W) / 2.0
    K = np.zeros((4, 4), np.float32)
    K[0, 0] = fx / s
    K[1, 1] = fy / s
    K[0, 2] = -(cx - W / 2.0) / s
    K[1, 2] = -(cy - H / 2.0) / s
    K[2, 3] = K[3, 2] = 1.0
    return K


def _find_model_dir(root, tag, model_dir):
    if model_dir:
        return path_exists(Path(model_dir))
    outputs = Path(root) / "outputs" / tag
    if outputs.exists():
        cfgs = sorted(outputs.glob("**/config.yml"))
        if cfgs:
            return cfgs[-1].parent  # latest run
    return None


def _load_from_pipeline(split, tag, model_dir, out_hw, downscale_factor=1,
                        n_pc_points=100_000):
    """Reference-parity path: trained nerfacto pipeline supplies cameras,
    image paths and the NeRF-generated GT point cloud."""
    from nerfstudio.utils.eval_utils import eval_setup
    from nerfstudio.exporter.exporter_utils import generate_point_cloud

    _, pipeline, _ = eval_setup(model_dir / "config.yml")
    dm = pipeline.datamanager
    dataset = dm.train_dataset if split == "train" else dm.eval_dataset
    files = list(dataset._dataparser_outputs.image_filenames)
    cams = dataset._dataparser_outputs.cameras
    n = len(files)
    view_ids = list(range(n))
    if split == "test":
        with use_seed(len(tag)):  # reference nerfstudio.py:47-49
            np.random.shuffle(view_ids)

    fx = float(np.asarray(cams.fx).reshape(-1)[0])
    fy = float(np.asarray(cams.fy).reshape(-1)[0])
    cx = float(np.asarray(cams.cx).reshape(-1)[0])
    cy = float(np.asarray(cams.cy).reshape(-1)[0])
    W = int(np.asarray(cams.width).reshape(-1)[0])
    H = int(np.asarray(cams.height).reshape(-1)[0])
    out_hw = out_hw or (H // downscale_factor, W // downscale_factor)
    K = _ndc_K(fx, fy, cx, cy, W, H)

    c2ws = np.asarray(cams.camera_to_worlds)  # (N, 3, 4)
    imgs, Ks, Rs, Ts = [], [], [], []
    for i in view_ids:
        R, T = _c2w_to_internal(c2ws[i])
        Rs.append(R)
        Ts.append(T)
        Ks.append(K)
        imgs.append(load_image(files[i], out_hw))

    pcd = generate_point_cloud(
        pipeline=pipeline, bounding_box_min=BBOX_MIN, bounding_box_max=BBOX_MAX
    )
    pc = np.asarray(pcd.points, np.float32)
    if len(pc) > n_pc_points:
        with use_seed(0):
            pc = pc[np.random.permutation(len(pc))[:n_pc_points]]
    print_log(
        f"nerfstudio[{tag}/{split}]: {n} views from trained pipeline "
        f"{model_dir}, NeRF-generated GT point cloud ({len(pc)} pts)"
    )
    return MultiViewDataset(
        np.stack(imgs), np.stack(Ks), np.stack(Rs), np.stack(Ts),
        pc_gt=pc, tag=tag, name="nerfstudio",
    )


def load_nerfstudio(split, img_size=None, tag="", downscale_factor=1,
                    root=None, model_dir=None, device=None, **kwargs):
    """One split of the capture ``<root>/<tag>`` (``device`` is accepted for
    the factory; the arrays stay on the host). The val split is empty."""
    kwargs.pop("view_ids", None)
    if kwargs:
        raise ValueError(f"unknown nerfstudio dataset keys: {sorted(kwargs)}")
    # Path() so a YAML-config string root works (cfg['dataset']['root'])
    root = Path(root) if root else (DATASETS_PATH / "nerfstudio")

    if split == "val":
        # reference: empty val split (nerfstudio.py:88-89)
        H2, W2 = img_size or (1, 1)
        pc_path = path_exists(root / tag) / "point_cloud.ply" if (
            (root / tag).exists()
        ) else None
        pc = load_ply(pc_path) if pc_path and pc_path.exists() else None
        return MultiViewDataset(
            np.zeros((0, H2, W2, 3), np.float32),
            np.zeros((0, 4, 4), np.float32),
            np.zeros((0, 3, 3), np.float32), np.zeros((0, 3), np.float32),
            pc_gt=pc, tag=tag, name="nerfstudio",
        )

    found = _find_model_dir(root, tag, model_dir)
    if found is not None:
        try:
            return _load_from_pipeline(
                split, tag, found, img_size, downscale_factor
            )
        except ImportError:
            print_log(
                f"nerfstudio package not installed: found trained run "
                f"{found} but falling back to transforms.json for {tag}"
            )

    base = path_exists(root / tag)
    meta = json.loads((base / "transforms.json").read_text())

    W, H = int(meta["w"]), int(meta["h"])
    out_hw = (
        (H // downscale_factor, W // downscale_factor)
        if img_size is None else tuple(img_size)
    )
    K_ndc = _ndc_K(meta["fl_x"], meta["fl_y"], meta["cx"], meta["cy"], W, H)

    frames = sorted(meta["frames"], key=lambda f: f["file_path"])
    view_ids = list(range(len(frames)))
    if split == "test":
        with use_seed(len(tag)):  # reference's seeded test shuffle
            np.random.shuffle(view_ids)

    imgs, K_list, R_list, T_list = [], [], [], []
    for i in view_ids:
        fr = frames[i]
        R_int, t_int = _c2w_to_internal(
            np.asarray(fr["transform_matrix"], np.float64)
        )
        R_list.append(R_int)
        T_list.append(t_int)
        K_list.append(K_ndc)
        imgs.append(load_image(base / fr["file_path"], out_hw))

    pc_path = base / "point_cloud.ply"
    pc = load_ply(pc_path) if pc_path.exists() else None
    return MultiViewDataset(
        np.stack(imgs), np.stack(K_list), np.stack(R_list), np.stack(T_list),
        pc_gt=pc, tag=tag, name="nerfstudio",
    )
