"""The benchmark's input scans: written from ``--seed`` in the layout that
the configuration's ``scan.layout`` names, and read back on their own for
the plain reference. ``write(config, root, seed)`` and ``read(config,
scan_dir)`` choose by it:

``idr`` (the port's DTU and BlendedMVS loaders)::

    <root>/<tag>/image/000000.png ...
    <root>/<tag>/cameras.npz          world_mat_i, scale_mat_i

``nerfstudio`` (the port's nerfstudio loader; nerfstudio's processed-data
layout)::

    <root>/<tag>/images/frame_00000.png ...
    <root>/<tag>/transforms.json      fl_x fl_y cx cy w h, and per frame
                                      file_path, transform_matrix

The views are smooth colour fields (a few low-frequency waves per channel,
so that the PNGs stay small) seen from cameras on an arc around the scene:
distance 3, elevation 25 degrees, azimuth from -40 to 40 degrees, each
jittered from the seed. Every seed gives the same number of views at the
same sizes. The camera is the configuration's ``scan.intrinsics``
(``fl_x fl_y cx cy`` in pixels of the raw frame, as a ``transforms.json``
holds them) where it has them, else ``K_NDC``. IDR: ``world_mat_i @
scale_mat_i`` is the view's OpenCV projection at the raw image size (the
port's ``data/scan_writer.py`` format). Nerfstudio: ``w h`` are the raw
size, the PNGs are written at ``raw_size // downscale_factor`` (so the
loader does not resample them), and each ``transform_matrix`` is the
view's OpenGL camera-to-world. The code here imports nothing of the port.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch
from PIL import Image

from .reference.dbwref.ops.rotations import look_at_rotation
from .reference.dbwref.render.cameras import (camera_from_opencv_projection,
                                              opencv_projection_from_camera)

# DTU-like intrinsics in the port's NDC convention (those of the port's
# bench twin and of __graft_entry__)
K_NDC = np.zeros((4, 4), np.float32)
K_NDC[0, 0], K_NDC[1, 1] = 2.8, 2.1
K_NDC[0, 2] = K_NDC[1, 2] = 0.02
K_NDC[2, 3] = K_NDC[3, 2] = 1.0
N_WAVES = 4
JITTER_DEG = 2.0


def views(seed, n_views, size):
    """(imgs (N, H, W, 3) float32 in [0, 1], R (N, 3, 3), T (N, 3)) of
    ``n_views`` views of ``size`` from ``seed``."""
    rng = np.random.default_rng([int(seed), 7])
    H, W = size
    y, x = np.meshgrid(np.linspace(0, 1, H, dtype=np.float32),
                       np.linspace(0, 1, W, dtype=np.float32), indexing="ij")
    freq = rng.uniform(0.5, 3.0, (n_views, 3, N_WAVES, 2)).astype(np.float32)
    phase = rng.uniform(0, 2 * np.pi, (n_views, 3, N_WAVES)).astype(np.float32)
    base = rng.uniform(0.3, 0.7, (n_views, 3)).astype(np.float32)
    imgs = np.empty((n_views, H, W, 3), np.float32)
    for i in range(n_views):
        for c in range(3):
            f = freq[i, c]
            arg = (2 * np.pi * (f[:, 0, None, None] * x + f[:, 1, None, None] * y)
                   + phase[i, c][:, None, None])
            imgs[i, :, :, c] = base[i, c] + 0.25 / N_WAVES * np.sin(arg).sum(0)
    azim = np.linspace(-40.0, 40.0, n_views) + rng.uniform(-JITTER_DEG, JITTER_DEG, n_views)
    elev = 25.0 + rng.uniform(-JITTER_DEG, JITTER_DEG, n_views)
    R, T = look_at_rotation(3.0, torch.tensor(elev, dtype=torch.float32),
                            torch.tensor(azim, dtype=torch.float32))
    return np.clip(imgs, 0.0, 1.0), R.numpy(), T.numpy()


def scale_mat(seed):
    """A DTU-like world normalization (millimetres to the unit sphere)."""
    rng = np.random.default_rng([int(seed), 11])
    S = np.eye(4)
    S[:3, :3] *= 200.0
    S[:3, 3] = rng.uniform(-50.0, 50.0, 3)
    return S


def ndc_from_pixels(intrinsics, raw_size):
    """The NDC K (4, 4) float32 of pixel intrinsics ``{fl_x, fl_y, cx,
    cy}`` of a frame of ``raw_size`` (H, W): the short side spans [-1, 1],
    the principal point's offset from the frame's centre flips with x and
    y."""
    H, W = raw_size
    s = min(H, W) / 2.0
    K = np.zeros((4, 4), np.float32)
    K[0, 0] = intrinsics["fl_x"] / s
    K[1, 1] = intrinsics["fl_y"] / s
    K[0, 2] = -(intrinsics["cx"] - W / 2.0) / s
    K[1, 2] = -(intrinsics["cy"] - H / 2.0) / s
    K[2, 3] = K[3, 2] = 1.0
    return K


def pixels_from_ndc(K, raw_size):
    """The inverse of ``ndc_from_pixels``: {fl_x, fl_y, cx, cy} in pixels
    of a frame of ``raw_size``."""
    H, W = raw_size
    s = min(H, W) / 2.0
    K = np.asarray(K, np.float64)
    return {"fl_x": K[0, 0] * s, "fl_y": K[1, 1] * s,
            "cx": W / 2.0 - K[0, 2] * s, "cy": H / 2.0 - K[1, 2] * s}


def camera(config):
    """The scan's NDC K at its raw size: the configuration's
    ``scan.intrinsics``, else ``K_NDC``."""
    sc = config["scan"]
    if "intrinsics" not in sc:
        return K_NDC
    return ndc_from_pixels(sc["intrinsics"], tuple(sc["raw_size"]))


def render_size(config):
    """The size the program renders at: the dataset's ``img_size`` where the
    configuration gives one, else the size the scan is written at (the
    nerfstudio loader's ``raw_size // downscale_factor``); where both are
    given they agree."""
    write_size = tuple(config["scan"]["write_size"])
    img_size = config["config"]["dataset"].get("img_size")
    if img_size is not None and tuple(img_size) != write_size:
        raise ValueError(f"dataset.img_size {tuple(img_size)} is not the scan's "
                         f"write_size {write_size}")
    return write_size


def save_png(path, img):
    """Write (H, W, 3) ``img`` in [0, 1] as an 8-bit PNG."""
    Image.fromarray((img * 255 + 0.5).astype(np.uint8)).save(path, compress_level=1)


def write_idr(root, tag, seed, n_views, write_size, raw_size, K):
    """Write the IDR scan ``tag`` under ``root``, its cameras those of the
    NDC ``K`` at ``raw_size``; returns its directory."""
    imgs, R, T = views(seed, n_views, write_size)
    scan = Path(root) / tag
    (scan / "image").mkdir(parents=True, exist_ok=True)
    S = scale_mat(seed)
    S_inv = np.linalg.inv(S)
    cams = {}
    for i, img in enumerate(imgs):
        save_png(scan / "image" / f"{i:06d}.png", img)
        world = np.eye(4)
        world[:3] = opencv_projection_from_camera(K, R[i], T[i], raw_size)
        cams[f"world_mat_{i}"] = world @ S_inv
        cams[f"scale_mat_{i}"] = S
    np.savez(scan / "cameras.npz", **cams)
    return scan


def load_png(path, img_size):
    """(H, W, 3) float32 in [0, 1] of a PNG, bilinearly resized to
    ``img_size`` where it differs."""
    img = Image.open(path).convert("RGB")
    H, W = img_size
    if img.size != (W, H):
        img = img.resize((W, H), Image.BILINEAR)
    return np.asarray(img, np.float32) / 255.0


def read_idr(scan, img_size, raw_size):
    """The views of a written IDR scan as the reference sees them: (imgs
    (N, H, W, 3) float32, K (N, 4, 4), R (N, 3, 3), T (N, 3)), in file
    order."""
    scan = Path(scan)
    files = sorted((scan / "image").glob("*.png"))
    cam = np.load(scan / "cameras.npz")
    imgs, Ks, Rs, Ts = [], [], [], []
    for i, f in enumerate(files):
        imgs.append(load_png(f, img_size))
        P = (cam[f"world_mat_{i}"] @ cam[f"scale_mat_{i}"])[:3, :4]
        K, R, T = camera_from_opencv_projection(P, raw_size)
        Ks.append(K), Rs.append(R), Ts.append(T)
    return np.stack(imgs), np.stack(Ks), np.stack(Rs), np.stack(Ts)


# the internal camera (x left, y up, z forward) against OpenGL's (x right,
# y up, z backward)
GL_FLIP = np.diag([-1.0, 1.0, -1.0])


def write_nerfstudio(root, tag, seed, n_views, write_size, raw_size, intrinsics):
    """Write the nerfstudio capture ``tag`` under ``root``: its PNGs at
    ``write_size``, its ``intrinsics`` ({fl_x, fl_y, cx, cy}) those of a
    frame of ``raw_size``; returns its directory."""
    imgs, R, T = views(seed, n_views, write_size)
    base = Path(root) / tag
    (base / "images").mkdir(parents=True, exist_ok=True)
    frames = []
    for i, img in enumerate(imgs):
        name = f"images/frame_{i:05d}.png"
        save_png(base / name, img)
        # x_view = x_world @ R + T; the OpenGL camera's world -> camera is
        # GL_FLIP R^T, GL_FLIP T, and its camera-to-world the inverse
        R_wc = GL_FLIP @ np.asarray(R[i], np.float64).T
        t_wc = GL_FLIP @ np.asarray(T[i], np.float64)
        c2w = np.eye(4)
        c2w[:3, :3] = R_wc.T
        c2w[:3, 3] = -R_wc.T @ t_wc
        frames.append({"file_path": name, "transform_matrix": c2w.tolist()})
    H, W = raw_size
    meta = {**intrinsics, "w": int(W), "h": int(H), "frames": frames}
    (base / "transforms.json").write_text(json.dumps(meta))
    return base


def read_nerfstudio(base, img_size):
    """The views of a written nerfstudio capture as the reference sees them,
    as ``read_idr``'s, in the order of the frames' ``file_path``."""
    base = Path(base)
    meta = json.loads((base / "transforms.json").read_text())
    K = ndc_from_pixels(meta, (int(meta["h"]), int(meta["w"])))
    imgs, Rs, Ts = [], [], []
    for fr in sorted(meta["frames"], key=lambda f: f["file_path"]):
        c2w = np.asarray(fr["transform_matrix"], np.float64)
        R_wc = c2w[:3, :3].T
        t_wc = -R_wc @ c2w[:3, 3]
        Rs.append((GL_FLIP @ R_wc).T.astype(np.float32))
        Ts.append((GL_FLIP @ t_wc).astype(np.float32))
        imgs.append(load_png(base / fr["file_path"], img_size))
    return np.stack(imgs), np.stack([K] * len(Rs)), np.stack(Rs), np.stack(Ts)


def layout(config):
    """The scan's layout, one that the harness writes."""
    name = config["scan"]["layout"]
    if name not in ("idr", "nerfstudio"):
        raise ValueError(f"scan layout {name!r}: the harness writes 'idr' and 'nerfstudio'")
    return name


def write(config, root, seed):
    """Write the scan of ``config`` from ``seed`` under ``root`` in its
    layout; returns its directory."""
    sc = config["scan"]
    write_size, raw_size = tuple(sc["write_size"]), tuple(sc["raw_size"])
    args = (root, config["config"]["dataset"]["tag"], seed, sc["n_views"], write_size,
            raw_size)
    if layout(config) == "idr":
        return write_idr(*args, camera(config))
    df = int(config["config"]["dataset"].get("downscale_factor", 1))
    if write_size != (raw_size[0] // df, raw_size[1] // df):
        raise ValueError(f"scan write_size {write_size} is not raw_size {raw_size} "
                         f"// downscale_factor {df}")
    return write_nerfstudio(*args, sc.get("intrinsics") or pixels_from_ndc(K_NDC, raw_size))


def read(config, scan_dir):
    """The views of ``config``'s written scan at its render size: (imgs,
    K, R, T) as ``read_idr`` gives them."""
    if layout(config) == "idr":
        return read_idr(scan_dir, render_size(config), tuple(config["scan"]["raw_size"]))
    return read_nerfstudio(scan_dir, render_size(config))
