"""The benchmark's input scans: written from ``--seed`` in the IDR layout
that the port's DTU and BlendedMVS loaders read, and read back on their own
for the plain reference.

    <root>/<tag>/image/000000.png ...
    <root>/<tag>/cameras.npz          world_mat_i, scale_mat_i

The views are smooth colour fields (a few low-frequency waves per channel,
so that the PNGs stay small) seen from cameras on an arc around the scene:
distance 3, elevation 25 degrees, azimuth from -40 to 40 degrees, each
jittered from the seed. Every seed gives the same number of views at the
same sizes. The camera format is the port's ``data/scan_writer.py``
(``world_mat_i @ scale_mat_i`` is the view's OpenCV projection at the raw
image size); the code here imports nothing of the port.
"""

from __future__ import annotations

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


def write_scan(root, tag, seed, n_views, write_size, raw_size):
    """Write scan ``tag`` under ``root``; returns its directory."""
    imgs, R, T = views(seed, n_views, write_size)
    scan = Path(root) / tag
    (scan / "image").mkdir(parents=True, exist_ok=True)
    S = scale_mat(seed)
    S_inv = np.linalg.inv(S)
    cams = {}
    for i, img in enumerate(imgs):
        Image.fromarray((img * 255 + 0.5).astype(np.uint8)).save(
            scan / "image" / f"{i:06d}.png", compress_level=1)
        world = np.eye(4)
        world[:3] = opencv_projection_from_camera(K_NDC, R[i], T[i], raw_size)
        cams[f"world_mat_{i}"] = world @ S_inv
        cams[f"scale_mat_{i}"] = S
    np.savez(scan / "cameras.npz", **cams)
    return scan


def read_scan(scan, img_size, raw_size):
    """The views of a written scan as the reference sees them: (imgs (N, H,
    W, 3) float32, K (N, 4, 4), R (N, 3, 3), T (N, 3)), in file order."""
    scan = Path(scan)
    files = sorted((scan / "image").glob("*.png"))
    cam = np.load(scan / "cameras.npz")
    imgs, Ks, Rs, Ts = [], [], [], []
    for i, f in enumerate(files):
        img = Image.open(f).convert("RGB")
        H, W = img_size
        if img.size != (W, H):
            img = img.resize((W, H), Image.BILINEAR)
        imgs.append(np.asarray(img, np.float32) / 255.0)
        P = (cam[f"world_mat_{i}"] @ cam[f"scale_mat_{i}"])[:3, :4]
        K, R, T = camera_from_opencv_projection(P, raw_size)
        Ks.append(K), Rs.append(R), Ts.append(T)
    return np.stack(imgs), np.stack(Ks), np.stack(Rs), np.stack(Ts)
