"""Batched least-squares plane fit and RANSAC inlier maximization (PyTorch
port of dbw_tpu/eval/ransac.py, reference src/utils/ransac.py; it strips
the ground plane from DTU GT clouds for the baselines' preprocessing).

The candidate sets are drawn from an explicit ``torch.Generator``, or given
as ``idx`` (the JAX package's ``jax.random`` draws cannot be replayed, so a
comparison passes the same indices to both)."""

from __future__ import annotations

import numpy as np
import torch

from ..utils.device import DEFAULT_DEVICE, resolve_device


def ls_plane_fit(points):
    """Fit z = a x + b y + c by least squares for a batch of candidate sets.
    points: (B, K, 3). Returns (B, 3) coefficients (a, b, c)."""
    A = torch.cat([points[..., :2], torch.ones_like(points[..., :1])], dim=-1)
    z = points[..., 2:3]
    AtA = A.transpose(-1, -2) @ A
    Atz = A.transpose(-1, -2) @ z
    eye = torch.eye(3, dtype=points.dtype, device=points.device)
    return torch.linalg.solve(AtA + 1e-8 * eye, Atz)[..., 0]


def ransac_plane(points, n_trials=100, n_samples=3, threshold=0.01,
                 generator=None, idx=None):
    """RANSAC plane: the candidate fit with the most points within
    ``threshold`` of z = a x + b y + c. points: (P, 3); idx: (n_trials,
    n_samples) candidate indices, else drawn from ``generator``. Returns
    (coef (3,), inlier_mask (P,))."""
    P = points.shape[0]
    if idx is None:
        idx = torch.randint(0, P, (n_trials, n_samples), generator=generator,
                            device=points.device)
    coefs = ls_plane_fit(points[torch.as_tensor(idx, device=points.device)])
    pred_z = (coefs[:, 0:1] * points[None, :, 0] + coefs[:, 1:2] * points[None, :, 1]
              + coefs[:, 2:3])
    inliers = (points[None, :, 2] - pred_z).abs() < threshold
    best = torch.argmax(inliers.sum(dim=1))
    return coefs[best], inliers[best]


def remove_ground_plane(points, axis=2, n_trials=100, threshold=0.001 ** 0.5,
                        seed=0, device=DEFAULT_DEVICE):
    """Remove the dominant plane roughly orthogonal to ``axis`` (numpy in,
    numpy out). The defaults are the reference's Ransac (thresh 0.001 on
    the squared residual, 100 trials): |residual| < sqrt(1e-3)."""
    device = resolve_device(device)
    pts = np.asarray(points, np.float32)
    perm = [i for i in range(3) if i != axis] + [axis]
    gen = torch.Generator(device=device).manual_seed(seed)
    coef, inl = ransac_plane(torch.as_tensor(pts[:, perm], device=device),
                             n_trials=n_trials, threshold=threshold, generator=gen)
    keep = ~inl.cpu().numpy()
    return pts[keep], coef.cpu().numpy()
