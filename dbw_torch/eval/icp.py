"""Gradient ICP: Adam on (R_6d, T, s) minimizing the chamfer distance,
keeping the best iterate (PyTorch port of dbw_tpu/eval/icp.py, reference
src/utils/icp.py).

The kept parameters are those whose loss was the lowest among the evaluated
ones: each step evaluates the loss at the current parameters, keeps them if
the loss improved on the best so far, and only then takes the Adam step (so
the last step's update is never kept). The comparison stays on the device:
no host sync per step."""

from __future__ import annotations

import torch

from ..losses.chamfer import full_f32_matmul, nn_dist2_idx
from ..ops.rotations import rotation_6d_to_matrix
from ..utils.device import DEFAULT_DEVICE, resolve_device


def _chamfer_mean(x, y, chunk=2048):
    dx, _ = nn_dist2_idx(x, y, chunk)
    dy, _ = nn_dist2_idx(y, x, chunk)
    return dx.mean() + dy.mean()


def _transform(p, pc, estimate_scale):
    R = rotation_6d_to_matrix(p["R_6d"])
    s = p["s"] if estimate_scale else torch.ones_like(p["s"])
    return (s[:, None] * pc) @ R + p["T"][:, None]


@full_f32_matmul()
def gradient_icp(pc_pred, pc_gt, estimate_scale=True, anisotropic_scale=False,
                 lr=0.01, n_iter=100, chunk=2048, device=DEFAULT_DEVICE):
    """pc_pred, pc_gt: (N, P, 3), tensors (which keep their device) or
    arrays (put on ``device``). Returns (aligned pred (N, P, 3), [R, T, s]),
    detached. Every product runs in full float32 (TF32 off)."""
    dev = pc_pred.device if torch.is_tensor(pc_pred) else resolve_device(device)
    pc_pred = torch.as_tensor(pc_pred, dtype=torch.float32, device=dev)
    pc_gt = torch.as_tensor(pc_gt, dtype=torch.float32, device=dev)
    n = pc_pred.shape[0]
    s_dim = 3 if anisotropic_scale else 1
    params = {
        "R_6d": torch.tensor([[1.0, 0, 0, 0, 1.0, 0]], device=dev).repeat(n, 1),
        "T": torch.zeros((n, 3), device=dev),
        "s": torch.ones((n, s_dim), device=dev),
    }
    for p in params.values():
        p.requires_grad_(True)
    opt = torch.optim.Adam(list(params.values()), lr=lr)
    best_loss = torch.tensor(1e6, device=dev)
    best_p = {k: v.detach().clone() for k, v in params.items()}
    for _ in range(n_iter):
        opt.zero_grad(set_to_none=True)
        moved = _transform(params, pc_pred, estimate_scale)
        loss = torch.stack([_chamfer_mean(a, b, chunk)
                            for a, b in zip(moved, pc_gt)]).mean()
        loss.backward()
        with torch.no_grad():
            improved = loss < best_loss
            best_loss = torch.where(improved, loss, best_loss)
            for k, v in params.items():
                best_p[k] = torch.where(improved, v, best_p[k])
        for p in params.values():
            if p.grad is None:  # s without estimate_scale: Adam still steps
                p.grad = torch.zeros_like(p)
        opt.step()
    with torch.no_grad():
        R = rotation_6d_to_matrix(best_p["R_6d"])
        s = best_p["s"] if estimate_scale else torch.ones_like(best_p["s"])
        aligned = (s[:, None] * pc_pred) @ R + best_p["T"][:, None]
    return aligned, [R, best_p["T"], s]
