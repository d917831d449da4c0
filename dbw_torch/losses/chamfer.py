"""Chamfer distance through a chunked brute-force 1-NN (PyTorch port of
dbw_tpu/losses/chamfer.py, reference src/utils/chamfer.py).

The squared distances of a chunk of the first cloud to the whole second one
are the expansion ``|x|^2 + |y|^2 - 2 x.y^T`` through one matrix product,
in full float32 (TF32 off inside the function: it would move the
expansion by ~1e-3 relative and pick other neighbours). The argmin runs
without autograd, and each point keeps only its nearest entry: the
gradient flows through the gathered entries, as the JAX function's does,
and no (chunk, P2) block stays alive for the backward.

Semantics of ``chamfer_distance`` are the reference's modified chamfer:
optional L1 (square root of the squared distances), point, batch and
direction reductions (sum / mean / none), and the normal cosine distance
through the gathered nearest indices.
"""

from __future__ import annotations

from contextlib import contextmanager

import torch


@contextmanager
def full_f32_matmul():
    """TF32 off for matrix products inside the block (restored after)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def nn_dist2_idx(x, y, chunk=4096):
    """For each point of x (P1, D): the squared distance to and the index of
    its nearest neighbour in y (P2, D). Returns (dist2 (P1,), idx (P1,)
    int64).

    The requested chunk is clamped so that a (chunk, P2) float32 block
    stays near 1 GB, as in the JAX function."""
    P1, P2 = x.shape[0], y.shape[0]
    chunk = max(128, min(chunk, (1 << 28) // max(P2, 1)))
    with torch.no_grad(), full_f32_matmul():
        xd, yd = x.detach(), y.detach()
        y2 = (yd * yd).sum(-1)
        yT = yd.T
        vals, idxs = [], []
        for s in range(0, P1, chunk):
            xc = xd[s:s + chunk]
            d2 = (xc * xc).sum(-1, keepdim=True) + y2[None]
            d2.addmm_(xc, yT, alpha=-2.0)  # x2 + y2 - 2 x.y^T, in place
            val, idx = d2.min(-1)
            vals.append(val)
            idxs.append(idx)
        val = torch.cat(vals) if vals else x.new_zeros((0,))
        idx = torch.cat(idxs) if idxs else torch.zeros((0,), dtype=torch.long,
                                                       device=x.device)
    if x.requires_grad or y.requires_grad:
        # the gathered entries with their gradient; the forward value stays
        # the block's entry, bit for bit
        yi = y[idx]
        g = (x * x).sum(-1) + (yi * yi).sum(-1) - 2.0 * (x * yi).sum(-1)
        val = val + (g - g.detach())
    return torch.maximum(val, torch.zeros_like(val)), idx


def _cos_dist(a, b):
    num = (a * b).sum(-1)
    den = (torch.linalg.norm(a, dim=-1) * torch.linalg.norm(b, dim=-1)).clamp(min=1e-6)
    return 1.0 - (num / den).abs()


def chamfer_distance(x, y, x_normals=None, y_normals=None, batch_reduction="mean",
                     point_reduction="mean", direction_reduction="sum",
                     return_L1=False, chunk=4096):
    """x: (N, P1, D), y: (N, P2, D) (or unbatched (P, D)). Returns (cham,
    cham_normals or None) with the reference's reductions; with
    direction_reduction None or "none" each is an (x, y) pair."""
    x = torch.as_tensor(x, dtype=torch.float32)
    y = torch.as_tensor(y, dtype=torch.float32, device=x.device)
    if x.ndim not in (2, 3) or y.ndim != x.ndim:
        raise ValueError(f"chamfer_distance: point clouds (N, P, D) or (P, D), got "
                         f"{tuple(x.shape)} and {tuple(y.shape)}")
    if x.ndim == 2:
        x, y = x[None], y[None]
        if x_normals is not None:
            x_normals, y_normals = x_normals[None], y_normals[None]
    with_normals = x_normals is not None
    if with_normals:
        x_normals = torch.as_tensor(x_normals, dtype=torch.float32, device=x.device)
        y_normals = torch.as_tensor(y_normals, dtype=torch.float32, device=x.device)

    cx, cy, nx, ny = [], [], [], []
    for b in range(x.shape[0]):
        dx2, ix = nn_dist2_idx(x[b], y[b], chunk)
        dy2, iy = nn_dist2_idx(y[b], x[b], chunk)
        cx.append(torch.sqrt(dx2) if return_L1 else dx2)
        cy.append(torch.sqrt(dy2) if return_L1 else dy2)
        if with_normals:
            nx.append(_cos_dist(x_normals[b], y_normals[b][ix]))
            ny.append(_cos_dist(y_normals[b], x_normals[b][iy]))

    # point reduction
    sums = [torch.stack(c).sum(-1) for c in (cx, cy)]
    if with_normals:
        sums += [torch.stack(c).sum(-1) for c in (nx, ny)]
    if point_reduction == "mean":
        n_pts = [x.shape[1], y.shape[1]] * 2
        sums = [s / n for s, n in zip(sums, n_pts)]
    # batch reduction
    if batch_reduction is not None:
        sums = [s.sum() for s in sums]
        if batch_reduction == "mean":
            sums = [s / x.shape[0] for s in sums]

    cham = (sums[0], sums[1])
    cham_n = (sums[2], sums[3]) if with_normals else None
    if direction_reduction in (None, "none"):
        return cham, cham_n
    cham = cham[0] + cham[1]
    cham_n = cham_n[0] + cham_n[1] if with_normals else None
    if direction_reduction == "mean":
        cham = 0.5 * cham
        cham_n = 0.5 * cham_n if with_normals else None
    return cham, cham_n
