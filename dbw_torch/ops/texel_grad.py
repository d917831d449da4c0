"""Texture-atlas gradient of the bilinear quad sample (K4).

PyTorch port of the texel-gradient pipeline of dbw_tpu
(render/meshes.py::_quad_maps_grad and the segment-sum kernel in
ops/segment_sum_pallas.py): each fragment's RGB cotangent ``g`` goes to the 4
texels {id00, id00 + 1, id00 + TW, id00 + TW + 1} weighted by the bilinear
weights of (wx, wy); corners past the end of the atlas are dropped.

``quad_maps_grad`` launches the CUDA kernel (csrc/texel.cu) for CUDA tensors
and runs ``quad_maps_grad_plain`` for CPU tensors.
"""

from __future__ import annotations

import torch

from .. import kernels


def corner_weights(wx, wy):
    return ((1 - wx) * (1 - wy), wx * (1 - wy), (1 - wx) * wy, wx * wy)


def quad_maps_grad_plain(id00, wx, wy, g, R, TW):
    """Plain K4: index_add_ of the 4 weighted corners into (R, C)."""
    d = torch.zeros((R, g.shape[-1]), dtype=g.dtype, device=g.device)
    base = id00.long()
    for off, w in zip((0, 1, TW, TW + 1), corner_weights(wx, wy)):
        t = base + off
        keep = t < R
        d.index_add_(0, t[keep], (g * w[:, None])[keep])
    return d


def quad_maps_grad_cuda(id00, wx, wy, g, R, TW):
    """K4 kernel launch: (R, 3) atlas cotangent."""
    N = id00.shape[0]
    if (tuple(g.shape) != (N, 3) or tuple(wx.shape) != (N,)
            or tuple(wy.shape) != (N,)):
        raise ValueError(f"quad_maps_grad_cuda: id00 {tuple(id00.shape)}, "
                         f"wx {tuple(wx.shape)}, g {tuple(g.shape)}")
    ptrs = [kernels.check(id00, torch.int32, "id00"),
            kernels.check(wx, torch.float32, "wx"),
            kernels.check(wy, torch.float32, "wy"),
            kernels.check(g, torch.float32, "g")]
    d = torch.zeros((R, 3), dtype=torch.float32, device=g.device)
    kernels.launch("dbw_texel_grad", "K4_texel_grad", *ptrs, N,
                   int(R), int(TW), d.data_ptr())
    return d


def quad_maps_grad(id00, wx, wy, g, R, TW):
    if g.is_cuda:
        return quad_maps_grad_cuda(id00, wx, wy, g, R, TW)
    return quad_maps_grad_plain(id00, wx, wy, g, R, TW)
