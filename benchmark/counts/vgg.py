"""Floating-point operations of the LPIPS loss's VGG16 trunk (13 3x3
convolutions, "same" padding, 2x2 max-pools between the blocks; features
up to relu5_3): 2 * 9 * C_in * C_out * H * W per convolution. A view that
needs its input's gradient (the rendered views) pays the forward and the
backward to its input (one more convolution's worth, no filter gradient:
the filters are constant); a target view pays the forward only."""

from __future__ import annotations

VGG16_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M",
             512, 512, 512]


def trunk_flops(H, W):
    """The forward operations of one (H, W) image through the trunk."""
    flops, c_in = 0, 3
    for c in VGG16_CFG:
        if c == "M":
            H, W = H // 2, W // 2
            continue
        flops += 2 * 9 * c_in * c * H * W
        c_in = c
    return flops


def lpips_flops(n_target, n_rendered, H, W):
    """A step's LPIPS trunk operations: the targets forward, the rendered
    views forward and backward to their input."""
    return (n_target + 2 * n_rendered) * trunk_flops(H, W)
