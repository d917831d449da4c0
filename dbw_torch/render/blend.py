"""Layered soft alpha compositing (PyTorch port of dbw_tpu/render/blend.py).

Front-to-back blend over the K fragment slots of a pixel. ``layered_blend``
launches the kernel pair K6 (csrc/blend.cu: the forward and a closed-form
backward, one thread a pixel) for CUDA tensors and runs
``layered_blend_plain``, the dense ``cumprod`` version, for CPU tensors.
"""

import torch

from .. import kernels
from .fragment import MAX_K


def layered_blend_plain(colors, alpha, background_color):
    """colors (..., K, 3), alpha (..., K) -> RGBA (..., 4):
    rgb = sum_k prod_{j<k}(1 - a_j) a_k c_k + prod(1 - a) bkg,
    alpha channel = 1 - prod_k (1 - a_k)."""
    occ = torch.cumprod(1.0 - alpha, dim=-1)
    occ_before = torch.cat([torch.ones_like(occ[..., :1]), occ[..., :-1]], -1)
    rgb = torch.sum(occ_before[..., None] * alpha[..., None] * colors, dim=-2)
    bg = occ[..., -1:]
    rgb = rgb + bg * torch.as_tensor(background_color, dtype=rgb.dtype,
                                     device=rgb.device)
    a = 1.0 - occ[..., -1]
    return torch.cat([rgb, a[..., None]], dim=-1)


def _background(background_color):
    """The background colour (r, g, b) as three Python floats."""
    r, g, b = (float(v) for v in background_color)
    return r, g, b


def _check(colors, alpha, name):
    K = alpha.shape[-1] if alpha.dim() else 0
    if tuple(colors.shape) != tuple(alpha.shape) + (3,) or not 1 <= K <= MAX_K:
        raise ValueError(f"{name}: colors {tuple(colors.shape)}, alpha "
                         f"{tuple(alpha.shape)}; want (..., K, 3) and (..., K), "
                         f"1 <= K <= {MAX_K}")
    P = alpha.numel() // K
    if P >= 2**31:
        raise ValueError(f"{name}: {P} pixels, more than the kernels index")
    return K, P


def _aligned(t):
    """t, contiguous and 16-byte aligned (copied if it is not)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def layered_blend_fwd_cuda(colors, alpha, bg):
    """K6 forward launch: RGBA (..., 4) of colors (..., K, 3), alpha
    (..., K) and the background ``bg`` (three floats)."""
    K, P = _check(colors, alpha, "layered_blend_fwd_cuda")
    colors, alpha = colors.contiguous(), alpha.contiguous()
    ptrs = [kernels.check(colors, torch.float32, "colors"),
            kernels.check(alpha, torch.float32, "alpha")]
    out = torch.empty(tuple(alpha.shape[:-1]) + (4,), dtype=torch.float32,
                      device=alpha.device)
    kernels.launch("dbw_blend_fwd", "K6_blend_fwd", *ptrs, P, K, *bg, out.data_ptr())
    return out


def layered_blend_bwd_cuda(colors, alpha, g, bg):
    """K6 backward launch: (d_colors, d_alpha) for the RGBA cotangent g
    (..., 4)."""
    K, P = _check(colors, alpha, "layered_blend_bwd_cuda")
    if tuple(g.shape) != tuple(alpha.shape[:-1]) + (4,):
        raise ValueError(f"layered_blend_bwd_cuda: cotangent {tuple(g.shape)}")
    colors, alpha, g = colors.contiguous(), alpha.contiguous(), _aligned(g)
    ptrs = [kernels.check(colors, torch.float32, "colors"),
            kernels.check(alpha, torch.float32, "alpha"),
            kernels.check(g, torch.float32, "g", align=16)]
    d_colors, d_alpha = torch.empty_like(colors), torch.empty_like(alpha)
    kernels.launch("dbw_blend_bwd", "K6_blend_bwd", *ptrs, P, K, *bg,
                   d_colors.data_ptr(), d_alpha.data_ptr())
    return d_colors, d_alpha


class _LayeredBlend(torch.autograd.Function):
    @staticmethod
    def forward(ctx, colors, alpha, bg):
        ctx.save_for_backward(colors, alpha)
        ctx.bg = bg
        return layered_blend_fwd_cuda(colors, alpha, bg)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        colors, alpha = ctx.saved_tensors
        d_colors, d_alpha = layered_blend_bwd_cuda(colors, alpha, g, ctx.bg)
        return d_colors, d_alpha, None


def layered_blend(colors, alpha, background_color):
    """colors (..., K, 3), alpha (..., K) -> RGBA (..., 4):
    rgb = sum_k prod_{j<k}(1 - a_j) a_k c_k + prod(1 - a) bkg,
    alpha channel = 1 - prod_k (1 - a_k)."""
    if colors.is_cuda:
        return _LayeredBlend.apply(colors, alpha, _background(background_color))
    return layered_blend_plain(colors, alpha, background_color)
