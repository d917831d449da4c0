"""Fused fragment stage of the soft training renderer (K2 forward, K3
backward).

PyTorch port of dbw_tpu/render/fragment_fused.py. Per fragment: read the
20-column face row, compute barycentrics and the signed squared edge
distance, the coverage alpha and the perspective-correct clipped uv as a
bilinear base texel ``id00`` plus offsets ``wx``, ``wy``. Gradients reach
only the vertex-xy columns and the face-alpha column (detached barycentrics,
the training configuration); ``id00``, ``wx``, ``wy`` carry none.

Face-table columns (built by the renderer):
  0-5 x0 y0 x1 y1 x2 y2 (NDC), 6-8 z0 z1 z2, 9 face alpha, 10-11 pad,
  12-17 u0 v0 u1 v1 u2 v2, 18 map index, 19 pad.

The backward reads the alpha math's inputs (columns 0-5 and 9) from the
face table; the TPU version saves them per fragment as a residual, which
the port does not. The fragments come in the layout n = pixel * K + slot of
the renderers' (P, K) streams; ``K`` tells K3 that layout, so that a warp
takes one slot of 32 consecutive pixels (the result does not depend on it).

``frag_fwd``/``frag_bwd`` launch the CUDA kernels (csrc/fragment.cu) for
CUDA tensors and run the plain versions for CPU tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


N_COLS = 20
MAX_K = 32


class FragFlags(NamedTuple):
    persp: bool
    clip_bary: bool
    clip_inside: bool
    TH: int
    TW: int


def _seg_d2(ax, ay, bx, by, px, py, zero, one):
    # minimum/maximum (not clamp) so that autograd splits the cotangent at
    # ties the way JAX's min/max/clip do
    abx, aby = bx - ax, by - ay
    apx, apy = px - ax, py - ay
    denom = torch.maximum(abx * abx + aby * aby, zero + 1e-12)
    t = torch.minimum(torch.maximum((apx * abx + apy * aby) / denom, zero), one)
    dx = apx - t * abx
    dy = apy - t * aby
    return dx * dx + dy * dy


def _bary2d(x0, y0, x1, y1, x2, y2, px, py):
    area = (x1 - x0) * (y2 - y0) - (y1 - y0) * (x2 - x0)
    # the inner where keeps 1/area finite, so a degenerate face's unused
    # branch gives a zero gradient and not 0 * inf
    inv_area = torch.where(area.abs() > 1e-12,
                           1.0 / torch.where(area == 0.0, 1.0, area),
                           torch.zeros_like(area))
    w0 = ((x2 - x1) * (py - y1) - (y2 - y1) * (px - x1)) * inv_area
    w1 = ((x0 - x2) * (py - y2) - (y0 - y2) * (px - x2)) * inv_area
    w2 = ((x1 - x0) * (py - y0) - (y1 - y0) * (px - x0)) * inv_area
    return w0, w1, w2


def signed_edge_dist2(xy, px, py):
    """Signed squared NDC distance (N,) of the pixel centers (px, py) to the
    nearest edge of the faces xy (N, 6) [x0 y0 x1 y1 x2 y2]: negative
    inside the face."""
    x0, y0, x1, y1, x2, y2 = (xy[:, i] for i in range(6))
    zero = torch.zeros((), dtype=xy.dtype, device=xy.device)
    one = zero + 1.0
    w0, w1, w2 = _bary2d(x0, y0, x1, y1, x2, y2, px, py)
    inside = torch.minimum(torch.minimum(w0, w1), w2) >= 0.0
    d2 = torch.minimum(
        torch.minimum(_seg_d2(x0, y0, x1, y1, px, py, zero, one),
                      _seg_d2(x1, y1, x2, y2, px, py, zero, one)),
        _seg_d2(x2, y2, x0, y0, px, py, zero, one),
    )
    return torch.where(inside, -d2, d2)


def alpha_math(res, px, py, vld, sigma, clip_inside):
    """Coverage alpha (N,) from the residual (N, 8) [x0 y0 x1 y1 x2 y2 fa 0];
    the differentiable part of the fragment math."""
    fa = res[:, 6]
    zero = torch.zeros((), dtype=res.dtype, device=res.device)
    dists = signed_edge_dist2(res[:, :6], px, py)
    if sigma == 0.0:
        a = (dists <= 0.0).to(res.dtype)
    else:
        sig = max(float(sigma), 1e-20)
        if clip_inside:
            a = torch.exp(-torch.maximum(dists, zero) / sig)
        else:
            a = torch.sigmoid(-dists / sig)
    return a * vld * fa


def _clip(x, lo, hi):
    """clip as JAX's jnp.clip: maximum then minimum, so autograd splits the
    cotangent in half at a bound (torch.clamp passes all of it)."""
    return torch.minimum(torch.maximum(x, lo), hi)


def bary_uv(cols, px, py, persp, clip_bary):
    """Interpolated uv (uv_u, uv_v), each (N,), from gathered face rows
    (N, 20): perspective-correct, clipped barycentrics of the pixel centers.
    Differentiable in the xy and z columns (the env pass learns through it)."""
    x0, y0, x1, y1, x2, y2 = (cols[:, i] for i in range(6))
    z0, z1, z2 = cols[:, 6], cols[:, 7], cols[:, 8]
    u0, v0, u1, v1, u2, v2 = (cols[:, 12 + i] for i in range(6))
    zero = torch.zeros((), dtype=cols.dtype, device=cols.device)
    w0, w1, w2 = _bary2d(x0, y0, x1, y1, x2, y2, px, py)
    b0, b1, b2 = w0, w1, w2
    if persp:
        iw0 = w0 / torch.maximum(z0, zero + 1e-8)
        iw1 = w1 / torch.maximum(z1, zero + 1e-8)
        iw2 = w2 / torch.maximum(z2, zero + 1e-8)
        denom = torch.maximum(iw0 + iw1 + iw2, zero + 1e-12)
        b0, b1, b2 = iw0 / denom, iw1 / denom, iw2 / denom
    if clip_bary:
        b0, b1, b2 = (_clip(b, zero, zero + 1.0) for b in (b0, b1, b2))
        bs = torch.maximum(b0 + b1 + b2, zero + 1e-6)
        b0, b1, b2 = b0 / bs, b1 / bs, b2 / bs
    return b0 * u0 + b1 * u1 + b2 * u2, b0 * v0 + b1 * v1 + b2 * v2


def texel_coords(uv_u, uv_v, mi, TH, TW):
    """Bilinear base texel id00 (int32) and offsets (wx, wy) of uv in map mi
    (align_corners, v = 0 at the bottom row). The floor is piecewise
    constant: wx, wy keep the gradient of u, v (scale TW - 1, TH - 1)."""
    zero = torch.zeros((), dtype=uv_u.dtype, device=uv_u.device)
    u = _clip(uv_u, zero, zero + 1.0) * (TW - 1)
    v = (1.0 - _clip(uv_v, zero, zero + 1.0)) * (TH - 1)
    x0f = torch.floor(u).detach()
    y0f = torch.floor(v).detach()
    id00 = (mi.to(torch.int32) * (TH * TW) + y0f.to(torch.int32) * TW
            + x0f.to(torch.int32))
    return id00, u - x0f, v - y0f


def uv_math(cols, px, py, flags: FragFlags):
    """Texel id00 (int32) and offsets wx, wy from gathered rows (N, 20)."""
    uv_u, uv_v = bary_uv(cols, px, py, flags.persp, flags.clip_bary)
    return texel_coords(uv_u, uv_v, cols[:, 18], flags.TH, flags.TW)


def residual(cols):
    """The alpha math's inputs (N, 8) [x0 y0 x1 y1 x2 y2 fa 0] of gathered
    face rows (N, 20)."""
    zero = torch.zeros_like(cols[:, :1])
    return torch.cat([cols[:, 0:6], cols[:, 9:10], zero], dim=1)


def frag_fwd_plain(table, ids, vld, px, py, sigma, flags: FragFlags):
    """Plain K2: (id00, wx, wy, alpha) for each fragment."""
    cols = table[ids.long()]
    alpha = alpha_math(residual(cols), px, py, vld, sigma, flags.clip_inside)
    id00, wx, wy = uv_math(cols, px, py, flags)
    return id00, wx, wy, alpha


def frag_bwd_plain(table, ids, vld, px, py, d_alpha, sigma, clip_inside, K):
    """Plain K3: the alpha math's inputs ``residual(table[ids])``, autograd
    through the alpha math, then an index_add_ of the (N, 8) cotangents
    into a (rows, 8) table. The fragment layout K does not change the sums."""
    _check_layout(ids.shape[0], K)
    res = residual(table[ids.long()])
    with torch.enable_grad():
        r = res.detach().requires_grad_(True)
        a = alpha_math(r, px, py, vld, sigma, clip_inside)
        (d_res,) = torch.autograd.grad(a, r, d_alpha, allow_unused=True)
    d_res = torch.zeros_like(res) if d_res is None else d_res
    out = torch.zeros((table.shape[0], 8), dtype=res.dtype, device=res.device)
    return out.index_add_(0, ids.long(), d_res)


def _check_layout(N, K):
    """N fragments in the layout n = pixel * K + slot, K <= 32."""
    if not 1 <= K <= MAX_K or N % K:
        raise ValueError(f"fragment layout: N={N} fragments, K={K}")


def _check_table(table, name):
    if table.dim() != 2 or table.shape[1] != N_COLS:
        raise ValueError(f"{name}: table {tuple(table.shape)}")


def _check_streams(N, *streams):
    """Per-fragment streams must be (N,); ids are trusted to index real
    table rows (the renderer builds them)."""
    for t in streams:
        if tuple(t.shape) != (N,):
            raise ValueError(f"fragment stream of shape {tuple(t.shape)}, N={N}")


def frag_fwd(table, ids, vld, px, py, sigma, flags):
    return frag_fwd_plain(table, ids, vld, px, py, sigma, flags)


def frag_bwd(table, ids, vld, px, py, d_alpha, sigma, clip_inside, K):
    return frag_bwd_plain(table, ids, vld, px, py, d_alpha, sigma, clip_inside, K)


class _FragmentShade(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, ids, vld, px, py, sigma, flags, K):
        id00, wx, wy, alpha = frag_fwd(table, ids, vld, px, py, sigma, flags)
        # the backward reads the alpha math's inputs from the table itself
        ctx.save_for_backward(table, ids, vld, px, py)
        ctx.sigma, ctx.flags, ctx.K = sigma, flags, K
        ctx.mark_non_differentiable(id00, wx, wy)
        return id00, wx, wy, alpha

    @staticmethod
    def backward(ctx, _g_id00, _g_wx, _g_wy, g_alpha):
        table, ids, vld, px, py = ctx.saved_tensors
        if g_alpha is None:
            return (None,) * 8
        d8 = frag_bwd(table, ids, vld, px, py, g_alpha.contiguous(), ctx.sigma,
                      ctx.flags.clip_inside, ctx.K)
        d_table = torch.zeros((table.shape[0], N_COLS), dtype=d8.dtype,
                              device=d8.device)
        d_table[:, 0:6] = d8[:, 0:6]
        d_table[:, 9] = d8[:, 6]
        # sigma is a schedule constant: no cotangent
        return d_table, None, None, None, None, None, None, None


def fused_fragment_shade(table, ids, vld, px, py, sigma, flags: FragFlags, K):
    """table: (rows, 20) f32 face table; ids: (N,) int32 row per fragment
    (empty slots point at any real row with vld = 0); vld, px, py: (N,) f32,
    N = P * K fragments in the layout n = pixel * K + slot. Returns (id00
    int32, wx, wy, alpha), each (N,); differentiable in the vertex-xy and
    face-alpha columns of ``table``."""
    return _FragmentShade.apply(table, ids, vld, px, py, float(sigma), flags, K)
