"""Projection and per-pixel top-K face selection (K1).

PyTorch port of dbw_tpu/render/rasterize.py (``project_faces``,
``_rasterize_xla``) and of the selection kernel in
dbw_tpu/render/rasterize_pallas.py. The selection is piecewise constant in
the geometry, so it runs on detached inputs; every differentiable quantity is
recomputed from the selected face ids in the fragment stage.

``rasterize`` launches the CUDA kernel (csrc/raster.cu) for CUDA tensors and
runs ``rasterize_plain`` for CPU tensors. ``hard=True`` (blur statically 0,
the env pass) launches the kernel's specialization without edge-distance
coverage; its plain twin is ``rasterize_plain`` at blur 0.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import kernels
from .cameras import Camera, ndc_pixel_centers, view_to_ndc, world_to_view

BIG = 3.0e38
MAX_K = 32


class RasterConfig(NamedTuple):
    image_size: tuple
    faces_per_pixel: int = 10
    z_clip: float = 1e-3
    perspective_correct: bool = True
    clip_barycentric: bool = True
    row_chunk: int = 10


class FaceGeom(NamedTuple):
    """Per-face projected geometry, batched over views."""

    xy: torch.Tensor     # (B, F, 3, 2) NDC xy of the 3 verts
    z: torch.Tensor      # (B, F, 3) view-space z, clamped at z_clip
    valid: torch.Tensor  # (B, F) bool


def _cross2(a, b):
    return a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]


def project_faces(verts, faces, R, T, cam: Camera, z_clip=1e-3) -> FaceGeom:
    """World-space mesh (V, 3) -> per-face NDC geometry for B views
    (R (B, 3, 3), T (B, 3))."""
    v_view = world_to_view(verts, R, T)                  # (B, V, 3)
    z_raw = v_view[..., 2]
    z_cl = torch.clamp(z_raw, min=z_clip)
    ndc = view_to_ndc(torch.cat([v_view[..., :2], z_cl[..., None]], -1), cam)
    fv_xy = ndc[..., :2][:, faces]                      # (B, F, 3, 2)
    fv_z = z_cl[:, faces]                               # (B, F, 3)
    behind = (z_raw[:, faces] < z_clip).all(dim=-1)
    area = _cross2(fv_xy[:, :, 1] - fv_xy[:, :, 0], fv_xy[:, :, 2] - fv_xy[:, :, 0])
    valid = (~behind) & (area.abs() > 1e-12)
    return FaceGeom(fv_xy, fv_z, valid)


def pack_faces(geom: FaceGeom):
    """FaceGeom -> (B, F, 16) f32 rows [x0 y0 x1 y1 x2 y2 z0 z1 z2 valid xmin
    xmax ymin ymax 0 0] (detached: the selection takes no gradient)."""
    xy, z = geom.xy.detach(), geom.z.detach()
    B, F = z.shape[:2]
    x, y = xy[..., 0], xy[..., 1]
    cols = [
        xy.reshape(B, F, 6), z, geom.valid.to(torch.float32)[..., None],
        x.amin(-1, keepdim=True), x.amax(-1, keepdim=True),
        y.amin(-1, keepdim=True), y.amax(-1, keepdim=True),
        torch.zeros(B, F, 2, dtype=torch.float32, device=z.device),
    ]
    return torch.cat(cols, dim=-1).contiguous()


def _seg_d2(ax, ay, bx, by, px, py):
    """Squared distance from (px, py) to segment (a, b) — the expression of
    the TPU kernel and of the fused fragment math."""
    abx, aby = bx - ax, by - ay
    apx, apy = px - ax, py - ay
    denom = torch.clamp(abx * abx + aby * aby, min=1e-12)
    t = torch.clamp((apx * abx + apy * aby) / denom, 0.0, 1.0)
    dx = apx - t * abx
    dy = apy - t * aby
    return dx * dx + dy * dy


def _score(px, py, fa, blur, z_clip, persp, clip_bary):
    """Depth key (P, F) of pixels (P, 1) against packed faces (1, F, 16):
    z where the face covers the pixel and lies past z_clip, else BIG."""
    x0, y0, x1, y1, x2, y2 = (fa[..., i] for i in range(6))
    z0, z1, z2 = fa[..., 6], fa[..., 7], fa[..., 8]
    area = (x1 - x0) * (y2 - y0) - (y1 - y0) * (x2 - x0)
    inv_area = torch.where(area.abs() > 1e-12, 1.0 / area,
                           torch.zeros_like(area))
    w0 = ((x2 - x1) * (py - y1) - (y2 - y1) * (px - x1)) * inv_area
    w1 = ((x0 - x2) * (py - y2) - (y0 - y2) * (px - x2)) * inv_area
    w2 = ((x1 - x0) * (py - y0) - (y1 - y0) * (px - x0)) * inv_area
    inside = torch.minimum(torch.minimum(w0, w1), w2) >= 0.0
    d2 = torch.minimum(
        torch.minimum(_seg_d2(x0, y0, x1, y1, px, py),
                      _seg_d2(x1, y1, x2, y2, px, py)),
        _seg_d2(x2, y2, x0, y0, px, py),
    )
    covered = inside | (d2 < blur)
    b0, b1, b2 = w0, w1, w2
    if persp:
        iw0 = w0 / torch.clamp(z0, min=1e-8)
        iw1 = w1 / torch.clamp(z1, min=1e-8)
        iw2 = w2 / torch.clamp(z2, min=1e-8)
        denom = torch.clamp(iw0 + iw1 + iw2, min=1e-12)
        b0, b1, b2 = iw0 / denom, iw1 / denom, iw2 / denom
    if clip_bary:
        b0, b1, b2 = (torch.clamp(b, 0.0, 1.0) for b in (b0, b1, b2))
        bs = torch.clamp(b0 + b1 + b2, min=1e-6)
        b0, b1, b2 = b0 / bs, b1 / bs, b2 / bs
    z = b0 * z0 + b1 * z1 + b2 * z2
    ok = covered & (fa[..., 9] > 0.5) & (z > z_clip)
    return torch.where(ok, z, torch.full_like(z, BIG))


def rasterize_plain(packed, blur, cfg: RasterConfig):
    """Plain PyTorch K1: packed (B, F, 16) -> pix_to_face (B, H, W, K) int32,
    ascending (z, face index), -1 = empty. Brute force over all faces per
    chunk of pixel rows, with a stable sort so ties go to the lower index."""
    B, F, _ = packed.shape
    H, W = cfg.image_size
    K = cfg.faces_per_pixel
    dev = packed.device
    px_row, py_col = ndc_pixel_centers((H, W), dev)
    out = torch.full((B, H, W, K), -1, dtype=torch.int32, device=dev)
    blur = float(blur)
    for b in range(B):
        fa = packed[b][None]                              # (1, F, 16)
        for r0 in range(0, H, cfg.row_chunk):
            n = min(cfg.row_chunk, H - r0)
            py = py_col[r0:r0 + n, None].expand(-1, W)
            px = px_row[None].expand(n, -1)
            key = _score(px.reshape(-1, 1), py.reshape(-1, 1), fa, blur,
                         cfg.z_clip, cfg.perspective_correct,
                         cfg.clip_barycentric)            # (P, F)
            if F < K:
                key = torch.cat([key, torch.full((key.shape[0], K - F), BIG,
                                                 device=dev)], dim=1)
            val, idx = torch.sort(key, dim=1, stable=True)
            sel = torch.where(val[:, :K] < BIG, idx[:, :K], -1)
            out[b, r0:r0 + n] = sel.reshape(n, W, K).to(torch.int32)
    return out


def rasterize_cuda(packed, blur, cfg: RasterConfig, hard=False):
    """K1 kernel launch: packed (B, F, 16) CUDA f32 -> (B, H, W, K) int32.
    ``hard`` takes the blur-0 specialization (and needs blur == 0)."""
    B, F, A = packed.shape
    H, W = cfg.image_size
    K = cfg.faces_per_pixel
    blur = float(blur)
    if A != 16 or not 1 <= K <= MAX_K or (hard and blur != 0.0):
        raise ValueError(f"rasterize_cuda: packed {tuple(packed.shape)}, K={K}, "
                         f"blur={blur}, hard={hard}")
    p = kernels.check(packed, torch.float32, "packed")
    out = torch.empty((B, H, W, K), dtype=torch.int32, device=packed.device)
    kernels.launch(
        "dbw_select", "K1_select_hard" if hard else "K1_select", p, B, F, H, W,
        K, blur, float(max(blur, 0.0)) ** 0.5, float(cfg.z_clip),
        int(cfg.perspective_correct), int(cfg.clip_barycentric), int(hard),
        out.data_ptr(),
    )
    return out


def rasterize(geom: FaceGeom, blur, cfg: RasterConfig, hard=False):
    """Top-K face selection for B views: (B, H, W, K) int32 pix_to_face."""
    packed = pack_faces(geom)
    if packed.is_cuda:
        return rasterize_cuda(packed, blur, cfg, hard=hard)
    if hard and float(blur) != 0.0:
        raise ValueError(f"rasterize: hard selection needs blur 0, got {blur}")
    return rasterize_plain(packed, blur, cfg)
