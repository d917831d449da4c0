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

A supersampled config (the viz renderers) counts its hard launches under
``K1_select_hard_ss``.

``row_range=(row0, Hb)`` selects for the Hb-row band from image row row0
only: (B, Hb, W, K), bitwise the full raster's rows [row0, row0 + Hb). The
pixel NDC stays in full-image coordinates, and a band may overhang the
image's last row (its extra rows are computed; the caller crops them).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .cameras import Camera, ndc_pixel_centers, view_to_ndc, world_to_view

BIG = 3.0e38
MAX_K = 32
# floating-point operations of the selection kernel per pixel-face pair
# that passes its tile cull (the count behind its operations bound; see the
# note at the top of csrc/raster.cu)
FLOPS_PER_PAIR = 60


class RasterConfig(NamedTuple):
    image_size: tuple
    faces_per_pixel: int = 10
    z_clip: float = 1e-3
    perspective_correct: bool = True
    clip_barycentric: bool = True
    row_chunk: int = 10
    # the supersampling factor that image_size includes (the viz renderers'
    # 4); its kernel launches are counted apart from the training passes'
    supersample: int = 1


class FaceGeom(NamedTuple):
    """Per-face projected geometry, batched over views."""

    xy: torch.Tensor     # (B, F, 3, 2) NDC xy of the 3 verts
    z: torch.Tensor      # (B, F, 3) view-space z, clamped at z_clip
    valid: torch.Tensor  # (B, F) bool


def _cross2(a, b):
    return a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]


def project_faces(verts, faces, R, T, cam: Camera, z_clip=1e-3) -> FaceGeom:
    """World-space mesh (V, 3) -> per-face NDC geometry for B views
    (R (B, 3, 3), T (B, 3)). A slot-batched mesh's verts (S, V, 3) go to
    its S * B views, slot s to views s * B .. s * B + B - 1
    (``world_to_view``): the views of every slot in one (S * B, F) batch."""
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


def band_rows(cfg: RasterConfig, row_range=None):
    """(row0, Hb) of the rows selected for: the whole image by default."""
    if row_range is None:
        return 0, cfg.image_size[0]
    row0, Hb = int(row_range[0]), int(row_range[1])
    if row0 < 0 or Hb < 1:
        raise ValueError(f"row_range {row_range}: need row0 >= 0 and Hb >= 1")
    return row0, Hb


# how far (NDC) past a face's blur-inflated bbox a chunk of pixel rows must
# lie for the plain K1 to skip the face: far above the rounding of its
# inside test, so that the skip changes no selection
CULL_MARGIN = 1e-4


def rasterize_plain(packed, blur, cfg: RasterConfig, row_range=None):
    """Plain PyTorch K1: packed (B, F, 16) -> pix_to_face (B, Hb, W, K)
    int32, ascending (z, face index), -1 = empty. Per chunk of pixel rows,
    every valid face whose bbox, inflated by the blur radius and
    CULL_MARGIN, reaches the chunk's rows (the others cannot cover its
    pixels) is scored against every pixel; a stable sort over them in face
    order gives ties to the lower index."""
    B, F, _ = packed.shape
    W = cfg.image_size[1]
    row0, Hb = band_rows(cfg, row_range)
    K = cfg.faces_per_pixel
    dev = packed.device
    px_row, py_col = ndc_pixel_centers(cfg.image_size, dev, row_range=(row0, Hb))
    out = torch.full((B, Hb, W, K), -1, dtype=torch.int32, device=dev)
    blur = float(blur)
    reach = max(blur, 0.0) ** 0.5 + CULL_MARGIN
    for b in range(B):
        for r0 in range(0, Hb, cfg.row_chunk):
            n = min(cfg.row_chunk, Hb - r0)
            ys = py_col[r0:r0 + n]
            f = packed[b]
            skip = ((f[:, 12] - reach > ys.max()) | (f[:, 13] + reach < ys.min())
                    | (f[:, 9] <= 0.5))
            keep = torch.nonzero(~skip).squeeze(1)        # ascending face ids
            py = ys[:, None].expand(-1, W)
            px = px_row[None].expand(n, -1)
            key = _score(px.reshape(-1, 1), py.reshape(-1, 1), f[keep][None], blur,
                         cfg.z_clip, cfg.perspective_correct,
                         cfg.clip_barycentric)            # (P, F kept)
            if len(keep) < K:
                key = torch.cat([key, torch.full((key.shape[0], K - len(keep)), BIG,
                                                 device=dev)], dim=1)
                keep = torch.cat([keep, keep.new_zeros(K - len(keep))])
            val, idx = torch.sort(key, dim=1, stable=True)
            sel = torch.where(val[:, :K] < BIG, keep[idx[:, :K]], -1)
            out[b, r0:r0 + n] = sel.reshape(n, W, K).to(torch.int32)
    return out


def rasterize(geom: FaceGeom, blur, cfg: RasterConfig, hard=False, row_range=None):
    """Top-K face selection for B views: (B, H, W, K) int32 pix_to_face,
    or (B, Hb, W, K) for the band ``row_range=(row0, Hb)``."""
    packed = pack_faces(geom)
    if hard and float(blur) != 0.0:
        raise ValueError(f"rasterize: hard selection needs blur 0, got {blur}")
    return rasterize_plain(packed, blur, cfg, row_range=row_range)
