"""Training renderers: project -> select (K1) -> fragment stage -> quad
texture sample -> layered blend (the leaves ``dbw.raster``, ``dbw.shade``
and ``dbw.blend`` of ``utils/profiling.py``).

PyTorch port of the raw-shading training paths of
dbw_tpu/render/renderer.py (``Renderer.render`` and both branches of
``_shade_fused_batched``). All views are shaded as one flat fragment stream
of B * H * W * K fragments, fragment n = ((b * H + row) * W + col) * K + k.

- detach_bary=True (the soft blocks pass): the fused fragment stage K2/K3,
  uv held fixed, texel gradient K4.
- detach_bary=False (the hard env pass of ``make_env_renderer``): face rows
  gathered with ``gather_rows_partial`` (backward K5), the fragment math in
  tensor ops, and a texture sample differentiable in uv
  (``sample_quad_diff``, K4 + analytic d_wx/d_wy), so that the ground pose
  learns through the barycentrics, z included.

``row_range=(row0, Hb)`` renders the Hb-row band from image row row0 only
(the pixel-band entry point of the JAX package's sharded trainers), bitwise
selecting as the full render does, with all pixel math in full-image
coordinates.

The viz renderers (``make_viz_renderer``) render hard at ``supersample``
times the image size through the env branch and average-pool back; their
K1-hard launches count as ``K1_select_hard_ss``. ``render_faces_flat``
(per-face constant colors under a flat light) and the wireframe overlays
``render_edges``/``draw_edges`` ride the same supersampled hard raster.

The lit shading types (``shading="flat"``, ``"gouraud"``, ``"phong"``, from
a config's ``shading_type``) run ``shade_lit``: the flat-layout fragment
attributes of ``interpolate_fragments_flat`` in tensor code, as the JAX
package's ``_shade_lit_flat`` computes them, the texture read by
``sample_atlas_bilinear`` (texel gradient K4; differentiable in uv unless
``detach_bary``), the light per face, per vertex or per fragment, then the
layered blend; only the valid fragments are shaded. The selection is the
same K1 as the raw path's: soft at the config's K and sigma, hard at sigma
0. Pixel bands take raw shading only.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..ops.scatter import gather_rows_partial
from ..utils import profiling
from .blend import layered_blend
from .cameras import Camera, ndc_pixel_centers
from .fragment import (FragFlags, alpha_math, bary_uv, fused_fragment_shade,
                       residual, texel_coords)
from .interpolate import (edge_dists_flat, fragment_alpha_flat, gather_rows,
                          interp_corner_table, interpolate_fragments_flat)
from .meshes import (MeshScene, face_normals, n_slots, per_view, sample_atlas_bilinear,
                     sample_quad, sample_quad_diff)
from .rasterize import RasterConfig, project_faces, rasterize
from .shading import _light, vertex_normals

# blur_radius = log(1/1e-4 - 1) * sigma (reference renderer.py:51)
BLUR_RADIUS_FACTOR = math.log(1.0 / 1e-4 - 1.0)
# camera-frame light of the flat-lit renders (reference renderer.py:21)
DIRECTION_LIGHT = (1.0, 0.25, -1.0)
SHADING_TYPES = ("raw", "flat", "phong", "gouraud")
LIGHT_TYPES = ("ambient", "directional", "point")


def f32(v):
    """Round a python scalar to float32, as the JAX package's traced
    scalars are."""
    return float(np.float32(v))


class RendererConfig(NamedTuple):
    image_size: Tuple[int, int]
    faces_per_pixel: int = 10
    sigma: float = 1e-4
    background_color: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    clip_inside: bool = True
    detach_bary: bool = True
    shading: str = "raw"
    ambient_color: Optional[Tuple[float, float, float]] = None
    diffuse_color: Tuple[float, float, float] = (0.4, 0.4, 0.4)
    light_direction: Tuple[float, float, float] = DIRECTION_LIGHT
    light_type: str = "directional"
    light_location: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    z_clip: float = 1e-3
    supersample: int = 1

    def raster_config(self):
        H, W = self.image_size
        s = self.supersample
        return RasterConfig(image_size=(H * s, W * s),
                            faces_per_pixel=self.faces_per_pixel,
                            z_clip=self.z_clip, supersample=s)


class Renderer:
    """Stateless given (config, camera)."""

    def __init__(self, config: RendererConfig, camera: Camera):
        if config.shading not in SHADING_TYPES:
            raise NotImplementedError(f"unknown shading_type: {config.shading!r} "
                                      f"(supported: {SHADING_TYPES})")
        if config.light_type not in LIGHT_TYPES:
            raise NotImplementedError(f"unknown light type: {config.light_type!r} "
                                      f"(supported: {LIGHT_TYPES})")
        self.config = config
        self.camera = camera

    def sigma_blur(self, sigma=None):
        sigma = f32(self.config.sigma if sigma is None else sigma)
        return sigma, f32(np.float32(BLUR_RADIUS_FACTOR) * np.float32(sigma))

    def render(self, scene: MeshScene, R, T, sigma=None, row_range=None):
        """R (B, 3, 3), T (B, 3) -> RGBA (B, H, W, 4), or (B, Hb, W, 4) for
        the band ``row_range=(row0, Hb)``. With no ``sigma`` and a config
        sigma of 0 (the env renderer) the selection takes its hard
        specialization, as the JAX package decides it."""
        cfg = self.config
        if row_range is not None and cfg.shading != "raw":
            raise NotImplementedError(
                "row_range (pixel-band sharding) supports raw shading only")
        if row_range is not None and cfg.supersample > 1:
            raise ValueError("row_range: training renderers only (no supersampling)")
        hard = sigma is None and float(cfg.sigma) == 0.0
        sigma, blur = self.sigma_blur(sigma)
        with profiling.span("dbw.raster"):
            geom = project_faces(scene.verts, scene.faces, R, T, self.camera,
                                 z_clip=cfg.z_clip)
            p2f = rasterize(geom, blur, cfg.raster_config(), hard=hard,
                            row_range=row_range)
            geom = profiling.mark(geom, "dbw.raster")
        with profiling.span("dbw.shade"):
            if cfg.shading == "raw":
                frags = self.shade(scene, geom, p2f, sigma,
                                   row0=0 if row_range is None else int(row_range[0]))
            else:
                frags = self.shade_lit(scene, geom, p2f, R, sigma)
            colors, alpha = profiling.mark(frags, "dbw.shade")
        with profiling.span("dbw.blend"):
            img = layered_blend(colors, alpha, cfg.background_color)
            return profiling.mark(_avg_pool_2d(img, cfg.supersample), "dbw.blend")

    def shade(self, scene: MeshScene, geom, p2f, sigma, row0=0):
        """Fragment stage + texture sample for selected faces p2f (B, Hb, W,
        K) of the (supersampled) image rows from ``row0`` -> the blend's
        (colors (B, Hb, W, K, 3), alpha (B, Hb, W, K))."""
        cfg = self.config
        B, Hb, W, K = p2f.shape
        maps = scene.atlas.maps
        M, TH, TW = maps.shape[:3]
        maps_flat = maps.reshape(M * TH * TW, 3)
        size = cfg.raster_config().image_size
        if cfg.detach_bary:
            table, ids, vld, px, py = fragment_streams(scene, geom, p2f,
                                                       image_size=size, row0=row0)
            flags = FragFlags(True, True, cfg.clip_inside, TH, TW)
            id00, wx, wy, alpha = fused_fragment_shade(table, ids, vld, px, py,
                                                       sigma, flags, K)
            colors = sample_quad(maps_flat, id00, wx, wy, TW, K)
        else:
            table, ids, vld, px, py = fragment_streams(scene, geom, p2f,
                                                       detach_z=False,
                                                       image_size=size, row0=row0)
            # empty slots read row 0 and scatter nothing back
            rows = gather_rows_partial(
                table, torch.where(vld > 0, ids, torch.full_like(ids, -1)), 12)
            alpha = alpha_math(residual(rows), px, py, vld, sigma,
                               cfg.clip_inside)
            rcfg = cfg.raster_config()
            uv_u, uv_v = bary_uv(rows, px, py, rcfg.perspective_correct,
                                 rcfg.clip_barycentric)
            id00, wx, wy = texel_coords(uv_u, uv_v, rows[:, 18], TH, TW)
            colors = sample_quad_diff(maps_flat, id00, wx, wy, TW, TH, K)
        if cfg.ambient_color is not None:
            colors = colors * torch.as_tensor(cfg.ambient_color,
                                              device=colors.device)
        return colors.reshape(B, Hb, W, K, 3), alpha.reshape(B, Hb, W, K)

    def shade_lit(self, scene: MeshScene, geom, p2f, R, sigma):
        """flat / gouraud / phong shading of the selected faces p2f (B, H, W,
        K) of the (supersampled) image, views R (B, 3, 3) -> the blend's
        (colors (B, H, W, K, 3), alpha (B, H, W, K)); B = S * B' views of a
        slot-batched scene. With the default ambient light (1, 1, 1) every
        type leaves the texels unchanged. Only the valid fragments are
        shaded: an empty slot has alpha 0 and takes no gradient, as in the
        JAX package's dense stream."""
        cfg = self.config
        B, H, W, K = p2f.shape
        F = scene.faces.shape[0]
        sel = torch.nonzero(p2f.reshape(-1) >= 0).squeeze(1)
        ff = interpolate_fragments_flat(p2f, geom, cfg.raster_config(),
                                        detach_bary=cfg.detach_bary, select=sel)
        uv = interp_corner_table(ff, scene.uv_verts[scene.uv_faces].reshape(F, 6))
        # per-slot tables (a single scene is one slot), slot-major (S * F,
        # ...): view b belongs to slot b * S // B
        one = n_slots(scene) is None
        verts, map_idx, faces_alpha = (t[None] if one else t for t in (
            scene.verts, scene.map_idx, scene.faces_alpha))
        S, faces = verts.shape[0], scene.faces
        srows = ff.idx + (ff.view * S // B) * F
        # the compacted stream has no (pixel, slot) layout: K4 takes K = 1
        colors = sample_atlas_bilinear(scene.atlas.maps, map_idx.reshape(-1)[srows], uv,
                                       diff_uv=not cfg.detach_bary, K=1)
        ambient = cfg.ambient_color or (1.0, 1.0, 1.0)
        light_of = lambda normals, points, Rv, view=None: _light(
            normals, points, Rv, cfg.light_type, cfg.light_direction,
            cfg.light_location, ambient, cfg.diffuse_color, view=view)
        rows = ff.idx + ff.view * F
        if cfg.shading == "flat":
            fn = face_normals(verts, faces)
            cent = verts[:, faces].mean(dim=-2)
            light = gather_rows(torch.cat([light_of(fn[b * S // B], cent[b * S // B], R[b])
                                           for b in range(B)]), rows)
        elif cfg.shading == "gouraud":
            vn = vertex_normals(verts, faces)
            light_v = torch.cat([
                light_of(vn[b * S // B], verts[b * S // B], R[b])[faces].reshape(F, 9)
                for b in range(B)])
            light = interp_corner_table(ff, light_v, rows)
        else:  # phong: the light of the interpolated, renormalized normal
            corners = lambda t: t[:, faces].reshape(-1, 9)
            n = interp_corner_table(ff, corners(vertex_normals(verts, faces)), srows)
            n = n / torch.linalg.vector_norm(n, dim=-1, keepdim=True).clamp(min=1e-12)
            pts = interp_corner_table(ff, corners(verts), srows)
            light = light_of(n, pts, R, view=ff.view)
        alpha = (fragment_alpha_flat(ff, sigma, clip_inside=cfg.clip_inside)
                 * gather_rows(faces_alpha.reshape(-1), srows))
        N = B * H * W * K
        dense = lambda v: torch.zeros((N,) + v.shape[1:], dtype=v.dtype,
                                      device=v.device).index_copy(0, sel, v)
        return dense(colors * light).reshape(B, H, W, K, 3), dense(alpha).reshape(B, H, W, K)

    def _hard_select(self, scene: MeshScene, R, T):
        """Projected faces and the front face per (supersampled) pixel:
        (geom, p2f (B, Hs, Ws, 1)), by the hard K=1 selection."""
        cfg = self.config
        rcfg = cfg.raster_config()._replace(faces_per_pixel=1)
        geom = project_faces(scene.verts, scene.faces, R, T, self.camera,
                             z_clip=cfg.z_clip)
        return geom, rasterize(geom, 0.0, rcfg, hard=True)

    def render_faces_flat(self, scene: MeshScene, R, T, face_colors):
        """Hard flat-lit render with per-face constant colors (F, 3): one
        K=1 raster and two table reads a pixel. Exact for scenes whose maps
        are constant per block (the synthetic-color renders). Needs a flat,
        hard (sigma 0) renderer. -> RGBA (B, H, W, 4)."""
        cfg = self.config
        if cfg.shading != "flat" or float(cfg.sigma) != 0.0:
            raise ValueError("render_faces_flat: hard flat-lit viz renderers only")
        geom, p2f = self._hard_select(scene, R, T)
        f = p2f[..., 0].long()                            # (B, Hs, Ws)
        dev, dt = scene.verts.device, scene.verts.dtype
        fn = face_normals(scene.verts, scene.faces)       # (F, 3)
        cent = scene.verts[scene.faces].mean(dim=1)       # (F, 3)
        ambient = cfg.ambient_color or (1.0, 1.0, 1.0)
        face_colors = torch.as_tensor(face_colors, dtype=dt, device=dev)
        bg = torch.as_tensor(cfg.background_color, dtype=dt, device=dev)
        safe = f.clamp(min=0)
        a = (f >= 0).to(dt) * scene.faces_alpha[safe]     # (B, Hs, Ws)
        tab = torch.stack([
            face_colors * _light(fn, cent, R[b], cfg.light_type, cfg.light_direction,
                                 cfg.light_location, ambient, cfg.diffuse_color)
            for b in range(R.shape[0])])                  # (B, F, 3)
        wrgb = torch.gather(tab, 1, safe.reshape(len(safe), -1, 1).expand(-1, -1, 3))
        wrgb = wrgb.reshape(*safe.shape, 3) * a[..., None]
        # pool before the background blend: the blend is affine in
        # (rgb * a, a), so this equals pooling the blended image
        wrgb = _avg_pool_2d(wrgb, cfg.supersample)
        a = _avg_pool_2d(a[..., None], cfg.supersample)
        return torch.cat([wrgb + (1.0 - a) * bg, a], dim=-1)

    def render_edges(self, scene: MeshScene, R, T, linewidth=1.0):
        """Wireframe mask and front face id at the supersampled size:
        (mask (B, Hs, Ws) float, pix2face (B, Hs, Ws) int32)."""
        cfg = self.config
        geom, p2f = self._hard_select(scene, R, T)
        B, Hs, Ws, _ = p2f.shape
        s = min(Hs, Ws) / cfg.supersample
        thresh = (linewidth * cfg.supersample * 2.0 / s) ** 2
        dists, valid = edge_dists_flat(p2f, geom)
        mask = ((-dists < thresh) & valid).to(torch.float32)
        return mask.reshape(B, Hs, Ws), p2f[..., 0]

    def draw_edges(self, imgs, scene: MeshScene, R, T, colors, linewidth=1.0):
        """Overlay the wireframe (antialiased by the supersampling) on imgs
        (B, H, W, 3); colors: per-face (F, 3) or one (3,) color."""
        cfg = self.config
        mask, p2f = self.render_edges(scene, R, T, linewidth)
        colors = torch.as_tensor(colors, dtype=torch.float32, device=mask.device)
        if colors.ndim == 2:
            face_img = colors[p2f.long().clamp(min=0)]
        else:
            face_img = colors.expand(mask.shape + (3,))
        mask = _avg_pool_2d(mask[..., None], cfg.supersample)
        face_img = _avg_pool_2d(face_img, cfg.supersample)
        return imgs * (1.0 - mask) + mask * face_img


def fragment_streams(scene: MeshScene, geom, p2f, detach_z=True,
                     image_size=None, row0=0):
    """The fragment stage's inputs for B views (S * B' of a slot-batched
    scene): the (B * F, 20) face table and the per-fragment row ids
    (int32), validity and pixel NDC centers.
    The fused stage (K3) gives z no cotangent, so z is detached there;
    the uv-differentiable stage keeps it (``detach_z=False``). p2f
    (B, H, W, K) holds the rows from ``row0`` of an image of
    ``image_size`` (by default p2f's own (H, W))."""
    B, H, W, K = p2f.shape
    F = scene.faces.shape[0]
    N = H * W * K
    dev = p2f.device
    # one face table per view: gradient-carrying columns (vertex xy, z
    # unless detached, face alpha) and gradient-free ones (uv corners, map
    # index); a slot-batched scene's B = S * B' views take their slot's
    # face alpha and map index
    stat = torch.cat([
        scene.uv_verts[scene.uv_faces].reshape(F, 6).repeat(B, 1),
        per_view(scene.map_idx, B)[:, None].to(torch.float32),
        torch.zeros(B * F, 1, device=dev),
    ], dim=1).detach()
    z = geom.z.reshape(B * F, 3)
    table = torch.cat([
        geom.xy.reshape(B * F, 6),
        z.detach() if detach_z else z,
        per_view(scene.faces_alpha, B)[:, None],
        torch.zeros(B * F, 2, device=dev),
        stat,
    ], dim=1).contiguous()

    view_off = torch.arange(B, device=dev, dtype=torch.int32) * F
    # empty slots read row 0 of their view with vld = 0
    ids = (p2f.clamp(min=0) + view_off[:, None, None, None]).reshape(B * N)
    vld = (p2f.reshape(B * N) >= 0).to(torch.float32)
    px, py = ndc_pixel_centers(image_size or (H, W), dev, row_range=(row0, H))
    px = px[None, None, :, None].expand(B, H, W, K).reshape(B * N)
    py = py[None, :, None, None].expand(B, H, W, K).reshape(B * N)
    return table, ids.to(torch.int32).contiguous(), vld, px, py


def _avg_pool_2d(img, k):
    """(B, H*k, W*k, C) -> (B, H, W, C) mean over each k x k block."""
    if k == 1:
        return img
    B, Hs, Ws, C = img.shape
    return img.reshape(B, Hs // k, k, Ws // k, k, C).mean(dim=(2, 4))


def make_train_renderer(image_size, camera, faces_per_pixel=10, sigma=1e-4,
                        detach_bary=True, **kw):
    """The soft training renderer (reference dbw.py:132 + configs)."""
    return Renderer(
        RendererConfig(image_size=tuple(image_size),
                       faces_per_pixel=faces_per_pixel, sigma=sigma,
                       detach_bary=detach_bary, **kw),
        camera,
    )


def make_env_renderer(image_size, camera, **kw):
    """Hard one-layer renderer for the background dome and the ground
    (reference dbw.py:135-138): faces_per_pixel=1, sigma=0,
    detach_bary=False."""
    return Renderer(
        RendererConfig(image_size=tuple(image_size), faces_per_pixel=1,
                       sigma=0.0, detach_bary=False, **kw),
        camera,
    )


def make_viz_renderer(image_size, camera, supersample=4, shading="raw",
                      background_color=(0.0, 0.0, 0.0), **kw):
    """Antialiased hard renderer for visualization (reference
    renderer.py:56-60): 4x supersampling, K=1, sigma 0, uv-differentiable
    shading, then average pooling."""
    return Renderer(
        RendererConfig(image_size=tuple(image_size), faces_per_pixel=1,
                       sigma=0.0, detach_bary=False, supersample=supersample,
                       shading=shading, background_color=background_color, **kw),
        camera,
    )
