"""Training renderers: project -> select (K1) -> fragment stage -> quad
texture sample -> layered blend.

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

Lit shading, the viz renderers and ``render_faces_flat`` are not ported yet.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..ops.scatter import gather_rows_partial
from .blend import layered_blend
from .cameras import Camera, ndc_pixel_centers
from .fragment import (FragFlags, alpha_math, bary_uv, fused_fragment_shade,
                       residual, texel_coords)
from .meshes import MeshScene, sample_quad, sample_quad_diff
from .rasterize import RasterConfig, project_faces, rasterize

# blur_radius = log(1/1e-4 - 1) * sigma (reference renderer.py:51)
BLUR_RADIUS_FACTOR = math.log(1.0 / 1e-4 - 1.0)


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
    z_clip: float = 1e-3

    def raster_config(self):
        return RasterConfig(image_size=tuple(self.image_size),
                            faces_per_pixel=self.faces_per_pixel,
                            z_clip=self.z_clip)


class Renderer:
    """Stateless given (config, camera)."""

    def __init__(self, config: RendererConfig, camera: Camera):
        if config.shading != "raw":
            raise NotImplementedError(
                f"shading_type {config.shading!r}: only 'raw' is ported")
        self.config = config
        self.camera = camera

    def sigma_blur(self, sigma=None):
        sigma = f32(self.config.sigma if sigma is None else sigma)
        return sigma, f32(np.float32(BLUR_RADIUS_FACTOR) * np.float32(sigma))

    def render(self, scene: MeshScene, R, T, sigma=None):
        """R (B, 3, 3), T (B, 3) -> RGBA (B, H, W, 4). With no ``sigma``
        and a config sigma of 0 (the env renderer) the selection takes its
        hard specialization, as the JAX package decides it."""
        cfg = self.config
        hard = sigma is None and float(cfg.sigma) == 0.0
        sigma, blur = self.sigma_blur(sigma)
        geom = project_faces(scene.verts, scene.faces, R, T, self.camera,
                             z_clip=cfg.z_clip)
        p2f = rasterize(geom, blur, cfg.raster_config(), hard=hard)
        return self.shade(scene, geom, p2f, sigma)

    def shade(self, scene: MeshScene, geom, p2f, sigma):
        """Fragment stage + texture sample + blend for selected faces p2f
        (B, H, W, K)."""
        cfg = self.config
        B, H, W, K = p2f.shape
        maps = scene.atlas.maps
        M, TH, TW = maps.shape[:3]
        maps_flat = maps.reshape(M * TH * TW, 3)
        if cfg.detach_bary:
            table, ids, vld, px, py = fragment_streams(scene, geom, p2f)
            flags = FragFlags(True, True, cfg.clip_inside, TH, TW)
            id00, wx, wy, alpha = fused_fragment_shade(table, ids, vld, px, py,
                                                       sigma, flags)
            colors = sample_quad(maps_flat, id00, wx, wy, TW)
        else:
            table, ids, vld, px, py = fragment_streams(scene, geom, p2f,
                                                       detach_z=False)
            # empty slots read row 0 and scatter nothing back
            rows = gather_rows_partial(
                table, torch.where(vld > 0, ids, torch.full_like(ids, -1)), 12)
            alpha = alpha_math(residual(rows), px, py, vld, sigma,
                               cfg.clip_inside)
            rcfg = cfg.raster_config()
            uv_u, uv_v = bary_uv(rows, px, py, rcfg.perspective_correct,
                                 rcfg.clip_barycentric)
            id00, wx, wy = texel_coords(uv_u, uv_v, rows[:, 18], TH, TW)
            colors = sample_quad_diff(maps_flat, id00, wx, wy, TW, TH)
        if cfg.ambient_color is not None:
            colors = colors * torch.as_tensor(cfg.ambient_color,
                                              device=colors.device)
        return layered_blend(colors.reshape(B, H, W, K, 3),
                             alpha.reshape(B, H, W, K), cfg.background_color)


def fragment_streams(scene: MeshScene, geom, p2f, detach_z=True):
    """The fragment stage's inputs for B views: the (B * F, 20) face table
    and the per-fragment row ids (int32), validity and pixel NDC centers.
    The fused stage (K3) gives z no cotangent, so z is detached there;
    the uv-differentiable stage keeps it (``detach_z=False``)."""
    B, H, W, K = p2f.shape
    F = scene.faces.shape[0]
    N = H * W * K
    dev = p2f.device
    # one face table per view: gradient-carrying columns (vertex xy, z
    # unless detached, face alpha) and gradient-free ones (uv corners, map
    # index)
    stat = torch.cat([
        scene.uv_verts[scene.uv_faces].reshape(F, 6),
        scene.map_idx[:, None].to(torch.float32),
        torch.zeros(F, 1, device=dev),
    ], dim=1).detach()
    z = geom.z.reshape(B * F, 3)
    table = torch.cat([
        geom.xy.reshape(B * F, 6),
        z.detach() if detach_z else z,
        scene.faces_alpha.repeat(B)[:, None],
        torch.zeros(B * F, 2, device=dev),
        stat.repeat(B, 1),
    ], dim=1).contiguous()

    view_off = torch.arange(B, device=dev, dtype=torch.int32) * F
    # empty slots read row 0 of their view with vld = 0
    ids = (p2f.clamp(min=0) + view_off[:, None, None, None]).reshape(B * N)
    vld = (p2f.reshape(B * N) >= 0).to(torch.float32)
    px, py = ndc_pixel_centers((H, W), dev)
    px = px[None, None, :, None].expand(B, H, W, K).reshape(B * N)
    py = py[None, :, None, None].expand(B, H, W, K).reshape(B * N)
    return table, ids.to(torch.int32).contiguous(), vld, px, py


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

