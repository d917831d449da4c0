"""Static-topology scene mesh and texture atlas (PyTorch port of
dbw_tpu/render/meshes.py, training path).

A scene is a fixed set of flat tensors; dead blocks are collapsed in place,
never removed, so shapes never change during optimization.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from ..ops.texel_grad import corner_weights, quad_maps_grad


class TextureAtlas(NamedTuple):
    """Stack of equally sized RGB uv maps (M, TH, TW, 3); per-face map index
    selects the map. Bilinear sampling with align_corners=True semantics."""

    maps: torch.Tensor


class MeshScene(NamedTuple):
    verts: torch.Tensor        # (V, 3) f32, world space
    faces: torch.Tensor        # (F, 3) int64
    uv_verts: torch.Tensor     # (VT, 2) f32
    uv_faces: torch.Tensor     # (F, 3) int64 into uv_verts
    map_idx: torch.Tensor      # (F,) int64 into atlas maps
    atlas: TextureAtlas
    faces_alpha: torch.Tensor  # (F,) f32 per-face opacity


def concat_scenes(scenes: Sequence[MeshScene]) -> MeshScene:
    """Join sub-meshes into one scene; atlases must share their map size."""
    v_off = vt_off = m_off = 0
    parts = {k: [] for k in MeshScene._fields}
    for s in scenes:
        parts["verts"].append(s.verts)
        parts["faces"].append(s.faces + v_off)
        parts["uv_verts"].append(s.uv_verts)
        parts["uv_faces"].append(s.uv_faces + vt_off)
        parts["map_idx"].append(s.map_idx + m_off)
        parts["atlas"].append(s.atlas.maps)
        parts["faces_alpha"].append(s.faces_alpha)
        v_off += s.verts.shape[0]
        vt_off += s.uv_verts.shape[0]
        m_off += s.atlas.maps.shape[0]
    cat = {k: torch.cat(v, 0) for k, v in parts.items()}
    cat["atlas"] = TextureAtlas(cat["atlas"])
    return MeshScene(**cat)


def quad_forward(maps_flat, id00, wx, wy, TW):
    """Bilinear sample from the 2x2 texel neighbourhood at base texel id00:
    maps_flat (R, C), id00 (N,) int, wx/wy (N,) -> (N, C). Corners past the
    end of the atlas read zero (they only occur with zero weight)."""
    out = 0.0
    for off, w in zip((0, 1, TW, TW + 1), corner_weights(wx, wy)):
        out = out + quad_corner(maps_flat, id00, off) * w[:, None]
    return out


class _SampleQuad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, maps_flat, id00, wx, wy, TW):
        ctx.save_for_backward(id00, wx, wy)
        ctx.R, ctx.TW = maps_flat.shape[0], TW
        return quad_forward(maps_flat, id00, wx, wy, TW)

    @staticmethod
    def backward(ctx, g):
        id00, wx, wy = ctx.saved_tensors
        d = quad_maps_grad(id00, wx, wy, g.contiguous(), ctx.R, ctx.TW)
        return d, None, None, None, None


def sample_quad(maps_flat, id00, wx, wy, TW):
    """Quad bilinear sample with uv held fixed (the training path);
    d_maps by the texel-gradient kernel (K4)."""
    return _SampleQuad.apply(maps_flat, id00, wx, wy, TW)


class _SampleQuadDiff(torch.autograd.Function):
    @staticmethod
    def forward(ctx, maps_flat, id00, wx, wy, TW, TH):
        ctx.save_for_backward(maps_flat, id00, wx, wy)
        ctx.TW, ctx.TH = TW, TH
        return quad_forward(maps_flat, id00, wx, wy, TW)

    @staticmethod
    def backward(ctx, g):
        maps_flat, id00, wx, wy = ctx.saved_tensors
        TW, TH = ctx.TW, ctx.TH
        g = g.contiguous()
        d_maps = quad_maps_grad(id00, wx, wy, g, maps_flat.shape[0], TW)
        # the four corner texels, regathered (a corner past the atlas end has
        # weight 0 and reads as zero)
        q00, q01, q10, q11 = (quad_corner(maps_flat, id00, off)
                              for off in (0, 1, TW, TW + 1))
        d_wx = (g * ((q01 - q00) * (1 - wy)[:, None]
                     + (q11 - q10) * wy[:, None])).sum(-1)
        d_wy = (g * ((q10 - q00) * (1 - wx)[:, None]
                     + (q11 - q01) * wx[:, None])).sum(-1)
        # on the atlas edge (x0 == TW - 1, y0 == TH - 1: uv exactly 1 or 0)
        # the +1 / +TW neighbours lie outside the map with weight 0, and the
        # subgradient is 0, not their difference
        x_edge = (id00 % TW) == TW - 1
        y_edge = ((id00 // TW) % TH) == TH - 1
        d_wx = torch.where(x_edge, torch.zeros_like(d_wx), d_wx)
        d_wy = torch.where(y_edge, torch.zeros_like(d_wy), d_wy)
        return d_maps, None, d_wx, d_wy, None, None


def quad_corner(maps_flat, id00, off):
    """Texel rows id00 + off (N, C); rows past the atlas end read zero."""
    R = maps_flat.shape[0]
    t = id00.long() + off
    q = maps_flat[t.clamp(max=R - 1)]
    return torch.where((t < R)[:, None], q, torch.zeros_like(q)) if off else q


def sample_quad_diff(maps_flat, id00, wx, wy, TW, TH):
    """Quad bilinear sample differentiable in the maps and in (wx, wy) (the
    uv-differentiable env pass): d_maps by the texel-gradient kernel (K4),
    d_wx, d_wy analytic from the four corner texels."""
    return _SampleQuadDiff.apply(maps_flat, id00, wx, wy, TW, TH)

