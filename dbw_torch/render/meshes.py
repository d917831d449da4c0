"""Static-topology scene mesh and texture atlas (PyTorch port of
dbw_tpu/render/meshes.py: the quad texture samples, ``sample_atlas_bilinear``
and ``face_normals``). The quad sample's forward is K8 (csrc/texel.cu) for
CUDA tensors, its backward the texel-gradient kernel K4.

A scene is a fixed set of flat tensors; dead blocks are collapsed in place,
never removed, so shapes never change during optimization.

A slot-batched scene holds S scenes of one topology (the seed slots of the
batched protocol step): verts (S, V, 3), per-face ``map_idx`` and
``faces_alpha`` (S, F), the faces and uv shared, and one atlas stacked over
the slots, ``map_idx`` indexing it (slot s's maps offset by s * M). Its S * B
views render in one batch, slot s in views s * B .. s * B + B - 1, so each
kernel launches once for every slot.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from .. import kernels
from ..ops.texel_grad import corner_weights, quad_maps_grad
from .fragment import texel_coords


class TextureAtlas(NamedTuple):
    """Stack of equally sized RGB uv maps (M, TH, TW, 3); per-face map index
    selects the map. Bilinear sampling with align_corners=True semantics."""

    maps: torch.Tensor


class MeshScene(NamedTuple):
    verts: torch.Tensor        # (V, 3) f32, world space; slots: (S, V, 3)
    faces: torch.Tensor        # (F, 3) int64
    uv_verts: torch.Tensor     # (VT, 2) f32
    uv_faces: torch.Tensor     # (F, 3) int64 into uv_verts
    map_idx: torch.Tensor      # (F,) int64 into atlas maps; slots: (S, F)
    atlas: TextureAtlas
    faces_alpha: torch.Tensor  # (F,) f32 per-face opacity; slots: (S, F)


def n_slots(scene: MeshScene):
    """S of a slot-batched scene, None for a single scene."""
    return scene.verts.shape[0] if scene.verts.ndim == 3 else None


def per_view(x, n_views):
    """A per-face column (F,) repeated for ``n_views`` views, or a slot's
    row of (S, F) for each of its n_views / S views -> (n_views * F,)."""
    if x.ndim == 1:
        return x.repeat(n_views)
    return x.repeat_interleave(n_views // x.shape[0], dim=0).reshape(-1)


def concat_scenes(scenes: Sequence[MeshScene]) -> MeshScene:
    """Join sub-meshes into one scene; atlases must share their map size.
    Slot-batched parts join slot by slot (their atlases one after the
    other, each ``map_idx`` offset past the atlases before it)."""
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
        v_off += s.verts.shape[-2]
        vt_off += s.uv_verts.shape[0]
        m_off += s.atlas.maps.shape[0]
    per_slot = ("verts", "map_idx", "faces_alpha")
    cat = {k: torch.cat(v, -2 if k == "verts" else -1) if k in per_slot else torch.cat(v, 0)
           for k, v in parts.items()}
    cat["atlas"] = TextureAtlas(cat["atlas"])
    return MeshScene(**cat)


def face_normals(verts, faces):
    """Per-face unit normals (F, 3) (flat shading); (S, F, 3) of slot-batched
    verts (S, V, 3)."""
    v0, v1, v2 = (verts[..., faces[:, k], :] for k in range(3))
    n = torch.linalg.cross(v1 - v0, v2 - v0, dim=-1)
    return n / torch.linalg.vector_norm(n, dim=-1, keepdim=True).clamp(min=1e-12)


def quad_forward_plain(maps_flat, id00, wx, wy, TW):
    """Plain K8: the bilinear sample from the 2x2 texel neighbourhood at base
    texel id00: maps_flat (R, C), id00 (N,) int, wx/wy (N,) -> (N, C).
    Corners past the end of the atlas read zero (they only occur with zero
    weight)."""
    out = 0.0
    for off, w in zip((0, 1, TW, TW + 1), corner_weights(wx, wy)):
        out = out + quad_corner(maps_flat, id00, off) * w[:, None]
    return out


def quad_forward_cuda(maps_flat, id00, wx, wy, TW):
    """K8 kernel launch: the (N, 3) float32 colours of N fragments from an
    (R, 3) float32 atlas, int32 id00 and float32 wx, wy (views are made
    contiguous); equal to ``quad_forward_plain`` bit for bit."""
    N = id00.shape[0]
    if (maps_flat.ndim != 2 or maps_flat.shape[1] != 3 or id00.ndim != 1
            or tuple(wx.shape) != (N,) or tuple(wy.shape) != (N,)
            or (N and not maps_flat.shape[0])):
        raise ValueError(f"quad_forward_cuda: maps_flat {tuple(maps_flat.shape)}, id00 "
                         f"{tuple(id00.shape)}, wx {tuple(wx.shape)}, wy {tuple(wy.shape)}")
    dtypes = (maps_flat.dtype, id00.dtype, wx.dtype, wy.dtype)
    if dtypes != (torch.float32, torch.int32, torch.float32, torch.float32):
        raise ValueError(f"quad_forward_cuda: dtypes {dtypes}, expected float32 maps_flat, "
                         "int32 id00, float32 wx and wy")
    maps_flat, id00, wx, wy = (t.contiguous() for t in (maps_flat, id00, wx, wy))
    ptrs = [kernels.check(maps_flat, torch.float32, "maps_flat"),
            kernels.check(id00, torch.int32, "id00"),
            kernels.check(wx, torch.float32, "wx"),
            kernels.check(wy, torch.float32, "wy")]
    out = torch.empty((N, 3), dtype=torch.float32, device=id00.device)
    kernels.launch("dbw_quad_sample_fwd", "K8_quad_fwd", *ptrs, N, maps_flat.shape[0],
                   int(TW), out.data_ptr())
    return out


def quad_forward(maps_flat, id00, wx, wy, TW):
    """The bilinear quad sample's forward: K8 for CUDA tensors,
    ``quad_forward_plain`` for CPU tensors."""
    if id00.is_cuda:
        return quad_forward_cuda(maps_flat, id00, wx, wy, TW)
    return quad_forward_plain(maps_flat, id00, wx, wy, TW)


class _SampleQuad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, maps_flat, id00, wx, wy, TW, K):
        ctx.save_for_backward(id00, wx, wy)
        ctx.R, ctx.TW, ctx.K = maps_flat.shape[0], TW, K
        return quad_forward(maps_flat, id00, wx, wy, TW)

    @staticmethod
    def backward(ctx, g):
        id00, wx, wy = ctx.saved_tensors
        d = quad_maps_grad(id00, wx, wy, g.contiguous(), ctx.R, ctx.TW, ctx.K)
        return d, None, None, None, None, None


def sample_quad(maps_flat, id00, wx, wy, TW, K):
    """Quad bilinear sample with uv held fixed (the training path);
    d_maps by the texel-gradient kernel (K4). ``K``: the slot count of the
    fragment layout n = pixel * K + slot."""
    return _SampleQuad.apply(maps_flat, id00, wx, wy, TW, K)


class _SampleQuadDiff(torch.autograd.Function):
    @staticmethod
    def forward(ctx, maps_flat, id00, wx, wy, TW, TH, K):
        ctx.save_for_backward(maps_flat, id00, wx, wy)
        ctx.TW, ctx.TH, ctx.K = TW, TH, K
        return quad_forward(maps_flat, id00, wx, wy, TW)

    @staticmethod
    def backward(ctx, g):
        maps_flat, id00, wx, wy = ctx.saved_tensors
        TW, TH = ctx.TW, ctx.TH
        g = g.contiguous()
        d_maps = quad_maps_grad(id00, wx, wy, g, maps_flat.shape[0], TW, ctx.K)
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
        return d_maps, None, d_wx, d_wy, None, None, None


def quad_corner(maps_flat, id00, off):
    """Texel rows id00 + off (N, C); rows past the atlas end read zero."""
    R = maps_flat.shape[0]
    t = id00.long() + off
    q = maps_flat[t.clamp(max=R - 1)]
    return torch.where((t < R)[:, None], q, torch.zeros_like(q)) if off else q


def sample_quad_diff(maps_flat, id00, wx, wy, TW, TH, K):
    """Quad bilinear sample differentiable in the maps and in (wx, wy) (the
    uv-differentiable env pass): d_maps by the texel-gradient kernel (K4),
    d_wx, d_wy analytic from the four corner texels. ``K`` as for
    ``sample_quad``."""
    return _SampleQuadDiff.apply(maps_flat, id00, wx, wy, TW, TH, K)



def sample_atlas_bilinear(maps, map_idx, uv, diff_uv=False, K=1):
    """Bilinear texture lookup with align_corners semantics: maps (M, TH,
    TW, C), map_idx (N,), uv (N, 2) in [0, 1] with v = 0 at the bottom row
    -> (N, C). With ``diff_uv`` the sample is differentiable in uv too
    (``sample_quad_diff``), else in the maps only (``sample_quad``, uv held
    fixed); either way the texel gradient is K4. ``K``: the slot count of
    the fragment layout n = pixel * K + slot."""
    M, TH, TW = maps.shape[:3]
    maps_flat = maps.reshape(M * TH * TW, maps.shape[-1])
    id00, wx, wy = texel_coords(uv[:, 0], uv[:, 1], map_idx, TH, TW)
    if diff_uv:
        return sample_quad_diff(maps_flat, id00, wx, wy, TW, TH, K)
    return sample_quad(maps_flat, id00, wx.detach(), wy.detach(), TW, K)
