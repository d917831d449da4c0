"""The light model of the lit renders (PyTorch port of
dbw_tpu/render/shading.py): ambient, directional and point lights, ambient +
diffuse (specular is zero in every config), and the area-weighted vertex
normals of gouraud and phong shading. ``Renderer.shade_lit`` applies them
per face (flat), per vertex (gouraud) or per fragment (phong)."""

from __future__ import annotations

import torch


def _light(normals, points, R, light_type, light_direction_cam,
           light_location, ambient_color, diffuse_color, view=None):
    """Per-row light (..., 3) for unit ``normals`` (..., 3) at ``points``
    seen from a view of rotation R (3, 3), or, with ``view`` (the (M,) view
    of each row), from the views R (B, 3, 3). A directional light lives in
    the camera frame and turns into the world with the view; a point light
    sits at a fixed world location."""
    dev, dt = normals.device, normals.dtype
    ambient = torch.as_tensor(ambient_color, dtype=dt, device=dev)
    if light_type == "ambient":
        return ambient.expand(normals.shape)
    if light_type == "directional":
        d_cam = torch.as_tensor(light_direction_cam, dtype=dt, device=dev)
        # view -> world for row vectors (R orthogonal)
        d_world = d_cam @ R.transpose(-1, -2)
        d_world = d_world / torch.linalg.vector_norm(
            d_world, dim=-1, keepdim=True).clamp(min=1e-12)
        if view is not None:
            d_world = torch.index_select(d_world, 0, view)
    elif light_type == "point":
        d_world = torch.as_tensor(light_location, dtype=dt, device=dev) - points
        d_world = d_world / torch.linalg.vector_norm(
            d_world, dim=-1, keepdim=True).clamp(min=1e-12)
    else:
        raise NotImplementedError(f"unknown light type: {light_type}")
    lam = torch.clamp((normals * d_world).sum(-1, keepdim=True), min=0.0)
    return ambient + torch.as_tensor(diffuse_color, dtype=dt, device=dev) * lam


def vertex_normals(verts, faces):
    """Area-weighted unit vertex normals (V, 3): each face's cross product
    added to its three vertices; (S, V, 3) of slot-batched verts."""
    v0, v1, v2 = (verts[..., faces[:, k], :] for k in range(3))
    fn = torch.linalg.cross(v1 - v0, v2 - v0, dim=-1)  # area-weighted
    vn = torch.zeros_like(verts)
    for k in range(3):
        vn = vn.index_add(-2, faces[:, k], fn)
    return vn / torch.linalg.vector_norm(vn, dim=-1, keepdim=True).clamp(min=1e-12)
