"""The light model of the flat-lit viz renders (PyTorch port of
dbw_tpu/render/shading.py ``_light``): ambient, directional and point
lights, ambient + diffuse (specular is zero in every shipped config).

Lit shading of textured renders from a config (``shading_type``
flat/phong/gouraud, ``vertex_normals``) is not ported: the port's only lit
render is ``Renderer.render_faces_flat``."""

from __future__ import annotations

import torch


def _light(normals, points, R, light_type, light_direction_cam,
           light_location, ambient_color, diffuse_color):
    """Per-row light (..., 3) for unit ``normals`` (..., 3) at ``points``
    seen from a view of rotation R (3, 3). A directional light lives in
    the camera frame and turns into the world with the view; a point light
    sits at a fixed world location."""
    dev, dt = normals.device, normals.dtype
    ambient = torch.as_tensor(ambient_color, dtype=dt, device=dev)
    if light_type == "ambient":
        return ambient.expand(normals.shape)
    if light_type == "directional":
        d_cam = torch.as_tensor(light_direction_cam, dtype=dt, device=dev)
        d_world = d_cam @ R.T  # view -> world for row vectors (R orthogonal)
        d_world = d_world / torch.linalg.vector_norm(d_world).clamp(min=1e-12)
    elif light_type == "point":
        d_world = torch.as_tensor(light_location, dtype=dt, device=dev) - points
        d_world = d_world / torch.linalg.vector_norm(
            d_world, dim=-1, keepdim=True).clamp(min=1e-12)
    else:
        raise NotImplementedError(f"unknown light type: {light_type}")
    lam = torch.clamp((normals * d_world).sum(-1, keepdim=True), min=0.0)
    return ambient + torch.as_tensor(diffuse_color, dtype=dt, device=dev) * lam
