"""Fragment attributes recomputed from selected face ids (PyTorch port of
the part of dbw_tpu/render/interpolate.py ``interpolate_fragments_flat``
that the edge overlays read: the signed edge distance and validity)."""

from __future__ import annotations

import torch

from .cameras import ndc_pixel_centers
from .fragment import signed_edge_dist2


def edge_dists_flat(p2f, geom):
    """Signed squared NDC edge distance and validity of the fragments of
    p2f (B, H, W, K) of the projected faces ``geom`` (xy (B, F, 3, 2)):
    two (B * H * W * K,) tensors, fragment n = ((b * H + row) * W + col)
    * K + k."""
    B, H, W, K = p2f.shape
    F = geom.xy.shape[1]
    p2f = p2f.reshape(B, H * W * K).long()
    ids = p2f.clamp(min=0) + (torch.arange(B, device=p2f.device) * F)[:, None]
    xy = geom.xy.reshape(B * F, 6)[ids.reshape(-1)]
    px, py = ndc_pixel_centers((H, W), p2f.device)
    px = px[None, None, :, None].expand(B, H, W, K).reshape(-1)
    py = py[None, :, None, None].expand(B, H, W, K).reshape(-1)
    return signed_edge_dist2(xy, px, py), (p2f >= 0).reshape(-1)
