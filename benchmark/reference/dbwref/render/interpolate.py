"""Fragment attributes recomputed from selected face ids (PyTorch port of
dbw_tpu/render/interpolate.py, its flat layout): barycentrics, depth and the
signed squared edge distance of every fragment, as smooth functions of the
projected vertices, so that autograd gives the rasterizer's gradients.

Every quantity is one (M,) component tensor over the fragments of B views,
fragment n = ((b * H + row) * W + col) * K + k, the layout of the training
renderers' streams, or over a selection of them (the lit renderer computes
the valid ones only); no (H, W, K, 3, 2) tensor is formed.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .cameras import ndc_pixel_centers
from .fragment import _bary2d, _clip, signed_edge_dist2


class FlatFragments(NamedTuple):
    idx: torch.Tensor    # (M,) int64 face id within its view, clamped at 0
    view: torch.Tensor   # (M,) int64 view of the fragment
    valid: torch.Tensor  # (M,) bool
    b0: torch.Tensor     # (M,) perspective-corrected, clipped barycentrics
    b1: torch.Tensor
    b2: torch.Tensor
    dists: torch.Tensor  # (M,) signed squared NDC edge distance
    z: torch.Tensor      # (M,)


def gather_rows(table, rows):
    """table[rows] for a (R, C) table and (M,) int64 rows, by
    ``index_select``: its backward adds with ``index_add_``, where a plain
    index's backward sorts the rows and sums each run of equal rows
    serially (seconds on the card for millions of fragments on few
    faces)."""
    return torch.index_select(table, 0, rows)


def interpolate_fragments_flat(p2f, geom, rcfg, detach_bary=False, select=None):
    """The fragments of p2f (B, H, W, K) on the projected faces ``geom``
    (xy (B, F, 3, 2), z (B, F, 3)) in the flat layout: the JAX function's
    numerics, for all views in one stream. ``select``: the (M,) int64
    positions in that stream of the fragments to compute (default all)."""
    B, H, W, K = p2f.shape
    F = geom.xy.shape[1]
    n = (torch.arange(B * H * W * K, device=p2f.device) if select is None else select)
    p = p2f.reshape(-1).long()[n]
    view = n // (H * W * K)
    idx = p.clamp(min=0)
    # per-face corner components: one (B * F, 9) table, one row gather
    tab = gather_rows(torch.cat([geom.xy.reshape(B * F, 6), geom.z.reshape(B * F, 3)],
                                dim=1), idx + view * F)
    xs, ys = ndc_pixel_centers((H, W), p2f.device)
    px, py = xs[(n // K) % W], ys[(n // (K * W)) % H]
    x0, y0, x1, y1, x2, y2 = (tab[:, c] for c in range(6))
    z0, z1, z2 = tab[:, 6], tab[:, 7], tab[:, 8]
    dists = signed_edge_dist2(tab[:, :6], px, py)
    w0, w1, w2 = _bary2d(x0, y0, x1, y1, x2, y2, px, py)
    zero = torch.zeros((), dtype=tab.dtype, device=tab.device)
    b0, b1, b2 = w0, w1, w2
    if rcfg.perspective_correct:
        iw0 = w0 / torch.maximum(z0, zero + 1e-8)
        iw1 = w1 / torch.maximum(z1, zero + 1e-8)
        iw2 = w2 / torch.maximum(z2, zero + 1e-8)
        denom = torch.maximum(iw0 + iw1 + iw2, zero + 1e-12)
        b0, b1, b2 = iw0 / denom, iw1 / denom, iw2 / denom
    if rcfg.clip_barycentric:
        b0, b1, b2 = (_clip(b, zero, zero + 1.0) for b in (b0, b1, b2))
        bs = torch.maximum(b0 + b1 + b2, zero + 1e-6)
        b0, b1, b2 = b0 / bs, b1 / bs, b2 / bs
    if detach_bary:
        b0, b1, b2 = b0.detach(), b1.detach(), b2.detach()
    z = b0 * z0 + b1 * z1 + b2 * z2
    return FlatFragments(idx, view, p >= 0, b0, b1, b2, dists, z)


def interp_corner_table(ff: FlatFragments, corner_table, rows=None):
    """Interpolate per-face corner attributes stored as (F, 3 * C) rows
    (corner-major: [a0 | a1 | a2], each C wide) -> (M, C). ``rows``: the
    table row of each fragment (default its face id)."""
    C = corner_table.shape[1] // 3
    r = gather_rows(corner_table, ff.idx if rows is None else rows)
    return (ff.b0[:, None] * r[:, :C] + ff.b1[:, None] * r[:, C:2 * C]
            + ff.b2[:, None] * r[:, 2 * C:])


def fragment_alpha_flat(ff: FlatFragments, sigma, clip_inside=True):
    """Coverage alpha (N,): hard inside test at sigma 0, else the soft
    edge falloff (exp of the clipped distance, or a sigmoid)."""
    d = ff.dists
    if float(sigma) == 0.0:
        a = (d <= 0.0).to(d.dtype)
    elif clip_inside:
        a = torch.exp(-torch.maximum(d, torch.zeros_like(d)) / max(float(sigma), 1e-20))
    else:
        a = torch.sigmoid(-d / max(float(sigma), 1e-20))
    return a * ff.valid


def edge_dists_flat(p2f, geom):
    """Signed squared NDC edge distance and validity of the fragments of
    p2f (B, H, W, K) of the projected faces ``geom`` (xy (B, F, 3, 2)):
    two (B * H * W * K,) tensors (the edge overlays' part of
    ``interpolate_fragments_flat``)."""
    B, H, W, K = p2f.shape
    F = geom.xy.shape[1]
    p2f = p2f.reshape(B, H * W * K).long()
    ids = p2f.clamp(min=0) + (torch.arange(B, device=p2f.device) * F)[:, None]
    xy = geom.xy.reshape(B * F, 6)[ids.reshape(-1)]
    px, py = ndc_pixel_centers((H, W), p2f.device)
    px = px[None, None, :, None].expand(B, H, W, K).reshape(-1)
    py = py[None, :, None, None].expand(B, H, W, K).reshape(-1)
    return signed_edge_dist2(xy, px, py), (p2f >= 0).reshape(-1)
