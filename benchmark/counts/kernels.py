"""Bytes and floating-point operations of the port's hand-written kernels,
from the shapes of a call, and the least time one H100 SXM could take for
them (NVIDIA's data sheet, dense rates at 700 W): the larger of the bytes
over 3.35 TB/s and the operations over 67 TFLOP/s of float32.

Bytes count each input read once and each output written once. Operations
per fragment (K2, K3, K4) or row (K5) were counted from the expressions of
the port's ``csrc/fragment.cu``, ``texel.cu`` and ``scatter.cu``; K1's are
60 per pixel-face pair inside a valid face's bounding box inflated by the
blur radius (the pairs that pass its tile cull), from ``csrc/raster.cu``.
These are the counts of ``chip_smoke.py``'s bound arithmetic.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12
F32, I32 = 4, 4
TABLE_COLS = 20          # the fragment stage's face table (rows, 20) f32
FLOPS_PER_PAIR = 60
FLOPS_PER_ITEM = {"K2": 140, "K3": 260, "K4": 32, "K5": 12}


def k1_select(B, F, H, W, K, pairs):
    """K1: packed faces (B, F, 16) f32 in, (B, H, W, K) int32 out."""
    return B * F * 16 * F32 + B * H * W * K * I32, pairs * FLOPS_PER_PAIR


def k2_frag_fwd(N, rows):
    """K2: the table, ids (N,) int32, vld/px/py (N,) f32 in; id00 (N,)
    int32 and wx, wy, alpha (N,) f32 out."""
    return rows * TABLE_COLS * F32 + N * (I32 + 3 * F32) + N * (I32 + 3 * F32), \
        N * FLOPS_PER_ITEM["K2"]


def k3_frag_bwd(N, rows):
    """K3: the table, ids, vld/px/py and d_alpha (N,) in; the (rows, 8)
    table cotangent out."""
    return rows * TABLE_COLS * F32 + N * (I32 + 4 * F32) + rows * 8 * F32, \
        N * FLOPS_PER_ITEM["K3"]


def k4_texel_grad(N, R, C=3):
    """K4: id00 (N,) int32, wx, wy (N,) f32 and g (N, C) f32 in; the (R, C)
    atlas cotangent out."""
    return N * (I32 + 2 * F32 + C * F32) + R * C * F32, N * FLOPS_PER_ITEM["K4"]


def k5_small_scatter(N, C, n_rows):
    """K5: idx (N,) int32 and upd (N, C) f32 in; (n_rows, C) out."""
    return N * (I32 + C * F32) + n_rows * C * F32, N * FLOPS_PER_ITEM["K5"]


COUNT = {"K1": k1_select, "K2": k2_frag_fwd, "K3": k3_frag_bwd, "K4": k4_texel_grad,
         "K5": k5_small_scatter}


def bound_s(n_bytes, flops):
    """The least seconds of the card for the work: (seconds, 'bytes' or
    'operations')."""
    t_b, t_o = n_bytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")
