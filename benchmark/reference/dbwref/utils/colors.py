"""Block color palette (a copy of dbw_tpu/utils/colors.py): gold followed
by a seaborn-'hls'-style hue wheel, interpolated piecewise linearly, with
no seaborn or matplotlib."""

import colorsys

import numpy as np

_GOLD = (1.0, 0.8431372549019608, 0.0)  # matplotlib 'gold'


def _hls_palette(n=21, h=0.01, l=0.6, s=0.65):  # noqa: E741
    """seaborn.color_palette('hls', n) equivalent."""
    hues = np.linspace(0, 1, n + 1)[:-1]
    hues += h
    hues %= 1
    hues -= hues.astype(int)
    return [colorsys.hls_to_rgb(hue, l, s) for hue in hues]


def _anchor_colors():
    colors = _hls_palette(21)
    return [_GOLD] + colors[3:] + colors[:2]


def fancy_colormap(values):
    """values in [0, 1] -> (len, 3) float32 rgb (LinearSegmentedColormap
    .from_list semantics over the anchor colors)."""
    anchors = np.asarray(_anchor_colors(), dtype=np.float64)
    values = np.atleast_1d(np.asarray(values, dtype=np.float64))
    m = len(anchors)
    x = np.clip(values, 0.0, 1.0) * (m - 1)
    i0 = np.floor(x).astype(int)
    i1 = np.minimum(i0 + 1, m - 1)
    w = (x - i0)[:, None]
    return (anchors[i0] * (1 - w) + anchors[i1] * w).astype(np.float32)
