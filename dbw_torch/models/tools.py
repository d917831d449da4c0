"""Generic NN building blocks (PyTorch port of dbw_tpu/models/tools.py,
reference src/model/tools.py:28-142).

The reference carries MLP, conv, upsample and blur utilities that the
blocks-world model itself never instantiates; they are part of the public
surface. Here the MLP is an ``nn.Module`` and the rest are functions on
NHWC tensors with HWIO conv weights, the JAX package's layouts; the
initial weights are the JAX builders' numpy draws (Kaiming normal from
``np.random.default_rng(seed)``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as Fn
from torch import nn

N_UNITS = 128
N_LAYERS = 3


def count_parameters(module_or_tensors):
    """Total number of scalars of a module's parameters or of a list of
    tensors (None entries skipped)."""
    ts = (module_or_tensors.parameters() if isinstance(module_or_tensors, nn.Module)
          else module_or_tensors)
    return sum(int(t.numel()) for t in ts if t is not None)


def linear_normalize(t):
    m, M = t.min(), t.max()
    return (t - m) / torch.clamp(M - m, min=1e-12)


def _kaiming(rng, shape, fan_in):
    # the product is float64 (a float64 scalar); rounded once to float32,
    # as the JAX builders' jnp.asarray rounds it
    w = rng.standard_normal(shape).astype(np.float32) * np.sqrt(2.0 / fan_in)
    return w.astype(np.float32)


class MLP(nn.Module):
    """ReLU hidden layers; ``forward`` is the JAX builder's ``apply``."""

    def __init__(self, weights):
        super().__init__()
        self.layers = nn.ModuleList()
        for w, b in weights:
            lin = nn.Linear(w.shape[0], w.shape[1], bias=b is not None)
            with torch.no_grad():
                lin.weight.copy_(torch.from_numpy(np.ascontiguousarray(w.T)))
                if b is not None:
                    lin.bias.copy_(torch.from_numpy(b))
            self.layers.append(lin)

    def forward(self, x):
        for i, lin in enumerate(self.layers):
            x = lin(x)
            if i < len(self.layers) - 1:
                x = torch.relu(x)
        return x


def create_mlp(in_ch, out_ch, n_units=N_UNITS, n_layers=N_LAYERS, seed=0,
               zero_last_init=False, bias_last=True):
    """MLP builder (reference tools.py:50-81): ReLU hidden layers, Kaiming
    init, optionally a zeroed (or ``zero_last_init``-scaled) last layer."""
    rng = np.random.default_rng(seed)
    dims = ([in_ch] + [n_units] * n_layers + [out_ch] if n_layers > 0
            else [in_ch, out_ch])
    weights = []
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        w = _kaiming(rng, (a, b), a)
        if zero_last_init and i == len(dims) - 2:
            w = (np.zeros_like(w) if isinstance(zero_last_init, bool)
                 else rng.standard_normal(w.shape).astype(np.float32) * zero_last_init)
        weights.append((w, np.zeros(b, np.float32)))
    if not bias_last:
        weights[-1] = (weights[-1][0], None)
    return MLP(weights)


def conv2d(x, w, b=None, stride=1, padding=1, groups=1):
    """NHWC conv with HWIO weights (reference conv3x3/conv1x1 semantics)."""
    y = Fn.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), stride=stride,
                  padding=padding, groups=groups).permute(0, 2, 3, 1)
    return y if b is None else y + b


def make_conv3x3(in_planes, out_planes, seed=0, zero_init=False):
    rng = np.random.default_rng(seed)
    w = _kaiming(rng, (3, 3, in_planes, out_planes), 9 * in_planes)
    if zero_init:
        w = np.zeros_like(w)
    return torch.from_numpy(w)


def make_conv1x1(in_planes, out_planes, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(_kaiming(rng, (1, 1, in_planes, out_planes), in_planes))


def blur3x3(x):
    """[1, 2, 1] separable blur with reflect padding on NHWC images
    (reference Blur module, tools.py:117-131)."""
    k = np.array([1.0, 2.0, 1.0])
    k2 = np.outer(k, k)
    k2 = torch.as_tensor((k2 / k2.sum()).astype(np.float32), device=x.device)
    C = x.shape[-1]
    xp = Fn.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect")
    return Fn.conv2d(xp, k2[None, None].expand(C, 1, 3, 3), groups=C).permute(0, 2, 3, 1)


def upsample2x(x, mode="nn"):
    """2x upsampling of NHWC images: 'nn' | 'bilinear' | 'bilinear_blur'
    (reference tools.py:134-142; bilinear with half-pixel centres, as
    jax.image.resize)."""
    if mode == "nn":
        return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    up = Fn.interpolate(x.permute(0, 3, 1, 2), scale_factor=2, mode="bilinear",
                        align_corners=False).permute(0, 2, 3, 1)
    if mode == "bilinear_blur":
        up = blur3x3(up)
    return up
