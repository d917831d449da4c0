"""VGG16 feature stack, perceptual loss and LPIPS (PyTorch port of
dbw_tpu/losses/vgg.py).

Without pretrained weights the filters fall back to the same seeded He-normal
draw as the JAX package (numpy ``default_rng(seed)``, HWIO), so both sides
compute the same features. Weights are transposed HWIO -> OIHW once at load
time. Images stay NHWC at the public functions; the convolutions run NCHW.
Convolutions use ``torch.nn.functional.conv2d``; whether they run in TF32 is
set by the caller (``torch.backends.cudnn.allow_tf32``).
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as Fn

_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M",
        512, 512, 512]
_SLICE_END_CONV = [2, 4, 7, 10, 13]  # relu1_2 relu2_2 relu3_3 relu4_3 relu5_3

_IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
_IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)
_LPIPS_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_LPIPS_SCALE = np.array([0.458, 0.448, 0.450], np.float32)


class VGG16Features(torch.nn.Module):
    """Frozen VGG16 feature extractor."""

    def __init__(self, weights: Optional[List[Tuple[np.ndarray, np.ndarray]]] = None,
                 seed: int = 0, device=None):
        super().__init__()
        self.pretrained = weights is not None
        if weights is None:
            weights = self.random_weights(seed)
        for i, (w, b) in enumerate(weights):
            w = torch.as_tensor(np.ascontiguousarray(
                np.asarray(w, np.float32).transpose(3, 2, 0, 1)))  # HWIO->OIHW
            self.register_buffer(f"w{i}", w.to(device))
            self.register_buffer(
                f"b{i}", torch.as_tensor(np.asarray(b, np.float32)).to(device))

    @staticmethod
    def random_weights(seed):
        """Seeded He-normal HWIO filters, the JAX package's draw."""
        rng = np.random.default_rng(seed)
        ws, c_in = [], 3
        for c in _CFG:
            if c == "M":
                continue
            fan_in = 3 * 3 * c_in
            w = rng.standard_normal((3, 3, c_in, c)).astype(np.float32) * np.sqrt(
                2.0 / fan_in)
            ws.append((w, np.zeros(c, np.float32)))
            c_in = c
        return ws

    @staticmethod
    def load_torch_state_dict(path):
        """torchvision vgg16 .pth -> list of HWIO (w, b)."""
        sd = torch.load(path, map_location="cpu", weights_only=True)
        ws, li = [], 0
        for c in _CFG:
            if c == "M":
                li += 1
                continue
            w = sd[f"features.{li}.weight"].numpy().transpose(2, 3, 1, 0)
            ws.append((w, sd[f"features.{li}.bias"].numpy()))
            li += 2
        return ws

    @staticmethod
    def load_npz(path):
        d = np.load(path)
        n = sum(1 for c in _CFG if c != "M")
        return [(d[f"w{i}"], d[f"b{i}"]) for i in range(n)]

    @classmethod
    def from_env_or_random(cls, seed=0, path=None, device=None):
        path = path or os.environ.get("DBW_VGG_WEIGHTS")
        if path:
            if not os.path.exists(path):
                raise FileNotFoundError(
                    f"VGG weights path {path!r} does not exist")
            loader = cls.load_npz if path.endswith(".npz") else cls.load_torch_state_dict
            return cls(loader(path), device=device)
        return cls(None, seed=seed, device=device)

    def forward(self, x, max_level=5):
        """x: (B, H, W, 3) normalized -> list of NCHW slice outputs
        [relu1_2, relu2_2, relu3_3, relu4_3, relu5_3][:max_level]."""
        x = x.permute(0, 3, 1, 2)
        feats, conv_i = [], 0
        for c in _CFG:
            if c == "M":
                x = Fn.max_pool2d(x, 2)
                continue
            x = torch.relu(Fn.conv2d(x, getattr(self, f"w{conv_i}"),
                                     getattr(self, f"b{conv_i}"), padding=1))
            conv_i += 1
            if conv_i in _SLICE_END_CONV:
                feats.append(x)
                if len(feats) >= max_level:
                    break
        return feats


def _unit(f):
    # the JAX package's norm (sqrt of the channel sum of squares)
    return f / (torch.sqrt((f * f).sum(1, keepdim=True)) + 1e-10)


def _const(a, like):
    return torch.as_tensor(a, dtype=like.dtype, device=like.device)


class PerceptualLoss(torch.nn.Module):
    """VGG16 perceptual loss with channel-normalized features at relu3_3."""

    def __init__(self, feature_levels=None, normalize_input=True,
                 normalize_features=True, sum_channels=False, vgg=None):
        super().__init__()
        self.feature_levels = list(feature_levels or [3])
        self.max_level = max(self.feature_levels)
        self.normalize_input = normalize_input
        self.normalize_features = normalize_features
        self.sum_channels = sum_channels
        self.vgg = vgg or VGG16Features.from_env_or_random()

    def forward(self, imgs, rec):
        if self.normalize_input:
            mean, std = _const(_IMAGENET_MEAN, rec), _const(_IMAGENET_STD, rec)
            imgs = (imgs - mean) / std
            rec = (rec - mean) / std
        with torch.no_grad():
            feats1 = self.vgg(imgs, self.max_level)
        feats2 = self.vgg(rec, self.max_level)
        losses = []
        for lvl, (f1, f2) in enumerate(zip(feats1, feats2), start=1):
            if lvl not in self.feature_levels:
                continue
            if self.normalize_features:
                f1, f2 = _unit(f1), _unit(f2)
            d = (f1 - f2) ** 2
            if self.sum_channels:
                losses.append(d.sum(1).reshape(d.shape[0], -1).mean(1))
            else:
                losses.append(d.reshape(d.shape[0], -1).mean(1))
        return sum(losses).mean()


class LPIPSLoss(torch.nn.Module):
    """LPIPS (VGG flavor) with uniform channel weights unless
    $DBW_LPIPS_WEIGHTS names an .npz of ``lin{i}`` arrays."""

    def __init__(self, vgg=None, lin_path=None):
        super().__init__()
        self.vgg = vgg or VGG16Features.from_env_or_random()
        lin_path = lin_path or os.environ.get("DBW_LPIPS_WEIGHTS")
        self.lins = None
        if lin_path and os.path.exists(lin_path):
            d = np.load(lin_path)
            self.lins = [torch.as_tensor(d[f"lin{i}"]).reshape(-1)
                         for i in range(5)]

    def forward(self, imgs, rec, normalize=True, reduce=True):
        if normalize:
            imgs = imgs * 2.0 - 1.0
            rec = rec * 2.0 - 1.0
        shift, scale = _const(_LPIPS_SHIFT, rec), _const(_LPIPS_SCALE, rec)
        imgs = (imgs - shift) / scale
        rec = (rec - shift) / scale
        with torch.no_grad():
            feats1 = self.vgg(imgs, 5)
        feats2 = self.vgg(rec, 5)
        total = 0.0
        for i, (f1, f2) in enumerate(zip(feats1, feats2)):
            d = (_unit(f1) - _unit(f2)) ** 2
            if self.lins is not None:
                lin = self.lins[i].to(d.device, d.dtype)
                d = (d * lin[None, :, None, None]).sum(1)
            else:
                d = d.mean(1)
            total = total + d.reshape(d.shape[0], -1).mean(1)
        return total.mean() if reduce else total
