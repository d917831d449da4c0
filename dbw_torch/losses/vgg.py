"""VGG16 feature stack, perceptual loss and LPIPS (PyTorch port of
dbw_tpu/losses/vgg.py).

Without pretrained weights the filters fall back to the same seeded He-normal
draw as the JAX package (numpy ``default_rng(seed)``, HWIO), so both sides
compute the same features. Weights are transposed HWIO -> OIHW once at load
time. Images stay NHWC at the public functions; the convolutions take the
NCHW view of them (``permute``), whose memory is channels last, so on the
card cuDNN runs them channels last and the slice outputs are channels last.
Convolutions use ``torch.nn.functional.conv2d`` in the features' ``dtype``:
as in the JAX package, bfloat16 on the card and float32 on the CPU unless
the caller says otherwise. The input and the filters are in ``dtype``, the
biases stay float32 and are cast to ``dtype`` at the add after each
convolution, every conv and ReLU output is in ``dtype``, and each slice
output is returned as float32 by ``forward`` (``slices`` returns them in
``dtype``). Whether float32 convolutions run in TF32 is set by the caller
(``torch.backends.cudnn.allow_tf32``); bfloat16 ones do not read it.

The LPIPS distance of a slice (``lpips_slice``) launches the kernel pair K7
(csrc/lpips.cu: the distance straight from the slice outputs in their
dtype and layout, the targets shared by index, and a closed-form backward)
for CUDA tensors and runs ``lpips_slice_plain``, float32 copies and tiled
targets, for CPU tensors.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as Fn

from .. import kernels
from ..utils.device import DEFAULT_DEVICE, resolve_device

_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M",
        512, 512, 512]
_SLICE_END_CONV = [2, 4, 7, 10, 13]  # relu1_2 relu2_2 relu3_3 relu4_3 relu5_3

_IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
_IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)
_LPIPS_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_LPIPS_SCALE = np.array([0.458, 0.448, 0.450], np.float32)


def default_dtype(device):
    """The features' dtype on ``device`` when none is given: bfloat16 on the
    card, float32 on the CPU (the JAX package's rule, keyed on its
    backend)."""
    return torch.bfloat16 if torch.device(device).type == "cuda" else torch.float32


class VGG16Features(torch.nn.Module):
    """Frozen VGG16 feature extractor, on the card unless ``device`` says
    otherwise, in ``dtype`` (None: ``default_dtype(device)``)."""

    def __init__(self, weights: Optional[List[Tuple[np.ndarray, np.ndarray]]] = None,
                 seed: int = 0, device=DEFAULT_DEVICE, dtype=None):
        super().__init__()
        self.dtype = default_dtype(device) if dtype is None else dtype
        device = resolve_device(device)
        self.pretrained = weights is not None
        if weights is None:
            weights = self.random_weights(seed)
        for i, (w, b) in enumerate(weights):
            w = torch.as_tensor(np.ascontiguousarray(
                np.asarray(w, np.float32).transpose(3, 2, 0, 1)))  # HWIO->OIHW
            self.register_buffer(f"w{i}", w.to(device, self.dtype))
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
    def from_env_or_random(cls, seed=0, path=None, device=DEFAULT_DEVICE, dtype=None):
        path = path or os.environ.get("DBW_VGG_WEIGHTS")
        if path:
            if not os.path.exists(path):
                raise FileNotFoundError(
                    f"VGG weights path {path!r} does not exist")
            loader = cls.load_npz if path.endswith(".npz") else cls.load_torch_state_dict
            return cls(loader(path), device=device, dtype=dtype)
        return cls(None, seed=seed, device=device, dtype=dtype)

    def forward(self, x, max_level=5):
        """x: (B, H, W, 3) normalized -> list of NCHW float32 slice outputs
        [relu1_2, relu2_2, relu3_3, relu4_3, relu5_3][:max_level]."""
        return [f.float() for f in self.slices(x, max_level)]

    def slices(self, x, max_level=5):
        """``forward``'s slice outputs in ``dtype``, as the trunk leaves
        them (channels last for an NHWC-contiguous x)."""
        x = x.permute(0, 3, 1, 2).to(self.dtype)
        feats, conv_i = [], 0
        for c in _CFG:
            if c == "M":
                x = Fn.max_pool2d(x, 2)
                continue
            # the bias is added after the convolution's output is rounded
            # to dtype, as the JAX package adds it
            y = Fn.conv2d(x, getattr(self, f"w{conv_i}"), padding=1)
            x = torch.relu(y + getattr(self, f"b{conv_i}").to(self.dtype)[:, None, None])
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


def _tile(feats, n):
    """Target features of the B views every slot shares, tiled to the n
    views of the slots' renders (slot-major)."""
    return [f if len(f) == n else f.repeat(n // len(f), 1, 1, 1) for f in feats]


def _reduce(per_view, slots):
    """The mean over the views, or the (slots,) means of each slot's."""
    return per_view.mean() if slots is None else per_view.reshape(slots, -1).mean(1)


def lpips_slice_plain(f2, f1, lin=None):
    """The LPIPS distance of one slice, (n,) float32: rendered features f2
    (n, C, H, W) against targets f1 (B, C, H, W), view v against v % B;
    ``lin`` (C,) channel weights, or None for the channel mean. Float32
    copies of both sides, the targets tiled to n views (K7's plain twin)."""
    f1, f2 = _tile([f1.float()], len(f2))[0], f2.float()
    d = (_unit(f1) - _unit(f2)) ** 2
    if lin is not None:
        lin = lin.to(d.device, d.dtype)
        d = (d * lin[None, :, None, None]).sum(1)
    else:
        d = d.mean(1)
    return d.reshape(d.shape[0], -1).mean(1)


LPIPS_CHANNELS = (64, 128, 256, 512)


def _check_slice(f2, f1, lin, name):
    """K7's arguments: f2 (n, C, H, W) and f1 (B, C, H, W) CUDA tensors of
    one dtype (bfloat16 or float32), channels last and dense (a pixel's C
    channels contiguous), n a multiple of B; lin None or (C,) float32."""
    if f2.dim() != 4 or f1.dim() != 4 or f2.shape[1:] != f1.shape[1:] \
            or f2.shape[1] not in LPIPS_CHANNELS or len(f1) == 0 or len(f2) % len(f1):
        raise ValueError(f"{name}: features {tuple(f2.shape)} and targets "
                         f"{tuple(f1.shape)}; want (n, C, H, W) and (B, C, H, W), "
                         f"C in {LPIPS_CHANNELS}, n a multiple of B")
    for t, what in ((f2, "features"), (f1, "targets")):
        if not t.is_cuda or t.dtype not in (torch.bfloat16, torch.float32) \
                or t.dtype != f2.dtype:
            raise ValueError(f"{name}: {what} {t.dtype} on {t.device}; want bfloat16 "
                             "or float32 CUDA tensors of one dtype")
        if not t.is_contiguous(memory_format=torch.channels_last):
            raise ValueError(f"{name}: {what} of strides {t.stride()} are not channels "
                             "last; K7 reads a pixel's channels contiguous, as the "
                             "trunk leaves them, and copies nothing")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {what} are not 16-byte aligned")
    if lin is not None:
        kernels.check(lin, torch.float32, "lin")
        if lin.shape != (f2.shape[1],):
            raise ValueError(f"{name}: weights {tuple(lin.shape)} for C={f2.shape[1]}")
    n, C, H, W = f2.shape
    return n, len(f1), C, H * W


def lpips_slice_fwd_cuda(f2, f1, lin=None):
    """K7 forward launch: lpips_slice_plain's (n,) distances."""
    n, B, C, HW = _check_slice(f2, f1, lin, "lpips_slice_fwd_cuda")
    lib, es = kernels.library(), f2.element_size()
    partial = torch.empty(n * lib.dbw_lpips_chunks(C, es, HW), device=f2.device)
    out = torch.empty(n, device=f2.device)
    scale = 1.0 / HW if lin is not None else 1.0 / (HW * C)
    kernels.launch("dbw_lpips_fwd", "K7_lpips_fwd", f2.data_ptr(), f1.data_ptr(),
                   None if lin is None else lin.data_ptr(), n, B, C, HW, es, scale,
                   partial.data_ptr(), out.data_ptr())
    return out


def lpips_slice_bwd_cuda(f2, f1, lin, g):
    """K7 backward launch: the gradient of sum(lpips_slice(f2, f1, lin) * g)
    for f2, in f2's dtype and layout: bit for bit autograd's through
    lpips_slice_plain on the card, but finite where a pixel's f2 is 0."""
    n, B, C, HW = _check_slice(f2, f1, lin, "lpips_slice_bwd_cuda")
    if g.shape != (n,):
        raise ValueError(f"lpips_slice_bwd_cuda: cotangent {tuple(g.shape)}, want ({n},)")
    g = g.to(torch.float32).contiguous()
    grad = torch.empty_like(f2, memory_format=torch.channels_last)
    # the float32 quotient autograd's mean backward multiplies by
    inv_hw = float(np.float32(1.0) / np.float32(HW))
    kernels.launch("dbw_lpips_bwd", "K7_lpips_bwd", f2.data_ptr(), f1.data_ptr(),
                   None if lin is None else lin.data_ptr(),
                   kernels.check(g, torch.float32, "g"), n, B, C, HW,
                   f2.element_size(), inv_hw, _strided_rows(n * HW, C, HW), grad.data_ptr())
    return grad


def _last_pow2(x):
    return 1 << (int(x).bit_length() - 1)


def _strided_rows(outputs, C, HW):
    """The rows over which PyTorch's CUDA reduction (ATen's
    ``setReduceConfig``) splits a sum over the C channels of an NCHW float32
    tensor of ``outputs`` pixels, HW a view: its block is 512 threads over
    the outputs' vector width (4, 2 or 1, as HW divides), 32 wide at most,
    and its height splits the channels when they reach 16 a row. K7 takes
    at most 32 rows: a map of fewer than 8 vectors of pixels, whose sum
    PyTorch splits further, gets the same sum in another order."""
    vec = 4 if HW % 4 == 0 else 2 if HW % 2 == 0 else 1
    threads = 512 // vec
    dim0 = outputs // vec
    width = min(_last_pow2(dim0) if dim0 < threads else threads, 32)
    height = min(_last_pow2(C) if C < threads else threads, threads // width)
    return min(height, 32) if C >= min(height * 16, 256) else 1


class _LPIPSSlice(torch.autograd.Function):
    @staticmethod
    def forward(ctx, f2, f1, lin):
        ctx.save_for_backward(f2, f1, lin)
        return lpips_slice_fwd_cuda(f2, f1, lin)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        f2, f1, lin = ctx.saved_tensors
        return lpips_slice_bwd_cuda(f2, f1, lin, g), None, None


def lpips_slice(f2, f1, lin=None):
    """The LPIPS distance of one slice, (n,) float32: rendered features f2
    (n, C, H, W) against targets f1 (B, C, H, W), view v against v % B;
    ``lin`` (C,) channel weights, or None for the channel mean. K7 for
    CUDA tensors (the gradient for f2 only), the plain twin for CPU ones."""
    if f2.is_cuda:
        return _LPIPSSlice.apply(f2, f1, lin)
    return lpips_slice_plain(f2, f1, lin)


class PerceptualLoss(torch.nn.Module):
    """VGG16 perceptual loss with channel-normalized features at relu3_3.
    No shipped configuration takes it: it runs the plain float32 code on
    every device (no K7)."""

    def __init__(self, feature_levels=None, normalize_input=True,
                 normalize_features=True, sum_channels=False, vgg=None,
                 device=DEFAULT_DEVICE, dtype=None):
        super().__init__()
        self.feature_levels = list(feature_levels or [3])
        self.max_level = max(self.feature_levels)
        self.normalize_input = normalize_input
        self.normalize_features = normalize_features
        self.sum_channels = sum_channels
        self.vgg = vgg or VGG16Features.from_env_or_random(device=device, dtype=dtype)

    def forward(self, imgs, rec, slots=None):
        """The loss; with ``slots``, the (slots,) losses of the slot-major
        parts of rec (slots * B views, in one VGG call), imgs per view or
        the B views every slot shares."""
        if self.normalize_input:
            mean, std = _const(_IMAGENET_MEAN, rec), _const(_IMAGENET_STD, rec)
            imgs = (imgs - mean) / std
            rec = (rec - mean) / std
        with torch.no_grad():
            feats1 = _tile(self.vgg(imgs, self.max_level), len(rec))
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
        return _reduce(sum(losses), slots)


class LPIPSLoss(torch.nn.Module):
    """LPIPS (VGG flavor) with uniform channel weights unless
    $DBW_LPIPS_WEIGHTS names an .npz of ``lin{i}`` arrays."""

    def __init__(self, vgg=None, lin_path=None, device=DEFAULT_DEVICE, dtype=None):
        super().__init__()
        self.vgg = vgg or VGG16Features.from_env_or_random(device=device, dtype=dtype)
        lin_path = lin_path or os.environ.get("DBW_LPIPS_WEIGHTS")
        self.lins = None
        if lin_path and os.path.exists(lin_path):
            d = np.load(lin_path)
            self.lins = [torch.as_tensor(d[f"lin{i}"]).reshape(-1)
                         for i in range(5)]
        self._card = None

    @property
    def label(self):
        """The name of the eval's LPIPS column: LPIPS only with pretrained
        VGG weights and learned linear heads, else labeled as the
        fallback it is."""
        if not self.vgg.pretrained:
            return "LPIPS_randvgg"
        if self.lins is None:
            return "LPIPS_uniform"
        return "LPIPS"

    def forward(self, imgs, rec, normalize=True, reduce=True, slots=None):
        """LPIPS distance; ``reduce=False`` returns the per-view (B,)
        vector; ``slots``, the (slots,) distances of the slot-major parts of
        rec (slots * B views, in one VGG call), imgs per view or the B views
        every slot shares."""
        if normalize:
            imgs = imgs * 2.0 - 1.0
            rec = rec * 2.0 - 1.0
        if rec.is_cuda:
            shift, scale, lins = self._card_constants(rec)
        else:
            shift, scale = _const(_LPIPS_SHIFT, rec), _const(_LPIPS_SCALE, rec)
            lins = self.lins
        imgs = (imgs - shift) / scale
        rec = (rec - shift) / scale
        with torch.no_grad():
            feats1 = self.vgg.slices(imgs, 5)
        feats2 = self.vgg.slices(rec, 5)
        total = 0.0
        for f1, f2, lin in zip(feats1, feats2, lins or [None] * 5):
            total = total + lpips_slice(f2, f1, lin)
        return _reduce(total, slots) if reduce else total

    def _card_constants(self, like):
        """The input shift and scale in ``like``'s dtype and the channel
        weights (float32, or None), on ``like``'s card: copied there once,
        since a copy from pageable host memory makes the host wait for the
        device."""
        key = (like.device, like.dtype)
        if self._card is None or self._card[0] != key:
            lins = None if self.lins is None else [
                lin.to(like.device, torch.float32).contiguous() for lin in self.lins]
            self._card = (key, _const(_LPIPS_SHIFT, like), _const(_LPIPS_SCALE, like), lins)
        return self._card[1:]
