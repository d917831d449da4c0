"""K7, the LPIPS distance's kernel pair (``dbw_torch/csrc/lpips.cu``), its
plain twin ``lpips_slice_plain`` and the routing of ``LPIPSLoss``.

On the CPU: K7's formula, written out in float64 torch (the per-pixel
norms, the weighted squared difference, the closed-form backward), equals
autograd through the plain LPIPS for every slice width, slot-major
(n = S B) and per view (n = B), with the channel mean and with ``lins``
weights; at a zero feature vector its gradient is the finite a / eps where
the plain twin's autograd gives NaN, and through the ReLU before it both
give the same; the rows of PyTorch's strided channel sum that the backward
reproduces; ``LPIPSLoss`` and ``VGG16Features.forward`` on the CPU equal
the code they had before K7 bit for bit, values and gradients; CPU tensors
launch nothing and the launch wrappers refuse them.

On a card (``cuda``): the kernels against the float64 twin at the slice
shapes of the three benchmark cells (540x960, 300x400, 288x384: odd
heights and widths at the deeper slices), bfloat16 and float32, channels
last; the backward bit for bit autograd's through the plain twin there
(slot-major and per view, the channel mean and ``lins``, thousands of
views' cotangents); a layout the wrapper refuses; a step without a host
sync; five launches of each kernel a step; the loss and its input
gradient against the plain twin. This file imports no JAX: ``python -m pytest --noconftest
-p no:cacheprovider -q -m cuda tests/test_torch_lpips.py``."""

import numpy as np
import pytest
import torch
import torch.nn.functional as Fn

from dbw_torch import kernels
from dbw_torch.losses import vgg

EPS = 1e-10


def _k7_twin(f2, f1, lin, g):
    """K7's forward and backward in closed form, in float64: the (n,)
    distances and the gradient of sum(distances * g) for f2."""
    f2, f1, g = f2.double(), f1.double(), g.double()
    n, C, H, W = f2.shape
    f1 = f1[torch.arange(n) % len(f1)]
    w = (torch.ones(C, dtype=torch.float64) if lin is None else lin.double()).to(f2.device)
    w = w[None, :, None, None]
    scale = 1.0 / (H * W) if lin is not None else 1.0 / (H * W * C)
    r = f2.pow(2).sum(1, keepdim=True).sqrt()
    d2, d1 = r + EPS, f1.pow(2).sum(1, keepdim=True).sqrt() + EPS
    t = f1 / d1 - f2 / d2
    out = (w * t * t).sum((1, 2, 3)) * scale
    a = (-2.0 * scale * g)[:, None, None, None] * w * t
    dot = (a * f2).sum(1, keepdim=True)
    k = torch.where(r > 0, dot / (d2 * d2) / torch.where(r > 0, r, 1.0), 0.0)
    return out, a / d2 - f2 * k


def _plain64(f2, f1, lin):
    """The plain LPIPS of one slice composed of the module's own helpers
    (``_tile``, ``_unit``), in the inputs' dtype (float64 here)."""
    f1 = vgg._tile([f1], len(f2))[0]
    d = (vgg._unit(f1) - vgg._unit(f2)) ** 2
    d = (d * lin.to(d)[None, :, None, None]).sum(1) if lin is not None else d.mean(1)
    return d.reshape(d.shape[0], -1).mean(1)


def _features(shape, seed, device="cpu", dtype=torch.float32, zero_frac=0.3):
    """ReLU-like features (n, C, H, W), channels last, in ``dtype``: a
    third of the values 0, values of bfloat16 precision."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    x[rng.random(shape) < zero_frac] = 0.0
    x = np.abs(x)
    t = torch.from_numpy(x).to(torch.bfloat16).to(dtype)
    return t.to(device).contiguous(memory_format=torch.channels_last)


def _lin(C, seed, device="cpu"):
    return torch.from_numpy(np.random.default_rng(seed).random(C, dtype=np.float32)).to(device)


CASES = [(C, S, lin) for C in vgg.LPIPS_CHANNELS for S in (1, 3) for lin in (False, True)]


@pytest.mark.parametrize("C,S,lin", CASES,
                         ids=[f"C{C}-{'n=SB' if S > 1 else 'n=B'}-{'lins' if lin else 'mean'}"
                              for C, S, lin in CASES])
def test_closed_form_matches_autograd_of_the_plain_lpips(C, S, lin):
    B, H, W = 2, 5, 7
    f2 = _features((S * B, C, H, W), seed=C + S)
    f1 = _features((B, C, H, W), seed=C + S + 1)
    w = _lin(C, seed=C) if lin else None
    g = torch.from_numpy(np.random.default_rng(S).standard_normal(S * B))
    out, grad = _k7_twin(f2, f1, w, g)
    # float64: the closed form is the plain formula's exact gradient
    x = f2.double().requires_grad_(True)
    ref = _plain64(x, f1.double(), w)
    (ref_grad,) = torch.autograd.grad(ref, x, g)
    assert torch.allclose(out, ref, rtol=1e-12, atol=0)
    assert float((grad - ref_grad).abs().max()) <= 1e-12 * float(ref_grad.abs().max())
    # the plain twin in float32 (the CPU path), against the twin
    x32 = f2.clone().requires_grad_(True)
    plain = vgg.lpips_slice_plain(x32, f1, w)
    (plain_grad,) = torch.autograd.grad(plain, x32, g.float())
    assert plain.dtype == torch.float32 and plain.shape == (S * B,)
    assert torch.allclose(plain.double(), out, rtol=1e-5, atol=0)
    assert float((plain_grad.double() - grad).abs().max()) <= 1e-5 * float(grad.abs().max())


def test_zero_feature_vector():
    """A pixel whose channels are all 0 (as a ReLU leaves many): its
    distance is sum_c w_c u1_c^2 on both routes; the closed form's gradient
    there is a / eps, finite, where autograd of the plain twin gives NaN;
    through the ReLU that made the zeros both give 0 there and agree
    elsewhere."""
    C, B = 64, 2
    pre = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2 * B, C, 3, 4)).astype(np.float32)).double()
    pre[1, :, 2, 3] = -torch.rand(C, dtype=torch.float64) - 0.1  # all channels off
    f1 = _features((B, C, 3, 4), seed=1).double()
    g = torch.tensor([0.5, -1.0, 2.0, 1.5], dtype=torch.float64)
    f2 = torch.relu(pre)
    assert float(f2[1, :, 2, 3].abs().max()) == 0.0
    out, grad = _k7_twin(f2, f1, None, g)
    x = f2.clone().requires_grad_(True)
    ref = _plain64(x, f1, None)
    (ref_grad,) = torch.autograd.grad(ref, x, g)
    assert torch.allclose(out, ref, rtol=1e-12, atol=0)
    assert torch.isfinite(grad).all()
    assert torch.isnan(ref_grad[1, :, 2, 3]).all()
    u1 = f1[1 % B, :, 2, 3] / (f1[1 % B, :, 2, 3].norm() + EPS)
    want = -2.0 * g[1] / (3 * 4 * C) * u1 / EPS
    assert torch.allclose(grad[1, :, 2, 3], want, rtol=1e-12)
    mask = torch.ones_like(grad, dtype=torch.bool)
    mask[1, :, 2, 3] = False
    assert torch.allclose(grad[mask], ref_grad[mask], rtol=1e-10, atol=0)
    # through the ReLU
    p = pre.clone().requires_grad_(True)
    (g_twin,) = torch.autograd.grad(torch.relu(p), p, grad)
    (g_plain,) = torch.autograd.grad(_plain64(torch.relu(p), f1, None), p, g)
    assert float(g_twin[1, :, 2, 3].abs().max()) == 0.0
    assert float(g_plain[1, :, 2, 3].abs().max()) == 0.0
    assert float((g_twin - g_plain).abs().max()) <= 1e-12 * float(g_plain.abs().max())


# (pixels, C, HW) -> rows, as ATen's setReduceConfig splits the sum of an
# NCHW float32 tensor over C on the card (confirmed bit for bit there at
# the cells' shapes and at 33x61): 4 rows where HW divides by 4, 8 from
# C = 128 where only by 2, 16 from C = 256 where HW is odd, more for maps
# of a few pixels (at most 32 in K7)
ROWS = {(20 * 518400, 64, 518400): 4, (20 * 1980, 512, 1980): 4,
        (20 * 450, 64, 450): 1, (20 * 450, 128, 450): 8, (4 * 450, 512, 450): 8,
        (20 * 2013, 128, 2013): 1, (20 * 2013, 256, 2013): 16,
        (4096 * 15, 512, 15): 16, (4 * 6, 512, 6): 32, (2 * 3, 64, 3): 1}


@pytest.mark.parametrize("outputs,C,HW", list(ROWS))
def test_strided_rows_follow_atens_reduce_config(outputs, C, HW):
    assert vgg._strided_rows(outputs, C, HW) == ROWS[(outputs, C, HW)]


# ---- the CPU path, bit for bit as it was before K7 ----

def _before_trunk(trunk, x, max_level=5):
    """VGG16Features.forward as it was before K7."""
    x = x.permute(0, 3, 1, 2).to(trunk.dtype)
    feats, conv_i = [], 0
    for c in vgg._CFG:
        if c == "M":
            x = Fn.max_pool2d(x, 2)
            continue
        y = Fn.conv2d(x, getattr(trunk, f"w{conv_i}"), padding=1)
        x = torch.relu(y + getattr(trunk, f"b{conv_i}").to(trunk.dtype)[:, None, None])
        conv_i += 1
        if conv_i in vgg._SLICE_END_CONV:
            feats.append(x.float())
            if len(feats) >= max_level:
                break
    return feats


def _before_unit(f):
    return f / (torch.sqrt((f * f).sum(1, keepdim=True)) + 1e-10)


def _before_lpips(loss, imgs, rec, normalize=True, reduce=True, slots=None):
    """LPIPSLoss.forward as it was before K7."""
    if normalize:
        imgs = imgs * 2.0 - 1.0
        rec = rec * 2.0 - 1.0
    shift, scale = (torch.as_tensor(a, dtype=rec.dtype) for a in (vgg._LPIPS_SHIFT,
                                                                  vgg._LPIPS_SCALE))
    imgs = (imgs - shift) / scale
    rec = (rec - shift) / scale
    with torch.no_grad():
        feats1 = [f if len(f) == len(rec) else f.repeat(len(rec) // len(f), 1, 1, 1)
                  for f in _before_trunk(loss.vgg, imgs, 5)]
    feats2 = _before_trunk(loss.vgg, rec, 5)
    total = 0.0
    for i, (f1, f2) in enumerate(zip(feats1, feats2)):
        d = (_before_unit(f1) - _before_unit(f2)) ** 2
        if loss.lins is not None:
            lin = loss.lins[i].to(d.device, d.dtype)
            d = (d * lin[None, :, None, None]).sum(1)
        else:
            d = d.mean(1)
        total = total + d.reshape(d.shape[0], -1).mean(1)
    if not reduce:
        return total
    return total.mean() if slots is None else total.reshape(slots, -1).mean(1)


def _lins_file(tmp_path):
    path = tmp_path / "lins.npz"
    np.savez(path, **{f"lin{i}": np.random.default_rng(i).random((1, C, 1, 1)).astype(
        np.float32) for i, C in enumerate(vgg.LPIPS_CHANNELS + (512,))})
    return str(path)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("mode", ["slots", "per view", "lins", "no reduce"])
def test_cpu_lpips_unchanged_bit_for_bit(dtype, mode, tmp_path):
    rng = np.random.default_rng(3)
    trunk = vgg.VGG16Features(None, seed=0, device="cpu", dtype=dtype)
    loss = vgg.LPIPSLoss(vgg=trunk, device="cpu",
                         lin_path=_lins_file(tmp_path) if mode == "lins" else None)
    assert (loss.lins is not None) == (mode == "lins")
    n = 4 if mode == "per view" else 6
    imgs = torch.from_numpy(rng.random((n if mode == "per view" else 2, 32, 48, 3),
                                       dtype=np.float32))
    rec0 = torch.from_numpy(rng.random((n, 32, 48, 3), dtype=np.float32))
    kw = dict(slots=3) if mode in ("slots", "lins") else (
        dict(reduce=False) if mode == "no reduce" else {})
    before = dict(kernels.LAUNCHES)
    got = []
    for fn in (loss, lambda *a, **k: _before_lpips(loss, *a, **k)):
        rec = rec0.clone().requires_grad_(True)
        v = fn(imgs, rec, **kw)
        (v * torch.arange(1, v.numel() + 1).reshape(v.shape)).sum().backward()
        got.append((v.detach(), rec.grad))
    assert kernels.LAUNCHES == before
    assert torch.equal(got[0][0], got[1][0]) and torch.equal(got[0][1], got[1][1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_trunk_forward_float32_unchanged(dtype):
    trunk = vgg.VGG16Features(None, seed=1, device="cpu", dtype=dtype)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, 24, 40, 3)).astype(np.float32))
    for level in (3, 5):
        feats, ref = trunk(x, level), _before_trunk(trunk, x, level)
        slices = trunk.slices(x, level)
        assert len(feats) == len(ref) == len(slices) == level
        for f, r, s in zip(feats, ref, slices):
            assert f.dtype == torch.float32 and s.dtype == dtype
            assert torch.equal(f, r) and torch.equal(s.float(), r)


def test_cpu_tensors_launch_nothing_and_the_wrappers_refuse_them():
    f2, f1 = _features((4, 64, 3, 5), seed=0), _features((2, 64, 3, 5), seed=1)
    before = dict(kernels.LAUNCHES)
    assert torch.equal(vgg.lpips_slice(f2, f1), vgg.lpips_slice_plain(f2, f1))
    with pytest.raises(ValueError, match="CUDA"):
        vgg.lpips_slice_fwd_cuda(f2, f1)
    with pytest.raises(ValueError, match="CUDA"):
        vgg.lpips_slice_bwd_cuda(f2, f1, None, torch.ones(4))
    with pytest.raises(ValueError, match="multiple of B"):
        vgg.lpips_slice_fwd_cuda(f2[:3], f1)
    with pytest.raises(ValueError, match="C in"):
        vgg.lpips_slice_fwd_cuda(f2[:, :48], f1[:, :48])
    assert kernels.LAUNCHES == before


# ---- on a card ----

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# the benchmark cells' five slice shapes (H, W, C); 4 renders against 2
# targets (slot-major), views of the cells' sizes
CELLS = {"campanile 540x960": (540, 960), "dtu24 300x400": (300, 400),
         "gundam50 288x384": (288, 384)}


def _slice_shapes(H, W):
    shapes = []
    for C in vgg.LPIPS_CHANNELS + (512,):
        shapes.append((H, W, C))
        H, W = H // 2, W // 2
    return shapes


def _check_against_twin(f2, f1, lin, g, dtype):
    out = vgg.lpips_slice_fwd_cuda(f2, f1, lin)
    grad = vgg.lpips_slice_bwd_cuda(f2, f1, lin, g)
    assert out.dtype == torch.float32 and grad.dtype == dtype
    assert grad.is_contiguous(memory_format=torch.channels_last)
    want, want_grad = _k7_twin(f2, f1, lin, g)
    assert torch.allclose(out.double(), want, rtol=1e-5, atol=0), (out, want)
    err = (grad.double() - want_grad).abs()
    # bfloat16: one rounding of the float32 gradient (2^-9 of it) on top of
    # float32's own error; float32: its error alone
    rel = 2.0 ** -8 if dtype == torch.bfloat16 else 0.0
    bound = rel * want_grad.abs() + 1e-5 * float(want_grad.abs().max())
    assert bool((err <= bound).all()), float((err - bound).max())


@pytest.mark.cuda
@pytest.mark.parametrize("cell", list(CELLS))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_kernels_match_the_twin_at_the_cells_slices(cell, dtype):
    dev = _card()
    for level, (H, W, C) in enumerate(_slice_shapes(*CELLS[cell])):
        f2 = _features((4, C, H, W), seed=level, device=dev, dtype=dtype)
        f1 = _features((2, C, H, W), seed=level + 10, device=dev, dtype=dtype)
        g = torch.randn(4, device=dev, generator=torch.Generator(device=dev).manual_seed(level))
        for lin in (None, _lin(C, seed=level, device=dev)):
            _check_against_twin(f2, f1, lin, g, dtype)
        # per view (n = B) and a zero pixel
        f2[1, :, H - 1, W - 1] = 0
        _check_against_twin(f2[:2], f1, None, g[:2], dtype)
    torch.cuda.synchronize()


def _plain_gradient(f2, f1, lin, g):
    x = f2.detach().clone().requires_grad_(True)
    (ref,) = torch.autograd.grad(vgg.lpips_slice_plain(x, f1, lin), x, g)
    return ref


@pytest.mark.cuda
@pytest.mark.parametrize("cell", list(CELLS))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_backward_is_the_plain_twins_bit_for_bit(cell, dtype):
    """K7's gradient equals autograd's through lpips_slice_plain on the
    card, every bit, but where a pixel's features are all 0 (NaN there on
    the plain route, a finite value here; the ReLU's backward masks both):
    slot-major (the targets tiled) and per view, the channel mean and lins."""
    dev = _card()
    for level, (H, W, C) in enumerate(_slice_shapes(*CELLS[cell])):
        f2 = _features((8, C, H, W), seed=level + 20, device=dev, dtype=dtype)
        f1 = _features((2, C, H, W), seed=level + 30, device=dev, dtype=dtype)
        f2[3, :, H // 2, W // 3] = 0
        g = torch.randn(8, device=dev, generator=torch.Generator(device=dev).manual_seed(level))
        for n, lin in ((8, None), (2, None), (8, _lin(C, seed=level, device=dev))):
            got = vgg.lpips_slice_bwd_cuda(f2[:n], f1, lin, g[:n])
            ref = _plain_gradient(f2[:n], f1, lin, g[:n])
            finite = torch.isfinite(ref)
            assert int((~finite).sum()) == (C if n == 8 else 0)
            assert torch.equal(got[finite], ref[finite]), (cell, level, n, lin is None)
            assert torch.isfinite(got).all()


@pytest.mark.cuda
def test_backward_bit_for_bit_over_many_views():
    """Thousands of views, each with its own cotangent: the mean's backward
    scales each by autograd's float32 1 / HW."""
    dev = _card()
    for C, (H, W) in ((64, (3, 5)), (512, (7, 3))):
        f2 = _features((4096, C, H, W), seed=C, device=dev, dtype=torch.bfloat16)
        f1 = _features((4, C, H, W), seed=C + 1, device=dev, dtype=torch.bfloat16)
        g = torch.randn(4096, device=dev, generator=torch.Generator(device=dev).manual_seed(C))
        got = vgg.lpips_slice_bwd_cuda(f2, f1, None, g)
        ref = _plain_gradient(f2, f1, None, g)
        finite = torch.isfinite(ref)
        assert torch.equal(got[finite], ref[finite])


@pytest.mark.cuda
def test_layouts():
    """Channels-last inputs are read as they are; a contiguous NCHW one and
    a sliced one are refused with the reason, and nothing is copied."""
    dev = _card()
    f2 = _features((4, 128, 9, 11), seed=0, device=dev, dtype=torch.bfloat16)
    f1 = _features((2, 128, 9, 11), seed=1, device=dev, dtype=torch.bfloat16)
    before = dict(kernels.LAUNCHES)
    for bad in (f2.contiguous(), f2[:, :, :, 1:]):
        with pytest.raises(ValueError, match="channels"):
            vgg.lpips_slice_fwd_cuda(bad, f1[:, :, :, :bad.shape[3]])
        with pytest.raises(ValueError, match="channels"):
            vgg.lpips_slice_bwd_cuda(bad, f1[:, :, :, :bad.shape[3]], None,
                                     torch.ones(4, device=dev))
    with pytest.raises(ValueError, match="one dtype"):
        vgg.lpips_slice_fwd_cuda(f2, f1.float())
    assert kernels.LAUNCHES == before
    _check_against_twin(f2, f1, None, torch.ones(4, device=dev), torch.bfloat16)


def _loss_and_inputs(dev, H=64, W=96, S=5, B=4):
    rng = np.random.default_rng(0)
    loss = vgg.LPIPSLoss(vgg=vgg.VGG16Features(None, seed=0, device=dev), device=dev)
    imgs = torch.from_numpy(rng.random((B, H, W, 3), dtype=np.float32)).to(dev)
    rec = torch.from_numpy(rng.random((S * B, H, W, 3), dtype=np.float32)).to(dev)
    return loss, imgs, rec.requires_grad_(True)


@pytest.mark.cuda
def test_no_host_sync_and_five_launches_of_each_kernel_a_step():
    dev = _card()
    loss, imgs, rec = _loss_and_inputs(dev)
    assert loss.vgg.dtype == torch.bfloat16
    loss(imgs, rec, slots=5).sum().backward()  # builds and loads the library
    rec.grad = None
    torch.cuda.synchronize()
    before = dict(kernels.LAUNCHES)
    torch.cuda.set_sync_debug_mode("error")
    try:
        loss(imgs, rec, slots=5).sum().backward()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    diff = {k: kernels.LAUNCHES[k] - before[k] for k in kernels.LAUNCHES}
    assert diff == {**dict.fromkeys(diff, 0), "K7_lpips_fwd": 5, "K7_lpips_bwd": 5}
    assert torch.isfinite(rec.grad).all()
    # the step's counters as profiling.summary() reports them
    assert _recorded_launches(loss, imgs, rec) == (5, 5)


def _recorded_launches(loss, imgs, rec):
    """launches.K7_lpips_fwd and _bwd of one recorded step of the loss."""
    from dbw_torch.utils import profiling

    profiling.reset()
    with profiling.recording(), profiling.step():
        loss(imgs, rec, slots=len(rec) // len(imgs)).sum().backward()
    (row,) = profiling.summary()
    profiling.reset()
    return tuple(row["counters"][f"launches.K7_lpips_{k}"] for k in ("fwd", "bwd"))


def test_cpu_step_counts_no_k7_launch():
    trunk = vgg.VGG16Features(None, seed=0, device="cpu")
    rng = np.random.default_rng(5)
    imgs = torch.from_numpy(rng.random((2, 32, 32, 3), dtype=np.float32))
    rec = torch.from_numpy(rng.random((4, 32, 32, 3), dtype=np.float32)).requires_grad_(True)
    assert _recorded_launches(vgg.LPIPSLoss(vgg=trunk, device="cpu"), imgs, rec) == (0, 0)


@pytest.mark.cuda
def test_loss_and_input_gradient_against_the_plain_twin(monkeypatch):
    """The loss through K7 against the same loss with lpips_slice routed to
    the plain twin on the card: within 1e-5, the renders' gradient within
    1e-2 of its max (the bfloat16 trunk's backward rounds the slice
    gradients, which differ by a bfloat16 rounding here and there)."""
    dev = _card()
    loss, imgs, rec = _loss_and_inputs(dev)
    out = loss(imgs, rec, slots=5)
    (g,) = torch.autograd.grad(out.sum(), rec)
    monkeypatch.setattr(vgg, "lpips_slice", vgg.lpips_slice_plain)
    before = dict(kernels.LAUNCHES)
    ref = loss(imgs, rec, slots=5)
    (g_ref,) = torch.autograd.grad(ref.sum(), rec)
    assert kernels.LAUNCHES == before
    assert torch.allclose(out, ref, rtol=1e-5, atol=0), (out, ref)
    assert float((g - g_ref).abs().max()) <= 1e-2 * float(g_ref.abs().max())
    # under no_grad, per view (the evaluation's call)
    with torch.no_grad():
        monkeypatch.undo()
        per_view = loss(imgs, rec[:4], reduce=False)
        monkeypatch.setattr(vgg, "lpips_slice", vgg.lpips_slice_plain)
        assert torch.allclose(per_view, loss(imgs, rec[:4], reduce=False), rtol=1e-5, atol=0)
