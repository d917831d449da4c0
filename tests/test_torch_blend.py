"""K6, the layered blend's kernel pair (``dbw_torch/csrc/blend.cu``), and
its plain twin ``layered_blend_plain``.

On the CPU: CPU tensors take the plain route bit for bit and launch nothing;
the launch wrappers refuse what the kernels do not take; the kernels'
arithmetic (the front-to-back loop and the closed-form backward's reverse
recurrences, written out in float64 numpy as the kernels run them) equals
autograd through the plain twin, alphas of exactly 0 and 1 included.

On a card (``cuda``): the kernels against the plain twin at K = 1 (the env
pass), 7 (the runtime-K path), 10 (the blocks pass) and 32 (``MAX_K``), on
pixel counts that are no multiple of a block and on the slot-batched
20-view shape; a forward and backward without a host sync, one launch of
each kernel; strided inputs, a misaligned cotangent and an empty input.
This file imports no JAX: ``python -m pytest --noconftest -p no:cacheprovider
-q -m cuda tests/test_torch_blend.py``."""

import numpy as np
import pytest
import torch

from dbw_torch import kernels
from dbw_torch.render import blend

BG = (0.2, 0.5, 1.0)


def _inputs(shape, K, seed, device="cpu", hard=True):
    """Colours in [0, 1), alphas in [0, 1) with a fifth exactly 0 and a
    fifth exactly 1 (``hard``), and an RGBA cotangent."""
    rng = np.random.default_rng(seed)
    colors = rng.random(shape + (K, 3), dtype=np.float32)
    alpha = rng.random(shape + (K,), dtype=np.float32)
    if hard:
        u = rng.random(alpha.shape)
        alpha[u < 0.2] = 0.0
        alpha[u > 0.8] = 1.0
    w = rng.standard_normal(shape + (4,)).astype(np.float32)
    return tuple(torch.from_numpy(x).to(device) for x in (colors, alpha, w))


def _blend_and_grads(fn, colors, alpha, w, dtype=None):
    """fn's RGBA and the gradients of sum(RGBA * w) for colors and alpha."""
    c, a = (t.to(dtype or t.dtype).detach().requires_grad_(True) for t in (colors, alpha))
    out = fn(c, a, BG)
    (out * w.to(out.dtype)).sum().backward()
    return out.detach(), c.grad, a.grad


def _closed_form(colors, alpha, bg, g):
    """The kernels' loops in float64 numpy: RGBA, then (d_colors, d_alpha)
    by the reverse recurrences R_k = a_k c_k + (1 - a_k) R_{k+1} (R_K = bg)
    and U_k = (1 - a_k) U_{k+1} (U_K = 1)."""
    K = alpha.shape[-1]
    c = colors.reshape(-1, K, 3).astype(np.float64)
    a = alpha.reshape(-1, K).astype(np.float64)
    g = g.reshape(-1, 4).astype(np.float64)
    bg = np.asarray(bg, np.float64)
    T = np.ones(len(a))
    Tk, rgb = [], np.zeros((len(a), 3))
    for k in range(K):
        Tk.append(T)
        rgb = rgb + (T * a[:, k])[:, None] * c[:, k]
        T = T * (1.0 - a[:, k])
    out = np.concatenate([rgb + T[:, None] * bg, (1.0 - T)[:, None]], axis=1)
    R, U = np.broadcast_to(bg, (len(a), 3)), np.ones(len(a))
    dc, da = np.empty_like(c), np.empty_like(a)
    for k in reversed(range(K)):
        dc[:, k] = g[:, :3] * (Tk[k] * a[:, k])[:, None]
        da[:, k] = Tk[k] * ((g[:, :3] * (c[:, k] - R)).sum(1) + g[:, 3] * U)
        om = 1.0 - a[:, k]
        R = a[:, k, None] * c[:, k] + om[:, None] * R
        U = om * U
    return (out.reshape(alpha.shape[:-1] + (4,)), dc.reshape(colors.shape),
            da.reshape(alpha.shape))


@pytest.mark.parametrize("K", [1, 7, 10])
def test_cpu_route_is_the_plain_twin_bit_for_bit(K):
    colors, alpha, w = _inputs((3, 5, 7), K, seed=K)
    before = dict(kernels.LAUNCHES)
    got = _blend_and_grads(blend.layered_blend, colors, alpha, w)
    want = _blend_and_grads(blend.layered_blend_plain, colors, alpha, w)
    assert kernels.LAUNCHES == before
    for x, y in zip(got, want):
        assert torch.equal(x, y)


@pytest.mark.parametrize("K", [1, 2, 10, 32])
def test_closed_form_backward_is_autograd_of_the_plain_twin(K):
    """Exact in float64 up to rounding, also where an alpha is exactly 1
    (no division by 1 - a_k) or every alpha of a pixel is 0."""
    colors, alpha, w = _inputs((4, 9), K, seed=10 + K)
    alpha[0] = 0.0
    alpha[1] = 1.0
    out, dc, da = _closed_form(colors.numpy(), alpha.numpy(), BG, w.numpy())
    ref, rc, ra = _blend_and_grads(blend.layered_blend_plain, colors, alpha, w,
                                   dtype=torch.float64)
    np.testing.assert_allclose(out, ref.numpy(), rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(dc, rc.numpy(), rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(da, ra.numpy(), rtol=1e-12, atol=1e-13)


def test_launch_wrappers_refuse_what_the_kernels_do_not_take():
    """Checked before any launch: CPU tensors (no fallback), colours not
    (..., K, 3) beside alpha (..., K), K above MAX_K, a cotangent not
    (..., 4). The background goes to the kernels as three floats."""
    colors, alpha, w = _inputs((4, 5), 3, seed=0)
    before = dict(kernels.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        blend.layered_blend_fwd_cuda(colors, alpha, BG)
    with pytest.raises(ValueError, match="CUDA"):
        blend.layered_blend_bwd_cuda(colors, alpha, w, BG)
    with pytest.raises(ValueError, match="colors"):
        blend.layered_blend_fwd_cuda(colors[..., :2], alpha, BG)
    with pytest.raises(ValueError, match="colors"):
        blend.layered_blend_fwd_cuda(colors[:, :4], alpha, BG)
    big = _inputs((2,), blend.MAX_K + 1, seed=1)
    with pytest.raises(ValueError, match="K <= 32"):
        blend.layered_blend_fwd_cuda(big[0], big[1], BG)
    with pytest.raises(ValueError, match="cotangent"):
        blend.layered_blend_bwd_cuda(colors, alpha, w[..., :3], BG)
    assert kernels.LAUNCHES == before
    assert blend._background([0, 1, 0.25]) == (0.0, 1.0, 0.25)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


CASES = {"K=1, env pass": ((2, 37, 41), 1),
         "K=7, runtime K": ((2, 37, 41), 7),
         "K=10, blocks pass": ((2, 37, 41), 10),
         "K=32, MAX_K": ((3, 29, 31), 32),
         "K=10, 20 slot-batched views": ((20, 300, 400), 10)}


@pytest.mark.cuda
@pytest.mark.parametrize("shape,K", list(CASES.values()), ids=list(CASES))
def test_kernels_match_the_plain_twin(shape, K):
    """Forward within 1e-6 of the plain twin on the card (the scan's tree
    order against the kernel's serial loop); gradients within 1e-5 of the
    largest |gradient| of the plain twin run in float64 on the card."""
    dev = _card()
    colors, alpha, w = _inputs(shape, K, seed=K, device=dev)
    before = dict(kernels.LAUNCHES)
    out, dc, da = _blend_and_grads(blend.layered_blend, colors, alpha, w)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["K6_blend_fwd"] == before["K6_blend_fwd"] + 1
    assert kernels.LAUNCHES["K6_blend_bwd"] == before["K6_blend_bwd"] + 1
    ref = blend.layered_blend_plain(colors, alpha, BG)
    assert float((out - ref).abs().max()) <= 1e-6
    _, rc, ra = _blend_and_grads(blend.layered_blend_plain, colors, alpha, w,
                                 dtype=torch.float64)
    for got, want in ((dc, rc), (da, ra)):
        err = float((got.double() - want).abs().max())
        assert err <= 1e-5 * float(want.abs().max()), err


@pytest.mark.cuda
def test_no_host_sync_and_one_launch_of_each_kernel():
    dev = _card()
    colors, alpha, w = _inputs((4, 30, 40), 10, seed=3, device=dev)
    c, a = colors.requires_grad_(True), alpha.requires_grad_(True)
    blend.layered_blend(c, a, BG).backward(w)  # builds and loads the library
    c.grad = a.grad = None
    torch.cuda.synchronize()
    before = dict(kernels.LAUNCHES)
    torch.cuda.set_sync_debug_mode("error")
    try:
        blend.layered_blend(c, a, BG).backward(w)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    diff = {k: kernels.LAUNCHES[k] - before[k] for k in kernels.LAUNCHES}
    assert diff == {**dict.fromkeys(diff, 0), "K6_blend_fwd": 1, "K6_blend_bwd": 1}
    assert torch.isfinite(c.grad).all() and torch.isfinite(a.grad).all()


@pytest.mark.cuda
def test_strided_inputs_misaligned_cotangent_and_empty_input():
    """Inputs that are views (permuted, sliced) are made contiguous; a
    cotangent at an offset of one float is copied to an aligned buffer; an
    empty input launches nothing."""
    dev = _card()
    colors, alpha, w = _inputs((9, 33), 10, seed=5, device=dev)
    cs = colors.transpose(0, 1).contiguous().transpose(0, 1)
    a_wide = torch.cat([alpha, alpha], dim=-1)[..., :10]
    out, dc, da = _blend_and_grads(blend.layered_blend, cs, a_wide, w)
    ref, rc, ra = _blend_and_grads(blend.layered_blend_plain, colors, alpha, w)
    assert float((out - ref).abs().max()) <= 1e-6
    g = torch.empty(w.numel() + 1, device=dev)[1:].view(w.shape)
    g.copy_(w)
    assert g.data_ptr() % 16
    d_colors, d_alpha = blend.layered_blend_bwd_cuda(colors, alpha, g, BG)
    assert torch.equal(d_colors, dc) and torch.equal(d_alpha, da)
    for got, want in ((dc, rc), (da, ra)):
        assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    before = dict(kernels.LAUNCHES)
    empty = blend.layered_blend(colors[:0], alpha[:0], BG)
    assert empty.shape == (0, 33, 4) and kernels.LAUNCHES == before
