"""Gradient-safe powers (PyTorch port of dbw_tpu/ops/safe_math.py).

Superquadric exponents meet |base| == 0 at mesh vertices on coordinate
planes, where autograd of ``|x|**p`` with respect to ``p`` gives
``0 * log(0)``. Both functions are ``autograd.Function``s with the gradients
of the JAX custom JVPs: the base is clamped to an epsilon in d/dt and the
``log`` argument is clamped so that d/dp is 0 at a zero base.
"""

import torch

SQRT_EPS = 1e-6
_LOG_TINY = 1e-30


def _as_tensor(p, like):
    return torch.as_tensor(p, dtype=like.dtype, device=like.device)


class _SignedPow(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, p):
        a = t.abs()
        out = torch.sign(t) * a**p
        ctx.save_for_backward(t, p, out)
        return out

    @staticmethod
    def backward(ctx, g):
        t, p, out = ctx.saved_tensors
        a = t.abs()
        dt = p * torch.clamp(a, min=SQRT_EPS) ** (p - 1.0)
        dp = out * torch.log(torch.clamp(a, min=_LOG_TINY))
        gt = _reduce_to(g * dt, t.shape) if ctx.needs_input_grad[0] else None
        gp = _reduce_to(g * dp, p.shape) if ctx.needs_input_grad[1] else None
        return gt, gp


class _SafePow(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, p, eps):
        b = torch.clamp(t, min=eps)
        out = b**p
        ctx.save_for_backward(t, p, out)
        ctx.eps = eps
        return out

    @staticmethod
    def backward(ctx, g):
        t, p, out = ctx.saved_tensors
        b = torch.clamp(t, min=ctx.eps)
        dt = torch.where(t > ctx.eps, p * b ** (p - 1.0), torch.zeros_like(b))
        dp = out * torch.log(torch.clamp(b, min=_LOG_TINY))
        gt = _reduce_to(g * dt, t.shape) if ctx.needs_input_grad[0] else None
        gp = _reduce_to(g * dp, p.shape) if ctx.needs_input_grad[1] else None
        return gt, gp, None


def _reduce_to(g, shape):
    """Sum a broadcast gradient back to ``shape``."""
    if g.shape == shape:
        return g
    while g.dim() > len(shape):
        g = g.sum(0)
    for i, n in enumerate(shape):
        if n == 1 and g.shape[i] != 1:
            g = g.sum(i, keepdim=True)
    return g


def signed_pow(t, p):
    """sign(t) * |t|**p with NaN-free gradients at t == 0."""
    return _SignedPow.apply(t, _as_tensor(p, t))


def safe_pow(t, p, eps=SQRT_EPS):
    """clamp(t, eps)**p; d/dt is 0 at or below eps."""
    return _SafePow.apply(t, _as_tensor(p, t), eps)
