"""K4 (texture-atlas gradient of the quad bilinear sample): the port's plain
version against ``jax.grad`` through the JAX ``_sample_quad`` in ``quad``
texel mode (its CPU reference), and the CUDA kernel against the plain
version on a card. Also the uv-differentiable sample of the env pass
(``sample_quad_diff`` after ``texel_coords``) against the JAX
``sample_atlas_bilinear(..., diff_uv=True)``."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from dbw_tpu.render import meshes as jmeshes
from dbw_torch.ops import texel_grad as tg
from dbw_torch.render import meshes as tmeshes
from dbw_torch.render.fragment import texel_coords

# the JAX side quantizes wx/wy to 1/32767 (segment_sum_pallas.pack_wxy), so
# gradients agree to rtol 1e-4 (atol 1e-4 of the largest entry for texels
# summed from cancelling contributions)
GRAD_RTOL = 1e-4


def sample_inputs(seed=0, N=6000, M=3, TH=12, TW=20):
    """Fragments with bilinear base texel + offsets, computed from random uv
    exactly as the samplers do (including uv == 0 and 1 at the edges)."""
    rng = np.random.default_rng(seed)
    maps = rng.random((M, TH, TW, 3)).astype(np.float32)
    uv = rng.random((N, 2)).astype(np.float32)
    uv[:50] = np.array([[1.0, 0.0]], np.float32)      # last texel column/row
    uv[50:100, 0] = 0.0
    mi = rng.integers(0, M, N).astype(np.int32)
    u = np.clip(uv[:, 0], 0, 1) * np.float32(TW - 1)
    v = (np.float32(1) - np.clip(uv[:, 1], 0, 1)) * np.float32(TH - 1)
    x0, y0 = np.floor(u), np.floor(v)
    id00 = (mi * (TH * TW) + y0.astype(np.int32) * TW + x0.astype(np.int32)).astype(np.int32)
    g = rng.standard_normal((N, 3)).astype(np.float32)
    g[rng.random(N) < 0.2] = 0.0                      # empty fragments
    return maps.reshape(-1, 3), id00, (u - x0).astype(np.float32), \
        (v - y0).astype(np.float32), g, TW


def test_quad_forward_matches_jax():
    maps_flat, id00, wx, wy, _, TW = sample_inputs(seed=1)
    ref = np.asarray(jmeshes._quad_forward(jnp.asarray(maps_flat), jnp.asarray(id00),
                                           jnp.asarray(wx), jnp.asarray(wy), TW))
    got = tmeshes.quad_forward(torch.from_numpy(maps_flat), torch.from_numpy(id00),
                               torch.from_numpy(wx), torch.from_numpy(wy), TW)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("seed,shape", [(2, (3, 12, 20)), (3, (1, 8, 8)),
                                        (4, (5, 16, 28))])
def test_plain_texel_grad_matches_jax(seed, shape):
    M, TH, TW = shape
    maps_flat, id00, wx, wy, g, TW = sample_inputs(seed=seed, M=M, TH=TH, TW=TW)
    assert jmeshes._texel_mode() == "quad"
    ref = np.asarray(jax.grad(lambda m: jnp.sum(
        jmeshes._sample_quad(m, jnp.asarray(id00), jnp.asarray(wx),
                             jnp.asarray(wy), TW) * g))(jnp.asarray(maps_flat)))
    R = maps_flat.shape[0]
    plain = tg.quad_maps_grad(torch.from_numpy(id00), torch.from_numpy(wx),
                              torch.from_numpy(wy), torch.from_numpy(g), R, TW)
    m = torch.from_numpy(maps_flat).requires_grad_(True)
    out = tmeshes.sample_quad(m, torch.from_numpy(id00), torch.from_numpy(wx),
                              torch.from_numpy(wy), TW)
    out.backward(torch.from_numpy(g))
    scale = np.abs(ref).max()
    for got in (plain.numpy(), m.grad.numpy()):
        np.testing.assert_allclose(got, ref, rtol=GRAD_RTOL, atol=GRAD_RTOL * scale)
    # the uv offsets carry no gradient on this (detached-barycentric) path
    w = torch.from_numpy(wx).requires_grad_(True)
    tmeshes.sample_quad(m, torch.from_numpy(id00), w, torch.from_numpy(wy), TW).sum().backward()
    assert w.grad is None


@pytest.mark.parametrize("seed,shape", [(6, (2, 12, 20)), (7, (1, 8, 8))])
def test_sample_quad_diff_matches_jax(seed, shape):
    """Forward, d_maps (rtol 1e-4: the JAX side quantizes wx/wy in its texel
    gradient) and d_uv, with uv exactly on the atlas edges (0 and 1, where
    the clip splits its gradient and the edge subgradient is 0) and past
    them (clipped: no gradient)."""
    M, TH, TW = shape
    rng = np.random.default_rng(seed)
    N = 3000
    maps = rng.random((M, TH, TW, 3)).astype(np.float32)
    uv = rng.random((N, 2)).astype(np.float32)
    uv[:40] = [[1.0, 0.0]]
    uv[40:80] = [[0.0, 1.0]]
    uv[80:120, 0] = 1.0
    uv[120:160, 1] = 0.0
    uv[160:200] = rng.uniform(-0.3, 1.3, (40, 2))
    mi = rng.integers(0, M, N).astype(np.int32)
    g = rng.standard_normal((N, 3)).astype(np.float32)

    def jf(m, u):
        return jnp.sum(jmeshes.sample_atlas_bilinear(m, jnp.asarray(mi), u,
                                                     diff_uv=True) * g)

    ref = np.asarray(jmeshes.sample_atlas_bilinear(
        jnp.asarray(maps), jnp.asarray(mi), jnp.asarray(uv), diff_uv=True))
    d_maps_ref, d_uv_ref = (np.asarray(a) for a in jax.grad(jf, argnums=(0, 1))(
        jnp.asarray(maps), jnp.asarray(uv)))

    m = torch.from_numpy(maps).requires_grad_(True)
    u = torch.from_numpy(uv).requires_grad_(True)
    id00, wx, wy = texel_coords(u[:, 0], u[:, 1], torch.from_numpy(mi), TH, TW)
    out = tmeshes.sample_quad_diff(m.reshape(-1, 3), id00, wx, wy, TW, TH)
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=1e-6, atol=1e-6)
    out.backward(torch.from_numpy(g))
    scale = np.abs(d_maps_ref).max()
    np.testing.assert_allclose(m.grad.numpy(), d_maps_ref, rtol=GRAD_RTOL,
                               atol=GRAD_RTOL * scale)
    np.testing.assert_allclose(u.grad.numpy(), d_uv_ref, rtol=1e-5,
                               atol=1e-5 * np.abs(d_uv_ref).max())
    # the edge rows are exercised: u == 1 gives d_u == 0, u == 0 half a slope
    assert (u.grad.numpy()[:40, 0] == 0).all()
    assert np.abs(d_uv_ref[40:80, 0]).max() > 0


@pytest.mark.cuda
def test_cuda_kernel_matches_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    maps_flat, id00, wx, wy, g, TW = sample_inputs(seed=5, N=200000, M=4, TH=64, TW=72)
    R = maps_flat.shape[0]
    args = [torch.from_numpy(a) for a in (id00, wx, wy, g)]
    ref = tg.quad_maps_grad_plain(*args, R, TW)
    got = tg.quad_maps_grad_cuda(*[a.cuda() for a in args], R, TW)
    scale = float(ref.abs().max())
    np.testing.assert_allclose(got.cpu().numpy(), ref.numpy(), rtol=1e-5,
                               atol=1e-5 * scale)
