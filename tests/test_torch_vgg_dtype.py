"""The VGG16 features' dtype: bfloat16 on the card and float32 on the CPU
unless asked, with the JAX package's casts (input and filters in dtype,
float32 biases cast at the add, float32 slice outputs)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dbw_tpu.losses import vgg as jvgg
from dbw_torch.losses import vgg as tvgg

# bfloat16 features of the two packages: both round every conv output to
# bfloat16 (8 bits of mantissa, 3.9e-3), from float32 accumulations in
# another order, through 13 layers. Per level, the largest difference
# within 2e-2 of the level's largest feature and the mean difference within
# 1e-2 of the mean feature (measured: 6.9e-3 and 4.6e-3 at worst)
BF16_MAX_REL = 2e-2
BF16_MEAN_REL = 1e-2


def _features(dtype_t, dtype_j, x, seed=0):
    tv = tvgg.VGG16Features(seed=seed, device="cpu", dtype=dtype_t)
    jv = jvgg.VGG16Features(seed=seed, dtype=dtype_j)
    got = [f.permute(0, 2, 3, 1).numpy() for f in tv(torch.from_numpy(x), 5)]
    return tv, got, [np.asarray(f) for f in jv(jnp.asarray(x), 5)]


def test_bf16_features_match_jax_bf16():
    x = np.random.default_rng(0).standard_normal((2, 32, 40, 3)).astype(np.float32)
    tv, got, ref = _features(torch.bfloat16, jnp.bfloat16, x)
    assert tv.dtype == torch.bfloat16 and tv.w0.dtype == torch.bfloat16
    assert tv.b0.dtype == torch.float32  # biases stay float32
    _, f32, _ = _features(torch.float32, jnp.float32, x)
    for lvl, (g, r, f) in enumerate(zip(got, ref, f32), start=1):
        assert g.dtype == np.float32 and g.shape == r.shape, lvl
        d = np.abs(g - r)
        assert d.max() <= BF16_MAX_REL * np.abs(r).max(), (lvl, d.max())
        assert d.mean() <= BF16_MEAN_REL * np.abs(r).mean(), (lvl, d.mean())
        # the features did go through bfloat16: they differ from float32's
        assert np.abs(g - f).max() > 1e-4 * np.abs(f).max(), lvl


@pytest.mark.parametrize("flavor", ["lpips", "perceptual"])
def test_bf16_losses_match_jax_bf16(flavor):
    rng = np.random.default_rng(7)
    imgs = rng.random((2, 32, 40, 3)).astype(np.float32)
    rec = rng.random((2, 32, 40, 3)).astype(np.float32)
    tcls = {"lpips": tvgg.LPIPSLoss, "perceptual": tvgg.PerceptualLoss}[flavor]
    jcls = {"lpips": jvgg.LPIPSLoss, "perceptual": jvgg.PerceptualLoss}[flavor]
    tl = tcls(device="cpu", dtype=torch.bfloat16)
    jl = jcls(vgg=jvgg.VGG16Features(seed=0, dtype=jnp.bfloat16))
    assert tl.vgg.dtype == torch.bfloat16
    got = float(tl(torch.from_numpy(imgs), torch.from_numpy(rec)))
    ref = float(jl(jnp.asarray(imgs), jnp.asarray(rec)))
    # a loss of unit-normalized bfloat16 features: 2e-2 relative
    assert got == pytest.approx(ref, rel=2e-2)


def test_default_dtype_follows_the_device(monkeypatch):
    """float32 on the CPU; bfloat16 for a CUDA device, checked with the
    device resolution monkeypatched (no card here): the weights land on the
    CPU, the dtype is chosen for the device asked for, "cuda"."""
    monkeypatch.delenv("DBW_VGG_WEIGHTS", raising=False)
    assert tvgg.default_dtype("cpu") == torch.float32
    assert tvgg.default_dtype("cuda") == torch.bfloat16
    assert tvgg.VGG16Features(device="cpu").dtype == torch.float32
    assert tvgg.VGG16Features(device="cpu").w3.dtype == torch.float32
    monkeypatch.setattr(tvgg, "resolve_device", lambda d: torch.device("cpu"))
    for build in (tvgg.VGG16Features, tvgg.VGG16Features.from_env_or_random):
        vgg = build(device="cuda")
        assert vgg.dtype == torch.bfloat16 and vgg.w0.dtype == torch.bfloat16
    for cls in (tvgg.PerceptualLoss, tvgg.LPIPSLoss):
        assert cls(device="cuda").vgg.dtype == torch.bfloat16
        assert cls(device="cuda", dtype=torch.float32).vgg.dtype == torch.float32
