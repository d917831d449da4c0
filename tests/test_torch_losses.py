"""Losses, blend, optimizer and config loading of the PyTorch port against
the JAX package."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from dbw_tpu.losses import basic as jbasic
from dbw_tpu.losses import vgg as jvgg
from dbw_tpu.models.dbw import SceneParams
from dbw_tpu.render.blend import layered_blend as jax_layered_blend
from dbw_tpu.train.optimizer import create_optimizer as jax_create_optimizer
from dbw_tpu.utils.config import load_yaml as jax_load_yaml
from dbw_torch.losses import basic as tbasic
from dbw_torch.losses import vgg as tvgg
from dbw_torch.render.blend import layered_blend
from dbw_torch.train.optimizer import create_optimizer
from dbw_torch.utils.config import load_yaml

ATOL = 1e-6


def _grad(fn, x):
    t = torch.tensor(x, requires_grad=True)
    out = fn(t)
    out.backward()
    return float(out.detach()), t.grad.numpy()


def _jgrad(fn, x):
    v, g = jax.value_and_grad(fn)(jnp.asarray(x))
    return float(v), np.asarray(g)


def test_layered_blend_matches_jax_with_hard_alphas():
    """Alphas of exactly 0 and 1 (the fine phase) drive cumprod through
    exact zeros; values and gradients must still match."""
    rng = np.random.default_rng(0)
    colors = rng.random((2, 5, 6, 4, 3)).astype(np.float32)
    alpha = rng.random((2, 5, 6, 4)).astype(np.float32)
    alpha[0, :, :, 1] = 1.0
    alpha[1, :2] = 0.0
    alpha[1, 2:, :, 0] = 1.0
    w = rng.standard_normal((2, 5, 6, 4)).astype(np.float32)
    bg = (0.2, 0.5, 1.0)
    ca = torch.tensor(colors, requires_grad=True)
    aa = torch.tensor(alpha, requires_grad=True)
    out = layered_blend(ca, aa, bg)
    (out * torch.from_numpy(w)).sum().backward()
    jf = lambda c, a: jnp.sum(jax_layered_blend(c, a, bg) * w)
    ref = np.asarray(jax_layered_blend(jnp.asarray(colors), jnp.asarray(alpha), bg))
    gc, ga = jax.grad(jf, argnums=(0, 1))(jnp.asarray(colors), jnp.asarray(alpha))
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=ATOL)
    np.testing.assert_allclose(ca.grad.numpy(), np.asarray(gc), atol=1e-5)
    np.testing.assert_allclose(aa.grad.numpy(), np.asarray(ga), atol=1e-5)


@pytest.mark.parametrize("norm", ["l1", "l2", "l2sq"])
def test_tv_norms_match_jax(norm):
    x = np.random.default_rng(1).standard_normal((3, 7, 5, 3)).astype(np.float32)
    x[0, 0] = 0.0                                     # zero diffs (l2's clamp)
    got = _grad(lambda t: tbasic.tv_norm_funcs[norm](torch.diff(t, dim=1)).mean(), x)
    ref = _jgrad(lambda t: jbasic.tv_norm_funcs[norm](jnp.diff(t, axis=1)).mean(), x)
    assert got[0] == pytest.approx(ref[0], rel=1e-6)
    np.testing.assert_allclose(got[1], ref[1], rtol=1e-5, atol=ATOL)


def test_mse_matches_jax():
    rng = np.random.default_rng(2)
    a, b = rng.random((2, 4, 5, 3), np.float32), rng.random((2, 4, 5, 3), np.float32)
    got = float(tbasic.get_loss("mse")(torch.from_numpy(a), torch.from_numpy(b)))
    assert got == pytest.approx(float(jbasic.mse_loss(a, b)), rel=1e-6)
    with pytest.raises(NotImplementedError):
        tbasic.get_loss("ssim")


def test_random_vgg_filters_equal_jax():
    tv = tvgg.VGG16Features(seed=3)
    jv = jvgg.VGG16Features(seed=3)
    assert not tv.pretrained
    for i, (w, b) in enumerate(jv.weights):
        np.testing.assert_array_equal(
            getattr(tv, f"w{i}").numpy(), np.asarray(w).transpose(3, 2, 0, 1))
        np.testing.assert_array_equal(getattr(tv, f"b{i}").numpy(), np.asarray(b))


def test_vgg_npz_loader_matches_jax(tmp_path):
    ws = jvgg.VGG16Features._random_weights(5)
    rng = np.random.default_rng(6)
    np.savez(tmp_path / "vgg.npz", **{f"w{i}": w for i, (w, _) in enumerate(ws)},
             **{f"b{i}": rng.standard_normal(b.shape).astype(np.float32) * 0.1
                for i, (_, b) in enumerate(ws)})
    path = str(tmp_path / "vgg.npz")
    tv = tvgg.VGG16Features.from_env_or_random(path=path)
    jv = jvgg.VGG16Features.from_env_or_random(path=path, dtype=jnp.float32)
    assert tv.pretrained and jv.pretrained
    x = rng.random((1, 20, 24, 3)).astype(np.float32)
    got = tv(torch.from_numpy(x), 3)
    ref = jv(jnp.asarray(x), 3)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).detach().numpy(),
                                   np.asarray(r), rtol=1e-4, atol=1e-4)
    with pytest.raises(FileNotFoundError):
        tvgg.VGG16Features.from_env_or_random(path=str(tmp_path / "missing.npz"))


@pytest.mark.parametrize("flavor", ["lpips", "perceptual"])
def test_perceptual_losses_match_jax(flavor):
    rng = np.random.default_rng(7)
    imgs = rng.random((2, 32, 40, 3)).astype(np.float32)
    rec = rng.random((2, 32, 40, 3)).astype(np.float32)
    tcls = {"lpips": tvgg.LPIPSLoss, "perceptual": tvgg.PerceptualLoss}[flavor]
    jcls = {"lpips": jvgg.LPIPSLoss, "perceptual": jvgg.PerceptualLoss}[flavor]
    tl = tcls(vgg=tvgg.VGG16Features(seed=0))
    jl = jcls(vgg=jvgg.VGG16Features(seed=0, dtype=jnp.float32))
    got = _grad(lambda r: tl(torch.from_numpy(imgs), r), rec)
    ref = _jgrad(lambda r: jl(jnp.asarray(imgs), r), rec)
    assert got[0] == pytest.approx(ref[0], rel=1e-4)
    scale = np.abs(ref[1]).max()
    np.testing.assert_allclose(got[1], ref[1], rtol=1e-3, atol=1e-4 * scale)


def test_adam_with_texture_group_matches_optax():
    """3 steps of the port's Adam (two learning-rate groups) against the JAX
    package's optax transform with per-group learning rates."""
    cfg = {"training": {"optimizer": {"name": "adam", "lr": 5e-3,
                                      "texture": {"lr": 5e-2}}}}
    rng = np.random.default_rng(8)
    shapes = {"sq_eps": (3, 2), "R_6d_ground": (1, 6), "T_ground": (1, 3),
              "S": (3, 3), "R_6d": (3, 6), "T": (3, 3), "alpha_logit": (3,),
              "texture_bkg": (1, 4, 4, 3), "texture_ground": (1, 4, 4, 3),
              "textures": (3, 4, 4, 3)}
    p0 = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
             for _ in range(3)]
    jp = SceneParams(**{k: jnp.asarray(v) for k, v in p0.items()})
    jopt = jax_create_optimizer(cfg, jp)
    state = jopt.init(jp)
    lrs = {"main": jnp.float32(5e-3), "texture": jnp.float32(5e-2)}
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in p0.items()}
    topt = create_optimizer(cfg, tp)
    assert [g["lr"] for g in topt.param_groups] == [5e-3, 5e-2]
    for g in grads:
        upd, state = jopt.update(SceneParams(**{k: jnp.asarray(v) for k, v in g.items()}),
                                 state, lrs)
        jp = jax.tree_util.tree_map(lambda a, u: a + u, jp, upd)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        topt.step()
    # torch divides by sqrt(v) / sqrt(1 - b2^t) where optax takes
    # sqrt(v / (1 - b2^t)): the updates differ in the last bits
    for k in shapes:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(getattr(jp, k)),
                                   atol=5e-6, err_msg=k)
    with pytest.raises(NotImplementedError):
        create_optimizer({"training": {"optimizer": {"name": "adamw"}}}, tp)


@pytest.mark.parametrize("name", ["synthetic/dtu_shaped.yml", "dtu/scan24.yml"])
def test_config_loading_matches_jax(name):
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "configs" / name
    assert load_yaml(path) == jax_load_yaml(path)
