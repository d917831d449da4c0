"""Scene building, the soft training render (joint scene: dome + ground +
blocks) and the hard env render (dome + ground, uv-differentiable) of the
PyTorch port against the JAX package, over the curriculum phases."""

import copy

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from dbw_tpu.models.dbw import BlocksWorld as JaxBlocksWorld
from dbw_tpu.ops.rotations import look_at_rotation as jax_look_at
from dbw_tpu.render.meshes import TextureAtlas as JaxTextureAtlas
from dbw_torch.models.dbw import BlocksWorld
from dbw_torch.render.meshes import TextureAtlas
from dbw_torch.render.renderer import make_env_renderer, make_train_renderer

H, W, B = 24, 32, 2
CFG = dict(
    mesh=dict(n_blocks=3, txt_size=16, T_range=[0.3, 0.3, 0.3]),
    renderer=dict(faces_per_pixel=4, detach_bary=True, z_clip=0.001),
    rend_optim=dict(coarse_learning=1500, decimate_txt=750, kill_blocks=True,
                    decouple_rendering=False, opacity_noise=True),
)
K_NDC = np.zeros((4, 4), np.float32)
K_NDC[0, 0], K_NDC[1, 1] = 2.8, 2.1
K_NDC[0, 2] = K_NDC[1, 2] = 0.02
K_NDC[2, 3] = K_NDC[3, 2] = 1.0
# epochs: coarse with texture decimation, coarse, fine (hard face alpha)
EPOCHS = [0, 800, 1600]


@pytest.fixture(scope="module")
def models():
    jm = JaxBlocksWorld((H, W), backend="xla", **copy.deepcopy(CFG))
    jm.set_camera(K_NDC)
    tm = BlocksWorld((H, W), **copy.deepcopy(CFG))
    tm.set_camera(K_NDC)
    return jm, tm


def _scenes(jm, tm, epoch):
    key = jax.random.PRNGKey(epoch)
    jphase = jm.phase_for_epoch(epoch)
    jscene, jaux, jraws = jm.build_scene(jm.init_params(1), jphase, key=key)
    noise = torch.tensor(np.asarray(jax.random.normal(key, (jm.n_blocks,))))
    tphase = tm.phase_for_epoch(epoch)
    tscene, taux, traws = tm.build_scene(tm.init_params(1), tphase, noise=noise)
    return (jscene, jaux, jraws, jphase), (tscene, taux, traws, tphase)


def test_phases_match_jax(models):
    jm, tm = models
    for epoch in EPOCHS + [1799]:
        jp, tp = jm.phase_for_epoch(epoch), tm.phase_for_epoch(epoch)
        for name in jp._fields:
            assert float(getattr(tp, name)) == pytest.approx(
                float(getattr(jp, name))), (epoch, name)


@pytest.mark.parametrize("epoch", EPOCHS)
def test_build_scene_matches_jax(models, epoch):
    (js, jaux, jraws, _), (ts, taux, traws, _) = _scenes(*models, epoch)
    np.testing.assert_allclose(ts.verts.detach().numpy(), np.asarray(js.verts),
                               atol=1e-5)
    for name in ("faces", "uv_faces", "map_idx"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                      np.asarray(getattr(js, name)), err_msg=name)
    np.testing.assert_array_equal(ts.uv_verts.numpy(), np.asarray(js.uv_verts))
    np.testing.assert_allclose(ts.faces_alpha.detach().numpy(),
                               np.asarray(js.faces_alpha), atol=1e-6)
    np.testing.assert_allclose(ts.atlas.maps.detach().numpy(),
                               np.asarray(js.atlas.maps), atol=1e-6)
    for k in ("alpha", "alpha_full", "S", "eps1", "eps2"):
        np.testing.assert_allclose(taux[k].detach().numpy(), np.asarray(jaux[k]),
                                   atol=1e-6, err_msg=k)
    np.testing.assert_array_equal(taux["mask"].numpy(), np.asarray(jaux["mask"]))
    for k in ("bkg", "ground"):
        np.testing.assert_allclose(traws[k].detach().numpy(), np.asarray(jraws[k]),
                                   atol=1e-6)


@pytest.mark.parametrize("epoch", EPOCHS)
def test_soft_render_matches_jax(models, epoch):
    jm, tm = models
    (js, _, _, jphase), (ts, _, _, tphase) = _scenes(jm, tm, epoch)
    R, T = jax_look_at(3.0, 25.0, jnp.linspace(-40.0, 40.0, B))
    ref = np.asarray(jm.renderer.render(js, R, T, sigma=jphase.sigma))
    got = tm.renderer.render(ts, torch.tensor(np.asarray(R)),
                             torch.tensor(np.asarray(T)), sigma=tphase.sigma)
    assert got.shape == (B, H, W, 4)
    np.testing.assert_allclose(got.detach().numpy(), ref, atol=2e-5)
    # the scene covers the frame (dome) and the blocks show up
    assert (ref[..., 3] > 0.99).mean() > 0.9


@pytest.mark.parametrize("epoch", [0, 1600])
def test_env_render_and_grads_match_jax(models, epoch):
    """The hard env render of dome + ground (K=1, sigma 0, detach_bary off)
    and its gradients with respect to the vertices (x, y and z: the depth
    enters the perspective-correct barycentrics) and the texture maps.
    Gradient tolerance: 1e-4 of each leaf's max (the JAX texel gradient
    quantizes the bilinear weights to 1/32767)."""
    jm, tm = models
    jenv, _ = jm.build_env(jm.init_params(2), jm.phase_for_epoch(epoch))
    tenv, _ = tm.build_env(tm.init_params(2), tm.phase_for_epoch(epoch))
    R, T = jax_look_at(3.0, 25.0, jnp.linspace(-40.0, 40.0, B))
    w = np.random.default_rng(epoch).random((B, H, W, 4), np.float32)

    def jf(verts, maps):
        scene = jenv._replace(verts=verts, atlas=JaxTextureAtlas(maps))
        img = jm.renderer_env.render(scene, R, T)
        return jnp.sum(img * w), img

    (_, ref), (jgv, jgm) = jax.value_and_grad(jf, argnums=(0, 1), has_aux=True)(
        jenv.verts, jenv.atlas.maps)
    verts = tenv.verts.detach().clone().requires_grad_(True)
    maps = tenv.atlas.maps.detach().clone().requires_grad_(True)
    img = tm.renderer_env.render(tenv._replace(verts=verts, atlas=TextureAtlas(maps)),
                                 torch.tensor(np.asarray(R)), torch.tensor(np.asarray(T)))
    np.testing.assert_allclose(img.detach().numpy(), np.asarray(ref), atol=2e-5)
    assert (np.asarray(ref)[..., 3] == 1.0).mean() > 0.99   # the dome covers all
    (img * torch.from_numpy(w)).sum().backward()
    for got, want in ((verts.grad, jgv), (maps.grad, jgm)):
        want = np.asarray(want)
        scale = np.abs(want).max()
        assert scale > 0
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4 * scale)
    # the ground's vertices get a gradient along world z too
    nb = jm.statics.bkg_verts.shape[0]
    assert np.abs(np.asarray(jgv)[nb:, 2]).max() > 0


def test_env_renderer_config(models):
    _, tm = models
    cfg = make_env_renderer((H, W), tm.camera).config
    assert (cfg.faces_per_pixel, cfg.sigma, cfg.detach_bary) == (1, 0.0, False)


def test_unported_paths_raise(models):
    jm, tm = models
    with pytest.raises(NotImplementedError):
        make_train_renderer((H, W), tm.camera, shading="flat")
    with pytest.raises(ValueError):
        BlocksWorld((H, W), mesh=dict(n_blocks=2, bogus=1))
    cfg = copy.deepcopy(CFG)
    cfg["renderer"]["cameras"] = dict(name="orthographic")
    m = BlocksWorld((H, W), **cfg)
    with pytest.raises(NotImplementedError):
        m.set_camera(K_NDC)
