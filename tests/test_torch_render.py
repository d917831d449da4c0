"""Scene building, the soft training render (joint scene: dome + ground +
blocks) and the hard env render (dome + ground, uv-differentiable) of the
PyTorch port against the JAX package, over the curriculum phases; and the
pixel-band entry points (``predict(row_range)``, ``forward(row_range,
rec_gather)``) of both rendering branches against the JAX bands and the
port's full render."""

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
    tm = BlocksWorld((H, W), device="cpu", **copy.deepcopy(CFG))
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
    """The port refuses what the JAX package refuses, with the same error
    type: an unknown shading type, an unknown config key, an unknown
    camera; a lit training renderer builds in both."""
    from dbw_tpu.render.renderer import make_train_renderer as jax_train_renderer

    jm, tm = models
    for make, cam in ((make_train_renderer, tm.camera), (jax_train_renderer, jm.camera)):
        with pytest.raises(NotImplementedError, match="shading_type"):
            make((H, W), cam, shading="bogus")
        assert make((H, W), cam, shading="flat").config.shading == "flat"
    with pytest.raises(ValueError):
        BlocksWorld((H, W), device="cpu", mesh=dict(n_blocks=2, bogus=1))
    cfg = copy.deepcopy(CFG)
    cfg["renderer"]["cameras"] = dict(name="orthographic")
    for m in (BlocksWorld((H, W), device="cpu", **copy.deepcopy(cfg)),
              JaxBlocksWorld((H, W), backend="xla", **copy.deepcopy(cfg))):
        with pytest.raises(NotImplementedError, match="camera"):
            m.set_camera(K_NDC)


# pixel bands: H = 24 in bands of 10 rows, the last overhanging the image by
# 6 rows (computed, then cropped)
BANDS = ((0, 10), (10, 10), (20, 10))
BAND_CFG = dict(
    mesh=dict(n_blocks=3, txt_size=16, T_range=[0.3, 0.3, 0.3]),
    renderer=dict(faces_per_pixel=4, detach_bary=True, z_clip=0.001),
    rend_optim=dict(decouple_rendering=True, opacity_noise=True),
    loss=dict(rgb_weight=1, perceptual_weight=0.1, parsimony_weight=0.01,
              tv_weight=0.1),
)


@pytest.fixture(scope="module", params=[True, False], ids=["decoupled", "joint"])
def band_models(request):
    cfg = copy.deepcopy(BAND_CFG)
    cfg["rend_optim"]["decouple_rendering"] = request.param
    jm = JaxBlocksWorld((H, W), backend="xla", **copy.deepcopy(cfg))
    jm.set_camera(K_NDC)
    tm = BlocksWorld((H, W), device="cpu", **copy.deepcopy(cfg))
    tm.set_camera(K_NDC)
    key = jax.random.PRNGKey(4)
    noise = torch.tensor(np.asarray(jax.random.normal(key, (jm.n_blocks,))))
    R, T = jax_look_at(3.0, 25.0, jnp.linspace(-40.0, 40.0, B))
    return jm, tm, key, noise, R, T


def test_band_predict_matches_jax_and_full(band_models):
    """Each band of ``predict(row_range)`` equals the port's full predict's
    rows at atol 1e-6 (the JAX package's own band tolerance,
    tests/test_spatial.py), and the JAX band (a traced row0, one program
    for every band, as the sharded trainers run it) at the full renders'
    port-to-JAX tolerance of this file, 2e-5, on the rows a caller keeps
    (the overhanging band's rows past the image are cropped)."""
    jm, tm, key, noise, R, T = band_models
    jp, tp = jm.init_params(1), tm.init_params(1)
    Rt, Tt = torch.tensor(np.asarray(R)), torch.tensor(np.asarray(T))
    phase = tm.phase_for_epoch(0)
    with torch.no_grad():
        full = tm.predict(tp, phase, Rt, Tt, noise=noise)[0].numpy()
        bands = [tm.predict(tp, phase, Rt, Tt, noise=noise, row_range=rr)[0].numpy()
                 for rr in BANDS]
    jband = jax.jit(lambda row0: jm.predict(jp, jm.phase_for_epoch(0), R, T, key=key,
                                            row_range=(row0, BANDS[0][1]))[0])
    for (row0, Hb), band in zip(BANDS, bands):
        assert band.shape == (B, Hb, W, 3)
        np.testing.assert_allclose(band[:, :H - row0], full[:, row0:row0 + Hb],
                                   atol=1e-6)
        ref = np.asarray(jband(jnp.float32(row0)))
        np.testing.assert_allclose(band[:, :H - row0], ref[:, :H - row0], atol=2e-5)


def test_band_predict_grads_sum_to_full(band_models):
    """Summed band-loss gradients equal the full gradients for a pixel-sum
    objective, at the JAX package's tolerance (atol 2e-4, rtol 1e-4;
    tests/test_spatial.py)."""
    _, tm, _, noise, R, T = band_models
    Rt, Tt = torch.tensor(np.asarray(R)), torch.tensor(np.asarray(T))
    phase = tm.phase_for_epoch(0)
    tgt = torch.from_numpy(np.random.default_rng(0).random((B, H, W, 3), np.float32))

    def grads(row_range):
        params = tm.init_params(1)
        rec = tm.predict(params, phase, Rt, Tt, noise=noise, row_range=row_range)[0]
        row0 = 0 if row_range is None else row_range[0]
        rec = rec[:, :H - row0]
        ((rec - tgt[:, row0:row0 + rec.shape[1]]) ** 2).sum().backward()
        return {k: p.grad.numpy() for k, p in params.items()}

    full = grads(None)
    parts = [grads(rr) for rr in BANDS]
    for k, g in full.items():
        np.testing.assert_allclose(sum(p[k] for p in parts), g, atol=2e-4, rtol=1e-4,
                                   err_msg=k)
    assert np.abs(full["T"]).max() > 0


def test_band_forward_with_rec_gather_matches_full(band_models):
    """``forward`` of the middle band, whose ``rec_gather`` places it among
    the other bands' renders as an all-gather over the bands would: the
    losses (LPIPS, TV and parsimony included) equal the full forward's."""
    _, tm, _, noise, R, T = band_models
    Rt, Tt = torch.tensor(np.asarray(R)), torch.tensor(np.asarray(T))
    phase = tm.phase_for_epoch(0)
    params = tm.init_params(1)
    imgs = torch.from_numpy(np.random.default_rng(1).random((B, H, W, 3), np.float32))
    with torch.no_grad():
        others = [tm.predict(params, phase, Rt, Tt, noise=noise, row_range=rr)[0]
                  for rr in BANDS]
        full = tm.forward(params, phase, imgs, Rt, Tt, opacity_noise=noise)

    def rec_gather(rec):
        assert rec.shape == (B, 10, W, 3) and rec.requires_grad
        return torch.cat([others[0], rec, others[2]], dim=1)[:, :H]

    band = tm.forward(params, phase, imgs, Rt, Tt, opacity_noise=noise,
                      row_range=BANDS[1], rec_gather=rec_gather)
    assert set(band) == set(full) == {"rgb", "perceptual", "parsimony", "tv", "total"}
    for k in full:
        assert float(band[k].detach()) == pytest.approx(float(full[k]), rel=1e-6), k
    band["total"].backward()
    assert params["T"].grad.abs().max() > 0
