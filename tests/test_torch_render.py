"""Scene building and the soft training render of the PyTorch port against
the JAX package (joint scene: dome + ground + blocks), over the curriculum
phases."""

import copy

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from dbw_tpu.models.dbw import BlocksWorld as JaxBlocksWorld
from dbw_tpu.ops.rotations import look_at_rotation as jax_look_at
from dbw_torch.models.dbw import BlocksWorld
from dbw_torch.render.renderer import make_train_renderer

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


def test_unported_paths_raise(models):
    jm, tm = models
    cfg = copy.deepcopy(CFG)
    cfg["rend_optim"]["decouple_rendering"] = True
    m = BlocksWorld((H, W), **cfg)
    m.set_camera(K_NDC)
    R = torch.eye(3)[None]
    with pytest.raises(NotImplementedError):
        m.predict(m.init_params(0), m.phase_for_epoch(0), R, torch.zeros(1, 3))
    with pytest.raises(NotImplementedError):
        make_train_renderer((H, W), tm.camera, detach_bary=False)
    with pytest.raises(NotImplementedError):
        make_train_renderer((H, W), tm.camera, shading="flat")
    with pytest.raises(ValueError):
        BlocksWorld((H, W), mesh=dict(n_blocks=2, bogus=1))
