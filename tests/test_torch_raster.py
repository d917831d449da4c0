"""K1 (per-pixel top-K face selection): the port's plain version against
the JAX selection (XLA backend, its reference for the TPU kernel), in the
soft and in the hard (K=1, blur 0, env pass) setting, and the CUDA kernel
and its hard specialization against the plain version on a card."""

import copy

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from dbw_tpu.models.dbw import BlocksWorld as JaxBlocksWorld
from dbw_tpu.ops.rotations import look_at_rotation as jax_look_at
from dbw_tpu.render.rasterize import FaceGeom as JaxFaceGeom
from dbw_tpu.render.rasterize import RasterConfig as JaxRasterConfig
from dbw_tpu.render.rasterize import _rasterize_xla
from dbw_tpu.render.rasterize import project_faces as jax_project_faces
from dbw_tpu.render.rasterize import rasterize as jax_rasterize
from dbw_torch.render import rasterize as tr
from dbw_torch.render.cameras import ndc_pixel_centers

# equal on >= 99.9% of slots; every differing slot is a near-tie in depth
MIN_EQUAL = 0.999
TIE_DZ = 1e-6

K_NDC = np.zeros((4, 4), np.float32)
K_NDC[0, 0], K_NDC[1, 1] = 2.8, 2.1
K_NDC[0, 2] = K_NDC[1, 2] = 0.02
K_NDC[2, 3] = K_NDC[3, 2] = 1.0


def _to_torch_geom(jgeoms):
    """Per-view JAX FaceGeoms -> one batched torch FaceGeom."""
    st = lambda f: torch.from_numpy(np.stack([np.asarray(f(g)) for g in jgeoms]))
    return tr.FaceGeom(st(lambda g: g.xy), st(lambda g: g.z), st(lambda g: g.valid))


def _check_selection(got, ref, packed, blur, cfg):
    """got/ref: (B, H, W, K) int32. Equal on >= MIN_EQUAL of the slots, and
    every difference a near-tie of the two faces' depths."""
    assert got.shape == ref.shape
    mism = got != ref
    assert mism.mean() <= 1 - MIN_EQUAL, int(mism.sum())
    if mism.any():
        b, i, j, k = np.nonzero(mism)
        xs, ys = ndc_pixel_centers(cfg.image_size)
        px, py = xs[j][:, None], ys[i][:, None]
        z = [tr._score(px, py, packed[b, np.maximum(sel[b, i, j, k], 0)][:, None],
                       blur, cfg.z_clip, True, True)
             for sel in (got, ref)]
        assert (got[b, i, j, k] >= 0).all() and (ref[b, i, j, k] >= 0).all()
        assert float((z[0] - z[1]).abs().max()) < TIE_DZ


def _scene_geoms(K, B=2, H=24, W=32):
    cfg = dict(mesh=dict(n_blocks=3, txt_size=16, T_range=[0.3, 0.3, 0.3]),
               renderer=dict(faces_per_pixel=K, detach_bary=True, z_clip=0.001),
               rend_optim=dict(decouple_rendering=False))
    jm = JaxBlocksWorld((H, W), backend="xla", **copy.deepcopy(cfg))
    jm.set_camera(K_NDC)
    params = jm.init_params(seed=0)
    scene, _, _ = jm.build_scene(params, jm.phase_for_epoch(0))
    R, T = jax_look_at(3.0, 25.0, jnp.linspace(-40.0, 40.0, B))
    return [jax_project_faces(scene.verts, scene.faces, R[b], T[b], jm.camera,
                              z_clip=0.001) for b in range(B)]


@pytest.mark.parametrize("K", [1, 3, 10])
def test_plain_selection_matches_jax_on_scene(K):
    H, W = 24, 32
    jgeoms = _scene_geoms(K, H=H, W=W)
    blur = float(np.float32(np.log(1.0 / 1e-4 - 1.0)) * np.float32(1e-4))
    jcfg = JaxRasterConfig(image_size=(H, W), faces_per_pixel=K, z_clip=0.001)
    ref = np.stack([np.asarray(jax_rasterize(g, jnp.float32(blur), jcfg))
                    for g in jgeoms])
    cfg = tr.RasterConfig(image_size=(H, W), faces_per_pixel=K, z_clip=0.001)
    geom = _to_torch_geom(jgeoms)
    got = tr.rasterize(geom, blur, cfg).numpy()
    assert got.dtype == np.int32
    assert (got >= 0).any() and (got[..., 0] >= 0).mean() > 0.5
    _check_selection(got, ref, tr.pack_faces(geom), blur, cfg)


def _soup(seed, F=60, H=20, W=28):
    """Random triangles in NDC with view z, some invalid, some behind."""
    rng = np.random.default_rng(seed)
    s = min(H, W)
    xy = rng.uniform(-W / s, W / s, (F, 3, 2)).astype(np.float32) * 0.8
    xy += rng.uniform(-0.5, 0.5, (F, 1, 2)).astype(np.float32)
    z = rng.uniform(0.5, 5.0, (F, 3)).astype(np.float32)
    z[:5, 0] = 1e-3                   # one vertex clamped at the clip plane
    valid = rng.random(F) > 0.1
    return JaxFaceGeom(jnp.asarray(xy), jnp.asarray(z), jnp.asarray(valid))


@pytest.mark.parametrize("seed,K,sigma", [(0, 1, 1e-4), (1, 4, 1e-3),
                                          (2, 8, 3e-3), (3, 2, 0.0)])
def test_plain_selection_matches_jax_on_triangle_soup(seed, K, sigma):
    H, W = 20, 28
    jg = _soup(seed, H=H, W=W)
    blur = float(np.float32(np.log(1.0 / 1e-4 - 1.0)) * np.float32(sigma))
    jcfg = JaxRasterConfig(image_size=(H, W), faces_per_pixel=K, z_clip=0.001)
    ref = np.asarray(jax_rasterize(jg, jnp.float32(blur), jcfg))[None]
    cfg = tr.RasterConfig(image_size=(H, W), faces_per_pixel=K, z_clip=0.001)
    geom = _to_torch_geom([jg])
    got = tr.rasterize(geom, blur, cfg).numpy()
    _check_selection(got, ref, tr.pack_faces(geom), blur, cfg)


def test_ties_go_to_the_lower_face_index():
    """Faces 0 and 2 are the same triangle (equal depth everywhere), face 1
    lies behind them; a covered pixel lists 0, 2, 1 — like the JAX top_k."""
    tri = np.array([[-2.0, -2.0], [3.0, -2.0], [-2.0, 3.0]], np.float32)
    xy = np.stack([tri, tri, tri]).astype(np.float32)
    z = np.array([[2.0, 2.0, 2.0], [3.0, 3.0, 3.0], [2.0, 2.0, 2.0]], np.float32)
    jg = JaxFaceGeom(jnp.asarray(xy), jnp.asarray(z), jnp.ones(3, bool))
    jcfg = JaxRasterConfig(image_size=(4, 6), faces_per_pixel=3, z_clip=0.001)
    ref = np.asarray(jax_rasterize(jg, jnp.float32(0.0), jcfg))
    cfg = tr.RasterConfig(image_size=(4, 6), faces_per_pixel=3, z_clip=0.001)
    got = tr.rasterize(_to_torch_geom([jg]), 0.0, cfg).numpy()[0]
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got[-1, -1], [0, 2, 1])


def test_fewer_faces_than_slots_pads_with_misses():
    jg = _soup(4, F=2, H=8, W=8)
    cfg = tr.RasterConfig(image_size=(8, 8), faces_per_pixel=5, z_clip=0.001)
    got = tr.rasterize(_to_torch_geom([jg]), 0.01, cfg).numpy()
    assert (got[..., 2:] == -1).all()
    jcfg = JaxRasterConfig(image_size=(8, 8), faces_per_pixel=5, z_clip=0.001)
    np.testing.assert_array_equal(
        got[0], np.asarray(jax_rasterize(jg, jnp.float32(0.01), jcfg)))


def _env_geoms(B=2, H=24, W=32):
    """The env scene (dome + ground, 448 faces) of a decoupled model."""
    cfg = dict(mesh=dict(n_blocks=2, txt_size=16, T_range=[0.5, 0.5, 0.5]),
               renderer=dict(faces_per_pixel=4, detach_bary=True, z_clip=0.001),
               rend_optim=dict(decouple_rendering=True))
    jm = JaxBlocksWorld((H, W), backend="xla", **copy.deepcopy(cfg))
    jm.set_camera(K_NDC)
    env, _ = jm.build_env(jm.init_params(seed=0), jm.phase_for_epoch(0))
    R, T = jax_look_at(3.0, 25.0, jnp.linspace(-40.0, 40.0, B))
    return [jax_project_faces(env.verts, env.faces, R[b], T[b], jm.camera,
                              z_clip=0.001) for b in range(B)]


def _tied_soup(seed, H=20, W=28):
    """A triangle soup whose second half repeats the first: every covered
    pixel sees depth ties, which go to the lower face index."""
    g = _soup(seed, F=30, H=H, W=W)
    return JaxFaceGeom(*(jnp.concatenate([a, a]) for a in g))


@pytest.mark.parametrize("scene", ["env", "tied_soup"])
def test_hard_selection_matches_jax(scene):
    """Hard K=1 selection at blur 0 (the env pass) against the JAX XLA
    selection at blur 0."""
    H, W = (24, 32) if scene == "env" else (20, 28)
    jgeoms = _env_geoms(H=H, W=W) if scene == "env" else [_tied_soup(7, H, W)]
    jcfg = JaxRasterConfig(image_size=(H, W), faces_per_pixel=1, z_clip=0.001)
    ref = np.stack([np.asarray(_rasterize_xla(g, jnp.float32(0.0), jcfg))
                    for g in jgeoms])
    cfg = tr.RasterConfig(image_size=(H, W), faces_per_pixel=1, z_clip=0.001)
    geom = _to_torch_geom(jgeoms)
    got = tr.rasterize(geom, 0.0, cfg, hard=True).numpy()
    assert (got[..., 0] >= 0).mean() > (0.99 if scene == "env" else 0.3)
    _check_selection(got, ref, tr.pack_faces(geom), 0.0, cfg)
    if scene == "tied_soup":
        np.testing.assert_array_equal(got, ref)
        assert got.max() < 30        # the repeated faces never win a tie
    with pytest.raises(ValueError):
        tr.rasterize(geom, 1e-3, cfg, hard=True)


@pytest.mark.cuda
def test_cuda_hard_kernel_matches_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for jgeoms, (H, W) in ((_env_geoms(B=3, H=60, W=80), (60, 80)),
                           ([_tied_soup(8, 40, 56)], (40, 56))):
        geom = _to_torch_geom(jgeoms)
        packed = tr.pack_faces(geom)
        cfg = tr.RasterConfig(image_size=(H, W), faces_per_pixel=1, z_clip=0.001)
        ref = tr.rasterize_plain(packed, 0.0, cfg).numpy()
        got = tr.rasterize_cuda(packed.cuda(), 0.0, cfg, hard=True).cpu().numpy()
        _check_selection(got, ref, packed, 0.0, cfg)


@pytest.mark.cuda
@pytest.mark.parametrize("K", [1, 3, 10, 32])
def test_cuda_kernel_matches_plain(K):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    H, W = 40, 56
    geom = _to_torch_geom([_soup(5, F=300, H=H, W=W), _soup(6, F=300, H=H, W=W)])
    packed = tr.pack_faces(geom)
    cfg = tr.RasterConfig(image_size=(H, W), faces_per_pixel=K, z_clip=0.001)
    ref = tr.rasterize_plain(packed, 2e-3, cfg).numpy()
    got = tr.rasterize_cuda(packed.cuda(), 2e-3, cfg).cpu().numpy()
    _check_selection(got, ref, packed, 2e-3, cfg)
