"""The config surface of the renderers in the PyTorch port against the JAX
package on the CPU: lit shading (flat, gouraud, phong) under ambient,
directional and point lights, with ``detach_bary`` on and off, its images
(its gradients: test_torch_lit_grads.py); the fov camera's intrinsics;
the registries' errors.
The cases follow the JAX package's own (tests/test_render_extras.py,
TestShadingTypesAndRegistries)."""

import copy

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from dbw_tpu.models.dbw import BlocksWorld as JaxBlocksWorld
from dbw_tpu.models.dbw import SceneParams
from dbw_tpu.ops.rotations import look_at_rotation as jax_look_at
from dbw_tpu.render.interpolate import interpolate_fragments_flat as jax_interp_flat
from dbw_tpu.render.meshes import sample_atlas_bilinear as jax_sample_atlas
from dbw_tpu.render.shading import vertex_normals as jax_vertex_normals
from dbw_torch.convert import scene_params_from_numpy
from dbw_torch.models.dbw import BlocksWorld
from dbw_torch.render.interpolate import interpolate_fragments_flat
from dbw_torch.render.meshes import sample_atlas_bilinear
from dbw_torch.render.shading import vertex_normals

H, W = 24, 32
CFG = dict(
    mesh=dict(n_blocks=2, txt_size=16, T_range=[0.5, 0.5, 0.5]),
    rend_optim=dict(decouple_rendering=True, coarse_learning=10),
    loss=dict(rgb_weight=1),
)
K = np.zeros((4, 4), np.float32)
K[0, 0] = K[1, 1] = 2.0
LIGHTS = {
    "ambient": dict(name="ambient", ambient_color=[[0.8, 0.7, 0.9]]),
    "directional": dict(name="directional", direction=[[1.0, 0.2, -1.0]]),
    "point": dict(name="point", location=[[0.0, 2.0, 0.0]],
                  ambient_color=[[0.4, 0.4, 0.4]], diffuse_color=[[0.6, 0.5, 0.4]]),
}
AZIMS = [0.0, 40.0]


def _models(renderer_cfg):
    jm = JaxBlocksWorld((H, W), renderer=copy.deepcopy(renderer_cfg), backend="xla",
                        **copy.deepcopy(CFG))
    jm.set_camera(K)
    tm = BlocksWorld((H, W), renderer=copy.deepcopy(renderer_cfg), device="cpu",
                     **copy.deepcopy(CFG))
    tm.set_camera(K)
    return jm, tm


def _views():
    R, T = jax_look_at(3.0, 20.0, jnp.asarray(AZIMS))
    return R, T, torch.from_numpy(np.asarray(R)), torch.from_numpy(np.asarray(T))


def _params(jm, seed=0):
    p = {k: np.asarray(v) for k, v in jm.init_params(seed=seed)._asdict().items()}
    p["alpha_logit"] = np.array([2.0, 1.0], np.float32)  # both blocks opaque
    return p


_CACHE = {}


def _renders(renderer_cfg, with_grad=False, w=None):
    """(port image, JAX image) of predict on the same parameters (kept for
    the module's other tests), and with ``w`` the gradients of sum(rec * w)
    of both."""
    key = repr(sorted(renderer_cfg.items()))
    if not with_grad and key in _CACHE:
        return _CACHE[key]
    jm, tm = _models(renderer_cfg)
    p = _params(jm)
    jR, jT, R, T = _views()
    jphase = jm.phase_for_epoch(0, training=False)
    tphase = tm.phase_for_epoch(0, training=False)
    tp = scene_params_from_numpy(p, "cpu", requires_grad=with_grad)
    rec, _ = tm.predict(tp, tphase, R, T)
    jp = SceneParams(**{k: jnp.asarray(v) for k, v in p.items()})
    jrec = np.asarray(jm.predict(jp, jphase, jR, jT)[0])
    if not with_grad:
        _CACHE[key] = rec.detach().numpy(), jrec
        return _CACHE[key]
    wt = torch.from_numpy(w)
    (rec * wt).sum().backward()
    jg = jax.grad(lambda q: jnp.sum(jm.predict(q, jphase, jR, jT)[0] * w))(jp)
    return ({k: v.grad.numpy() for k, v in tp.items()},
            {k: np.asarray(v) for k, v in jg._asdict().items()})


@pytest.mark.parametrize("detach_bary", [True, False])
@pytest.mark.parametrize("light", list(LIGHTS))
@pytest.mark.parametrize("shading", ["flat", "gouraud", "phong"])
def test_lit_render_matches_jax(shading, light, detach_bary):
    got, ref = _renders(dict(faces_per_pixel=2, shading_type=shading,
                             lights=LIGHTS[light], detach_bary=detach_bary))
    assert got.shape == (len(AZIMS), H, W, 3) and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, atol=1e-5)
    # the light modulates the texels (the JAX package's own property)
    raw, _ = _renders(dict(faces_per_pixel=2, shading_type="raw",
                           detach_bary=detach_bary))
    assert np.abs(got - raw).max() > 1e-3


@pytest.mark.parametrize("shading", ["flat", "gouraud", "phong"])
def test_default_ambient_lit_equals_raw(shading):
    """With the default ambient light (1, 1, 1) every lit type leaves the
    texels unchanged: each equals the raw render."""
    lit, _ = _renders(dict(faces_per_pixel=2, shading_type=shading, detach_bary=False))
    raw, _ = _renders(dict(faces_per_pixel=2, shading_type="raw", detach_bary=False))
    np.testing.assert_allclose(lit, raw, atol=1e-5)


def test_gouraud_differs_from_phong_but_close():
    lights = dict(name="directional", direction=[[1.0, 0.2, -1.0]],
                  ambient_color=[[0.4, 0.4, 0.4]], diffuse_color=[[0.6, 0.6, 0.6]])
    g, _ = _renders(dict(faces_per_pixel=2, shading_type="gouraud", lights=lights))
    p, _ = _renders(dict(faces_per_pixel=2, shading_type="phong", lights=lights))
    assert np.abs(g - p).max() > 1e-6
    assert np.abs(g - p).mean() < 0.1


def test_flat_fragments_and_atlas_sample_match_jax():
    """``interpolate_fragments_flat`` (per view of the port's batched
    stream), ``sample_atlas_bilinear`` in both ``diff_uv`` modes (values
    and gradients) and ``vertex_normals`` against the JAX functions."""
    jm, tm = _models(dict(faces_per_pixel=3, shading_type="phong"))
    p = _params(jm)
    jR, jT, R, T = _views()
    tp = scene_params_from_numpy(p, "cpu", requires_grad=False)
    jp = SceneParams(**{k: jnp.asarray(v) for k, v in p.items()})
    js, _ = jm.build_blocks(jp, jm.phase_for_epoch(0, training=False))
    ts, _ = tm.build_blocks(tp, tm.phase_for_epoch(0, training=False))
    np.testing.assert_allclose(vertex_normals(ts.verts, ts.faces).numpy(),
                               np.asarray(jax_vertex_normals(js.verts, js.faces)), atol=1e-6)

    from dbw_tpu.render.rasterize import project_faces as jproject
    from dbw_torch.render.rasterize import project_faces, rasterize

    rend = tm.renderer
    geom = project_faces(ts.verts, ts.faces, R, T, rend.camera, z_clip=1e-3)
    rcfg = rend.config.raster_config()
    p2f = rasterize(geom, 1e-4, rcfg)
    ff = interpolate_fragments_flat(p2f, geom, rcfg)
    N = H * W * 3
    for b in range(len(AZIMS)):
        jgeom = jproject(js.verts, js.faces, jR[b], jT[b], jm.camera, z_clip=1e-3)
        jff = jax_interp_flat(jnp.asarray(p2f[b].numpy()), jgeom, jm.renderer.config
                              .raster_config())
        for f in ("b0", "b1", "b2", "dists", "z"):
            np.testing.assert_allclose(getattr(ff, f)[b * N:(b + 1) * N].numpy(),
                                       np.asarray(getattr(jff, f)), atol=2e-6, err_msg=f)
        np.testing.assert_array_equal(ff.idx[b * N:(b + 1) * N].numpy(), np.asarray(jff.idx))

    rng = np.random.default_rng(2)
    maps = rng.random((3, 8, 8, 3)).astype(np.float32)
    mi = rng.integers(0, 3, 500)
    uv = rng.random((500, 2)).astype(np.float32)
    uv[:5] = [[0.0, 0.0], [1.0, 1.0], [1.0, 0.0], [0.0, 1.0], [0.5, 1.0]]  # atlas edges
    g = rng.standard_normal((500, 3)).astype(np.float32)
    for diff_uv in (False, True):
        tm_, tuv = (torch.tensor(a, requires_grad=True) for a in (maps, uv))
        out = sample_atlas_bilinear(tm_, torch.from_numpy(mi), tuv, diff_uv=diff_uv)
        (out * torch.from_numpy(g)).sum().backward()
        ref, vjp = jax.vjp(lambda m, u: jax_sample_atlas(m, jnp.asarray(mi), u,
                                                         diff_uv=diff_uv), maps, uv)
        dm, du = vjp(jnp.asarray(g))
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=1e-6)
        # the JAX texel gradient quantizes wx, wy to 1/32767
        # (segment_sum_pallas.pack_wxy): rtol 1e-4, as tests/test_torch_texel.py
        dm = np.asarray(dm)
        np.testing.assert_allclose(tm_.grad.numpy(), dm, rtol=1e-4,
                                   atol=1e-4 * np.abs(dm).max())
        want_du = np.asarray(du) if diff_uv else np.zeros_like(uv)
        got_du = tuv.grad.numpy() if tuv.grad is not None else np.zeros_like(uv)
        np.testing.assert_allclose(got_du, want_du, atol=1e-4)


def test_fov_camera_intrinsics_match_jax():
    """fov 90 -> fx = fy = 1 (not the dataset K), the defaults (fov 60,
    aspect 1), an aspect ratio, and a camera block without a name (fov)."""
    for cam in (dict(name="fov", fov=90.0), dict(name="fov"),
                dict(name="fov", fov=50.0, aspect_ratio=1.5, znear=0.1, zfar=10.0),
                dict(fov=60.0)):
        jm, tm = _models(dict(faces_per_pixel=2, cameras=cam))
        for f in ("fx", "fy", "px", "py"):
            assert getattr(tm.camera, f) == float(getattr(jm.camera, f)), (cam, f)
    jm, tm = _models(dict(faces_per_pixel=2, cameras=dict(name="fov", fov=90.0)))
    assert (tm.camera.fx, tm.camera.fy, tm.camera.px, tm.camera.py) == (1.0, 1.0, 0.0, 0.0)
    got, ref = _renders(dict(faces_per_pixel=2, cameras=dict(name="fov", fov=90.0)))
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_light_config_matches_jax():
    """The renderers' light fields from each light block, in both packages;
    unknown lights, cameras and shading types raise NotImplementedError in
    both."""
    for light in LIGHTS.values():
        jm, tm = _models(dict(faces_per_pixel=2, shading_type="flat", lights=light))
        for rend in ("renderer", "renderer_env", "renderer_viz"):
            jc, tc = getattr(jm, rend).config, getattr(tm, rend).config
            for f in ("shading", "light_type", "ambient_color", "diffuse_color",
                      "light_direction", "light_location"):
                assert getattr(tc, f) == getattr(jc, f), (light, rend, f)
    for bad in (dict(lights=dict(name="area")), dict(cameras=dict(name="ortho")),
                dict(shading_type="bogus")):
        for make in (JaxBlocksWorld, BlocksWorld):
            kw = dict(backend="xla") if make is JaxBlocksWorld else dict(device="cpu")
            with pytest.raises(NotImplementedError):
                m = make((H, W), renderer=dict(faces_per_pixel=2, **bad), **kw,
                         **copy.deepcopy(CFG))
                m.set_camera(K)
