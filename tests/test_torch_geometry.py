"""Geometry core of the PyTorch port against the JAX package: gradient-safe
powers, rotations, superquadrics, projection and the seeded init."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from dbw_tpu.models.dbw import BlocksWorld as JaxBlocksWorld
from dbw_tpu.ops import rotations as jrot
from dbw_tpu.ops import safe_math as jsm
from dbw_tpu.ops import superquadric as jsq
from dbw_tpu.render import cameras as jcam
from dbw_tpu.render.rasterize import project_faces as jax_project_faces
from dbw_torch.models.dbw import BlocksWorld
from dbw_torch.ops import rotations as trot
from dbw_torch.ops import safe_math as tsm
from dbw_torch.ops import superquadric as tsq
from dbw_torch.render import cameras as tcam
from dbw_torch.render import rasterize as tras

# tolerance of values computed by both frameworks in float32 (different
# libm / reduction order): a few ulp
ATOL = 1e-6

T_VALS = np.array([-2.0, -0.5, -1e-7, 0.0, 1e-7, 0.3, 1.5], np.float32)
P_VALS = [0.1, 0.5, 1.0, 1.9]


def _torch_grads(fn, t, p):
    tt = torch.tensor(t, requires_grad=True)
    pt = torch.tensor(np.full_like(t, p), requires_grad=True)
    out = fn(tt, pt)
    out.sum().backward()
    return out.detach().numpy(), tt.grad.numpy(), pt.grad.numpy()


def _jax_grads(fn, t, p):
    pv = jnp.full_like(t, p)
    out = fn(jnp.asarray(t), pv)
    gt, gp = jax.grad(lambda a, b: fn(a, b).sum(), argnums=(0, 1))(
        jnp.asarray(t), pv)
    return np.asarray(out), np.asarray(gt), np.asarray(gp)


@pytest.mark.parametrize("p", P_VALS)
@pytest.mark.parametrize("name", ["signed_pow", "safe_pow"])
def test_pow_values_and_zero_base_gradients(name, p):
    got = _torch_grads(getattr(tsm, name), T_VALS, p)
    ref = _jax_grads(getattr(jsm, name), T_VALS, p)
    for g, r, what in zip(got, ref, ["value", "d/dt", "d/dp"]):
        assert np.all(np.isfinite(g)), what
        np.testing.assert_allclose(g, r, rtol=1e-5, atol=ATOL, err_msg=what)
    zero = T_VALS == 0.0
    if name == "signed_pow":
        # d/dp at a zero base is 0 (the 0 * log(0) limit)
        assert np.all(got[2][zero] == 0.0)
    else:
        # the clamp kills d/dt at and below eps
        assert np.all(got[1][np.abs(T_VALS) <= 1e-6] == 0.0)


def test_rotation_6d_to_matrix_matches_jax():
    d6 = np.random.default_rng(0).standard_normal((16, 6)).astype(np.float32)
    got = trot.rotation_6d_to_matrix(torch.from_numpy(d6)).numpy()
    ref = np.asarray(jrot.rotation_6d_to_matrix(jnp.asarray(d6)))
    np.testing.assert_allclose(got, ref, atol=ATOL)
    # orthonormal, and the first two rows round-trip
    np.testing.assert_allclose(got @ got.transpose(0, 2, 1),
                               np.broadcast_to(np.eye(3), got.shape), atol=1e-5)
    back = trot.matrix_to_rotation_6d(torch.from_numpy(got)).numpy()
    np.testing.assert_allclose(trot.rotation_6d_to_matrix(
        torch.from_numpy(back)).numpy(), got, atol=ATOL)
    eye = trot.rotation_6d_to_matrix(torch.tensor([1.0, 0, 0, 0, 1.0, 0]))
    np.testing.assert_array_equal(eye.numpy(), np.eye(3, dtype=np.float32))


def test_random_rotations_replay_jax_bitwise():
    got = trot.random_rotations(7, np.random.default_rng(3))
    ref = np.asarray(jrot.random_rotations(7, np.random.default_rng(3)))
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("angles", [(0, 0, 0), (115, 0, 0), (10, -30, 45)])
def test_euler_world_matrix_matches_jax(angles):
    got = trot.euler_world_matrix(*angles)
    ref = np.asarray(jrot.euler_world_matrix(*angles))
    np.testing.assert_allclose(got, ref, atol=ATOL)


def test_look_at_rotation_matches_jax():
    azim = np.linspace(-40.0, 40.0, 4).astype(np.float32)
    R, T = trot.look_at_rotation(3.0, 25.0, torch.from_numpy(azim))
    Rj, Tj = jrot.look_at_rotation(3.0, 25.0, jnp.asarray(azim))
    np.testing.assert_allclose(R.numpy(), np.asarray(Rj), atol=ATOL)
    np.testing.assert_allclose(T.numpy(), np.asarray(Tj), atol=1e-5)


def _sq_inputs():
    rng = np.random.default_rng(1)
    eta = rng.uniform(-np.pi / 2, np.pi / 2, (1, 50)).astype(np.float32)
    omega = rng.uniform(-np.pi, np.pi, (1, 50)).astype(np.float32)
    eta[0, :3] = [0.0, np.pi / 2, -np.pi / 2]   # bases exactly 0 / +-1
    omega[0, :3] = [0.0, np.pi, np.pi / 2]
    eps = rng.uniform(0.1, 1.9, (3, 2)).astype(np.float32)
    return eta, omega, eps


def test_parametric_sq_values_and_grads():
    eta, omega, eps = _sq_inputs()
    e = torch.tensor(eps, requires_grad=True)
    out = tsq.parametric_sq(torch.from_numpy(eta), torch.from_numpy(omega),
                            e[:, 0:1], e[:, 1:2])
    out.square().sum().backward()
    fj = lambda ej: jsq.parametric_sq(eta, omega, ej[:, 0:1], ej[:, 1:2])
    ref = np.asarray(fj(jnp.asarray(eps)))
    gref = np.asarray(jax.grad(lambda ej: jnp.sum(fj(ej) ** 2))(jnp.asarray(eps)))
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=ATOL)
    np.testing.assert_allclose(e.grad.numpy(), gref, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("as_sdf", [False, True, 2])
def test_implicit_sq_values_and_grads(as_sdf):
    rng = np.random.default_rng(2)
    pts = rng.uniform(-1.5, 1.5, (3, 40, 3)).astype(np.float32)
    if as_sdf is not True:
        # the clamped-base corner case (the radial-distance variant's norm
        # has no gradient at the origin in JAX)
        pts[:, 0] = 0.0
    pts[:, 1] = 7.0                       # clamped to [-5, 5]
    eps = rng.uniform(0.3, 1.9, (3, 2)).astype(np.float32)
    p = torch.tensor(pts, requires_grad=True)
    e = torch.tensor(eps, requires_grad=True)
    out = tsq.implicit_sq(p, e[:, 0:1], e[:, 1:2], as_sdf=as_sdf)
    out.sum().backward()
    fj = lambda pj, ej: jsq.implicit_sq(pj, ej[:, 0:1], ej[:, 1:2], as_sdf=as_sdf)
    ref = np.asarray(fj(jnp.asarray(pts), jnp.asarray(eps)))
    gp, ge = jax.grad(lambda a, b: fj(a, b).sum(), argnums=(0, 1))(
        jnp.asarray(pts), jnp.asarray(eps))
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=1e-5, atol=ATOL)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(gp), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(e.grad.numpy(), np.asarray(ge), rtol=1e-4, atol=1e-5)


MODEL_CFGS = {
    "gauss": dict(mesh=dict(n_blocks=3, txt_size=16, T_range=[0.5, 0.5, 0.5])),
    "uni": dict(mesh=dict(n_blocks=2, txt_size=24, T_init_mode="uni",
                          txt_bkg_upscale=2, scale_min=0.3, opacity_init=0.3)),
}


@pytest.mark.parametrize("cfg", sorted(MODEL_CFGS))
def test_init_params_equal_jax_bitwise(cfg):
    import copy

    jm = JaxBlocksWorld((24, 32), backend="xla", **copy.deepcopy(MODEL_CFGS[cfg]))
    tm = BlocksWorld((24, 32), **copy.deepcopy(MODEL_CFGS[cfg]))
    jp = jm.init_params(seed=5)
    tp = tm.init_params(seed=5)
    assert set(tp) == set(jp._fields)
    for name in jp._fields:
        ref = np.asarray(getattr(jp, name))
        got = tp[name].detach().numpy()
        assert got.dtype == ref.dtype and got.shape == ref.shape, name
        np.testing.assert_array_equal(got, ref, err_msg=name)
        assert tp[name].requires_grad


def test_statics_equal_jax():
    import copy

    cfg = MODEL_CFGS["uni"]
    jm = JaxBlocksWorld((24, 32), backend="xla", **copy.deepcopy(cfg))
    tm = BlocksWorld((24, 32), **copy.deepcopy(cfg))
    assert tm.atlas_hw == jm.atlas_hw and tm.BNF == jm.BNF
    assert tm.txt_padding == jm.txt_padding
    for name in tm.statics._fields:
        np.testing.assert_array_equal(
            getattr(tm.statics, name).numpy(),
            np.asarray(getattr(jm.statics, name)), err_msg=name)


def test_project_faces_matches_jax():
    rng = np.random.default_rng(4)
    verts = rng.uniform(-1, 1, (30, 3)).astype(np.float32)
    verts[0] = [0.0, 0.0, -3.0]                       # behind the camera
    faces = rng.integers(0, 30, (40, 3)).astype(np.int64)
    R, T = jrot.look_at_rotation(3.0, 25.0, jnp.linspace(-40.0, 40.0, 2))
    K = np.array([2.8, 2.1, 0.02, 0.02], np.float32)
    jc = jcam.Camera(*[jnp.float32(v) for v in K])
    tc = tcam.Camera(*[float(v) for v in K])
    got = tras.project_faces(torch.from_numpy(verts), torch.from_numpy(faces),
                             torch.tensor(np.asarray(R)),
                             torch.tensor(np.asarray(T)), tc, z_clip=1e-3)
    for b in range(2):
        ref = jax_project_faces(jnp.asarray(verts), jnp.asarray(faces), R[b],
                                 T[b], jc, z_clip=1e-3)
        np.testing.assert_allclose(got.xy[b].numpy(), np.asarray(ref.xy),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got.z[b].numpy(), np.asarray(ref.z), atol=1e-5)
        np.testing.assert_array_equal(got.valid[b].numpy(), np.asarray(ref.valid))
