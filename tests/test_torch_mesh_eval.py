"""Mesh scoring of the port against the JAX package: the chunked 1-NN and
the chamfer distance, the numpy mesh sampler, gradient ICP, MeshEvaluator,
ProxyEvaluator, RANSAC, the checkpoint's model rebuild and the run's
mesh_scores.tsv. The inputs are made from numpy seeds; the tolerances are
stated at each check."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dbw_tpu.eval import icp as jicp
from dbw_tpu.eval import metrics as jmetrics
from dbw_tpu.eval import ransac as jransac
from dbw_tpu.losses import chamfer as jchamfer
from dbw_tpu.ops.icosphere import icosphere
from dbw_torch.eval import icp as ticp
from dbw_torch.eval import metrics as tmetrics
from dbw_torch.eval import ransac as transac
from dbw_torch.losses import chamfer as tchamfer


def _clouds(n1, n2, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n1, 3)).astype(np.float32),
            rng.standard_normal((n2, 3)).astype(np.float32))


@pytest.mark.parametrize("n1,n2,chunk", [(700, 900, 128), (1500, 300, 4096)])
def test_nn_dist2_idx_matches_jax(n1, n2, chunk):
    x, y = _clouds(n1, n2)
    d, i = tchamfer.nn_dist2_idx(torch.from_numpy(x), torch.from_numpy(y), chunk)
    jd, ji = jchamfer.nn_dist2_idx(jnp.asarray(x), jnp.asarray(y), chunk)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    # rtol 1e-5, with an absolute floor at 1e-5 of the squared norms: the
    # expansion |x|^2 + |y|^2 - 2 x.y cancels for near points on both sides
    scale = float((x * x).sum(-1).max())
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-5 * scale)


def test_nn_dist2_gradient_flows_through_the_gathered_entries():
    """The gradient of sum(dist2) is 2 (x - y[idx]) for x, as JAX's; the
    forward value is the block's entry."""
    import jax

    x, y = _clouds(300, 200, seed=1)
    tx = torch.from_numpy(x).requires_grad_(True)
    ty = torch.from_numpy(y).requires_grad_(True)
    d, _ = tchamfer.nn_dist2_idx(tx, ty, 128)
    d.sum().backward()
    jgx, jgy = jax.grad(lambda a, b: jchamfer.nn_dist2_idx(a, b, 128)[0].sum(),
                        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(y))
    # gradients to 1e-5 of their max (the same formula, another rounding)
    for g, j in ((tx.grad, jgx), (ty.grad, jgy)):
        j = np.asarray(j)
        np.testing.assert_allclose(g.numpy(), j, atol=1e-5 * np.abs(j).max())


@pytest.mark.parametrize("case", ["sum", "mean", "none", "l1", "normals", "batch_sum",
                                  "point_sum"])
def test_chamfer_distance_matches_jax(case):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 400, 3)).astype(np.float32)
    y = rng.standard_normal((2, 350, 3)).astype(np.float32)
    kw = dict(direction_reduction={"mean": "mean", "none": "none"}.get(case, "sum"),
              return_L1=case == "l1",
              batch_reduction="sum" if case == "batch_sum" else "mean",
              point_reduction="sum" if case == "point_sum" else "mean")
    tn = jn = {}
    if case == "normals":
        xn = rng.standard_normal((2, 400, 3)).astype(np.float32)
        yn = rng.standard_normal((2, 350, 3)).astype(np.float32)
        tn = dict(x_normals=torch.from_numpy(xn), y_normals=torch.from_numpy(yn))
        jn = dict(x_normals=jnp.asarray(xn), y_normals=jnp.asarray(yn))
    got = tchamfer.chamfer_distance(torch.from_numpy(x), torch.from_numpy(y), **tn, **kw)
    ref = jchamfer.chamfer_distance(jnp.asarray(x), jnp.asarray(y), **jn, **kw)
    flat = lambda t: np.concatenate([np.ravel(np.asarray(v)) for v in (
        t if isinstance(t, tuple) else (t,))])
    assert (got[1] is None) == (ref[1] is None)
    # sums of the per-point distances: rtol 1e-5
    np.testing.assert_allclose(flat(got[0]), flat(ref[0]), rtol=1e-5)
    if ref[1] is not None:
        np.testing.assert_allclose(flat(got[1]), flat(ref[1]), rtol=1e-5)


def test_sample_points_from_mesh_bitwise():
    v, f = icosphere(2)
    for normals in (False, True):
        got = tmetrics.sample_points_from_mesh(v * 0.7, f, 3000,
                                               np.random.default_rng(5), normals)
        ref = jmetrics.sample_points_from_mesh(v * 0.7, f, 3000,
                                               np.random.default_rng(5), normals)
        for a, b in zip(got if normals else (got,), ref if normals else (ref,)):
            np.testing.assert_array_equal(a, b)


def test_gradient_icp_matches_jax():
    """20 Adam steps on (R_6d, T, s) with an anisotropic scale: R, T, s and
    the aligned cloud to 1e-4 (torch's and optax's Adam round the update
    differently, PR 1's float floor)."""
    rng = np.random.default_rng(3)
    pc = rng.random((1, 300, 3)).astype(np.float32)
    R0 = np.array([[0.98, 0.2, 0], [-0.2, 0.98, 0], [0, 0, 1]], np.float32)
    pred = (pc * 1.1) @ R0 + np.array([0.05, -0.03, 0.02], np.float32)
    a, (R, T, s) = ticp.gradient_icp(pred, pc, True, True, n_iter=20, device="cpu")
    ja, (jR, jT, js) = jicp.gradient_icp(pred, pc, True, True, n_iter=20)
    for got, ref in ((R, jR), (T, jT), (s, js), (a, ja)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4)


def test_gradient_icp_recovers_translation():
    rng = np.random.default_rng(0)
    pc = rng.random((256, 3)).astype(np.float32)
    shifted = pc + np.array([0.3, -0.2, 0.1], np.float32)
    aligned, _ = ticp.gradient_icp(shifted[None], pc[None], estimate_scale=False,
                                   n_iter=150, lr=0.02, device="cpu")
    d0 = np.abs(shifted - pc).mean()
    d1 = np.abs(aligned[0].numpy() - pc).mean()
    assert d1 < d0 * 0.5


@pytest.mark.parametrize("with_normals", [True, False])
def test_mesh_evaluator_matches_jax(with_normals):
    """Both evaluators on the same mesh, GT and generator stream, with N and
    n_iter cut on the instances: every score to 1e-4 relative."""
    v, f = icosphere(2)
    pts, nrm = jmetrics.sample_points_from_mesh(v * 0.5, f, 3000, return_normals=True)
    verts = (v * 0.52 + 0.01).astype(np.float32)
    ev = tmetrics.MeshEvaluator(fast_cpu=True, device="cpu")
    jev = jmetrics.MeshEvaluator(fast_cpu=True)
    for e in (ev, jev):
        e.N, e.n_iter = 2000, 10
    norm_gt = nrm if with_normals else None
    got = ev.evaluate(verts, f, pts, norm_gt)
    ref = jev.evaluate(verts, f, pts, norm_gt)
    assert list(got) == list(ref)
    assert len(got) == (4 if with_normals else 2)
    for k in ref:
        assert got[k] == pytest.approx(ref[k], rel=1e-4), k


def test_mesh_evaluator_identity():
    v, f = icosphere(2)
    pts, normals = tmetrics.sample_points_from_mesh(v * 0.5, f, 5000,
                                                    return_normals=True)
    ev = tmetrics.MeshEvaluator(run_icp=False, fast_cpu=True, device="cpu")
    ev.N = 5000
    res = ev.evaluate(v * 0.5, f, pts, normals)
    assert res["chamfer-L1"] < 0.3  # CHAMFER_FACTOR x a small distance
    assert res["normal-cos"] > 0.9  # a consistency: 1 is perfect
    assert tmetrics.CHAMFER_FACTOR == jmetrics.CHAMFER_FACTOR
    assert tmetrics.EPS == jmetrics.EPS


def test_proxy_evaluator_matches_jax(tmp_path):
    rng = np.random.default_rng(4)
    a = (rng.random((3, 8, 8)) > 0.5).astype(np.float32)
    b = (rng.random((3, 8, 8)) > 0.4).astype(np.float32)
    tp = tmetrics.ProxyEvaluator(log_file=tmp_path / "t.tsv")
    jp = jmetrics.ProxyEvaluator(log_file=tmp_path / "j.tsv")
    for k in range(3):
        assert tp.evaluate(a[k], b[k])["mask_iou"] == jp.evaluate(a[k], b[k])["mask_iou"]
    tp.update(a, b)
    jp.update(a, b)
    assert tp.compute() == pytest.approx(jp.compute(), rel=1e-12)
    assert tp.evaluate(a[0], a[0])["mask_iou"] == pytest.approx(1.0)


def test_ls_plane_fit_and_ransac_match_jax():
    rng = np.random.default_rng(5)
    xy = rng.uniform(-1, 1, (400, 2))
    z = 0.3 * xy[:, 0] - 0.2 * xy[:, 1] + 0.5 + 0.005 * rng.standard_normal(400)
    pts = np.concatenate([np.concatenate([xy, z[:, None]], 1),
                          rng.uniform(-1, 1, (60, 3))]).astype(np.float32)
    # least squares over sets of 10 points (well posed): 1e-4 absolute
    cand = pts[rng.integers(0, len(pts), (50, 10))]
    np.testing.assert_allclose(transac.ls_plane_fit(torch.from_numpy(cand)).numpy(),
                               np.asarray(jransac.ls_plane_fit(jnp.asarray(cand))),
                               atol=1e-4)
    # RANSAC on the same 3-point candidates (a few are near-collinear, whose
    # float32 fits differ on both sides but never win): the JAX function
    # with its draw replaced by the same indices
    idx = rng.integers(0, len(pts), (50, 3))
    coef, inl = transac.ransac_plane(torch.from_numpy(pts), threshold=0.02,
                                     idx=torch.from_numpy(idx))
    jc = np.asarray(jransac.ls_plane_fit(jnp.asarray(pts[idx])))
    resid = np.abs(pts[None, :, 2] - (jc[:, :1] * pts[None, :, 0]
                                      + jc[:, 1:2] * pts[None, :, 1] + jc[:, 2:3]))
    best = int(np.argmax((resid < 0.02).sum(1)))
    np.testing.assert_allclose(coef.numpy(), jc[best], atol=1e-4)
    np.testing.assert_array_equal(inl.numpy(), resid[best] < 0.02)


def test_ransac_plane_recovery():
    rng = np.random.default_rng(0)
    xy = rng.uniform(-1, 1, (500, 2))
    z = 0.3 * xy[:, 0] - 0.2 * xy[:, 1] + 0.5
    pts = np.concatenate([xy, z[:, None]], 1).astype(np.float32)
    allp = np.concatenate([pts, rng.uniform(-1, 1, (50, 3)).astype(np.float32)])
    coef, inl = transac.ransac_plane(torch.from_numpy(allp), threshold=0.02,
                                     generator=torch.Generator().manual_seed(0))
    np.testing.assert_allclose(coef.numpy(), [0.3, -0.2, 0.5], atol=0.05)
    assert inl.numpy()[:500].mean() > 0.9


def test_remove_ground_plane():
    rng = np.random.default_rng(1)
    ground = np.concatenate([rng.uniform(-1, 1, (400, 2)), np.zeros((400, 1))], 1)
    obj = rng.uniform(0.3, 0.8, (100, 3))
    allp = np.concatenate([ground, obj]).astype(np.float32)
    kept, coef = transac.remove_ground_plane(allp, axis=2, device="cpu")
    jkept, _ = jransac.remove_ground_plane(allp, axis=2)
    assert 50 <= len(kept) <= 200  # the object survives, the ground mostly goes
    assert abs(len(kept) - len(jkept)) <= 10
    np.testing.assert_allclose(coef, [0.0, 0.0, 0.0], atol=0.05)


def test_model_from_checkpoint_and_mesh_scores(tmp_path):
    """A run directory (dumped yml, JAX-written model.pkl) through the
    port's model rebuild and mesh scoring: the rebuilt parameters and the
    exported mesh equal the JAX package's, and mesh_scores.tsv has the JAX
    script's format with MeshEvaluator's scores on that mesh (1e-4
    relative)."""
    from dbw_tpu.eval.export import export_blocks_mesh as jax_export
    from dbw_tpu.models import load_model_from_checkpoint as jax_load
    from dbw_tpu.models.dbw import BlocksWorld as JaxBlocksWorld
    from dbw_tpu.train.checkpoint import save_checkpoint
    from dbw_torch.eval.export import export_blocks_mesh
    from dbw_torch.eval.mesh_scores import score_run_mesh
    from dbw_torch.train.checkpoint import load_model_from_checkpoint
    from dbw_torch.utils.config import dump_yaml

    model_cfg = dict(name="dbw", mesh=dict(n_blocks=3, txt_size=8, opacity_init=0.9),
                     renderer=dict(faces_per_pixel=2))
    cfg = dict(dataset=dict(name="synthetic", tag="t", img_size=[16, 20], n_views=4,
                            seed=2), model=model_cfg)
    kw = {k: v for k, v in model_cfg.items() if k != "name"}
    jm = JaxBlocksWorld((16, 20), backend="xla", **kw)
    save_checkpoint(tmp_path / "model.pkl", jm.init_params(1), None, 1, 1,
                    model_kwargs=model_cfg)
    dump_yaml(cfg, tmp_path / "t.yml")

    model, params, state = load_model_from_checkpoint(tmp_path / "model.pkl", (16, 20),
                                                      device="cpu")
    jmodel, jparams, _ = jax_load(tmp_path / "model.pkl", (16, 20))
    for k, p in params.items():
        np.testing.assert_array_equal(p.detach().numpy(), np.asarray(getattr(jparams, k)))
    verts, faces = export_blocks_mesh(model, params)
    jverts, jfaces = jax_export(jmodel, jparams, filter_transparent=True)
    np.testing.assert_array_equal(faces, np.asarray(jfaces))
    np.testing.assert_allclose(verts, np.asarray(jverts), atol=1e-5)
    assert len(faces)

    gt = np.random.default_rng(6).uniform(-0.5, 0.5, (300, 3)).astype(np.float32)
    ev = tmetrics.MeshEvaluator(fast_cpu=True, device="cpu")
    jev = jmetrics.MeshEvaluator(fast_cpu=True)
    for e in (ev, jev):
        e.N, e.n_iter = 3000, 10
    scores = score_run_mesh(tmp_path, ev, gt_points=gt)
    ref = jev.evaluate(np.asarray(jverts), np.asarray(jfaces), gt)
    assert list(scores) == list(ref) == ["chamfer-L1", "chamfer-L1-ICP"]
    for k in ref:
        assert scores[k] == pytest.approx(ref[k], rel=1e-4), k
    lines = (tmp_path / "mesh_scores.tsv").read_text().splitlines()
    assert lines[0] == "chamfer-L1\tchamfer-L1-ICP"
    assert lines[1] == "\t".join(f"{v:.6f}" for v in scores.values())


def test_r5_mesh_scores_in_float32():
    """r5's exported blocks (the two 42-vertex components of its
    quali_eval/mesh.obj; the 81-vertex ground dropped) on the JAX package's
    GT points of the scene (drawn as make_synthetic_scene draws them): the
    port's MeshEvaluator and the JAX package's, both in float32 on the CPU
    without ICP, agree within 1e-4 relative and land at 0.3446 +- 0.001,
    not at r5's recorded 0.279313 (that score came from a TPU 1-NN whose
    cross term ran in bfloat16). The blocks and the points are
    scripts/torch_r5_scores.py's."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "scripts" / "torch_r5_scores.py"
    spec = importlib.util.spec_from_file_location("torch_r5_scores", path)
    r5 = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(r5)
    v, f = r5.r5_blocks()
    assert v.shape == (84, 3) and f.shape == (160, 3)
    pts = r5.jax_gt_points()
    assert pts.shape == (1998, 3)
    got = tmetrics.MeshEvaluator(run_icp=False, device="cpu").evaluate(v, f, pts)
    ref = jmetrics.MeshEvaluator(run_icp=False).evaluate(v, f, pts)
    assert got["chamfer-L1"] == pytest.approx(ref["chamfer-L1"], rel=1e-4)
    for score in (got["chamfer-L1"], ref["chamfer-L1"]):
        assert score == pytest.approx(0.3446, abs=1e-3)
