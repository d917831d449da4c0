"""The DTU slice as a whole on the CPU: a tiny Trainer on a DTU scan (the
port's synthetic scene written in the IDR layout, in a millimetre world)
through its final evaluation's DTU branch, and the same parameters through
both packages' block export, scale matrix and official protocol."""

import copy

import numpy as np
import pytest
import torch

from dbw_torch.data.scan_writer import write_idr_scan
from dbw_torch.data.synthetic import make_synthetic_scene, sample_gt_points

SCALE_MAT = np.array([[200.0, 0, 0, -10.0], [0, 200.0, 0, 35.0], [0, 0, 200.0, 620.0],
                      [0, 0, 0, 1]])
# the DTU default's model section at a tiny width; opacity_init 0.9 keeps
# the blocks through the eval's filter after a few steps
MODEL = {
    "name": "dbw",
    "mesh": dict(n_blocks=2, S_world=0.5, R_world=[115, 0, 0], txt_size=8,
                 opacity_init=0.9),
    "renderer": dict(faces_per_pixel=2, cameras=dict(name="perspective"),
                     detach_bary=True, z_clip=0.001),
    "rend_optim": dict(coarse_learning=3, decimate_txt=2, decimate_factor=4,
                       kill_blocks=True, decouple_rendering=True, opacity_noise=True),
    "loss": dict(rgb_weight=1, parsimony_weight=0.01, tv_weight=0.1, overlap_weight=1),
}


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two torch threads: the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scan(tmp_path_factory):
    """scan24 of 8 views at 16x20 with 3,000 GT points, under root/."""
    root = tmp_path_factory.mktemp("DTU")
    ds, model, params = make_synthetic_scene((16, 20), n_views=8, seed=3, device="cpu")
    with torch.no_grad():
        pts = sample_gt_points(model, params, n_points=3000, seed=1).numpy()
    write_idr_scan(root, 24, ds.imgs, ds.K[0], ds.R, ds.T, SCALE_MAT, points=pts)
    return root


def test_trainer_on_a_dtu_scan_writes_dtu_scores(tmp_path, scan):
    from dbw_torch.train.trainer import Trainer

    cfg = {
        "dataset": {"name": "dtu", "tag": "scan24", "img_size": [16, 20],
                    "root": str(scan)},
        "model": copy.deepcopy(MODEL),
        "training": {
            "batch_size": 4, "n_epoches": 2, "steps_per_call": 2,
            "optimizer": {"name": "adam", "lr": 5e-3, "texture": {"lr": 5e-2}},
            "scheduler": {"name": "multi_step", "gamma": [0.1, 0.1], "milestones": [1]},
            "train_stat_interval": 2, "val_stat_interval": 4,
            "eval": {"render_videos": False, "n_views": 2},
            "seed": 5,
        },
    }
    run = tmp_path / "run"
    tr = Trainer(cfg, run, device="cpu", seed=5)
    assert tr.dataset.name == "dtu" and len(tr.dataset) == 8
    np.testing.assert_array_equal(tr.dataset.scale_mat, SCALE_MAT.astype(np.float32))
    tr.run(seed=5)
    lines = (run / "dtu_scores.tsv").read_text().splitlines()
    assert lines[0] == "acc\tcomp\tavg"
    acc, comp, avg = map(float, lines[1].split("\t"))
    assert np.isfinite([acc, comp, avg]).all() and avg == pytest.approx((acc + comp) / 2)
    assert (run / "final_scores.tsv").exists() and (run / "model.pkl").exists()


def test_export_scale_and_protocol_match_jax(tmp_path, scan):
    """The same parameters through the JAX package's and the port's block
    export, scale matrix and evaluate_mesh: the vertices within 1e-5 of the
    scene's extent in mm, the scores to 1e-4 relative (the float32 block
    vertices of the two packages differ in the last bits, which moves the
    protocol's float32 downsample near its radius)."""
    from dbw_tpu.eval.dtu_eval import evaluate_mesh as jax_evaluate_mesh
    from dbw_tpu.eval.export import export_blocks_mesh as jax_export
    from dbw_tpu.models.dbw import BlocksWorld as JaxBlocksWorld
    from dbw_tpu.models.dbw import SceneParams
    from dbw_torch.convert import scene_params_from_numpy
    from dbw_torch.eval.dtu_eval import evaluate_mesh
    from dbw_torch.eval.export import export_blocks_mesh
    from dbw_torch.models.dbw import BlocksWorld

    kw = {k: v for k, v in copy.deepcopy(MODEL).items() if k != "name"}
    model = BlocksWorld((16, 20), device="cpu", **copy.deepcopy(kw))
    p = model.init_params_numpy(7)
    p["T"] = p["T"] * 0.3  # blocks inside the scan's GT box
    jmodel = JaxBlocksWorld((16, 20), backend="xla", **copy.deepcopy(kw))
    scores = {}
    for name, (verts, faces), fn in (
            ("port", export_blocks_mesh(model, scene_params_from_numpy(p, "cpu")),
             evaluate_mesh),
            ("jax", jax_export(jmodel, SceneParams(**p), filter_transparent=True),
             jax_evaluate_mesh)):
        verts = np.asarray(verts) @ SCALE_MAT[:3, :3].T + SCALE_MAT[:3, 3]
        scores[name] = (verts, np.asarray(faces),
                        fn(verts, faces, 24, scan, tmp_path, suffix=name, save_viz=False))
    (v, f, got), (jv, jf, ref) = scores["port"], scores["jax"]
    np.testing.assert_array_equal(f, jf)
    assert len(f)
    np.testing.assert_allclose(v, jv, atol=1e-5 * np.abs(jv).max())
    for k in ("acc", "comp", "avg"):
        assert np.isfinite(got[k]) and got[k] == pytest.approx(ref[k], rel=1e-4), k
