"""The nerfstudio capture path of the PyTorch port against the JAX package
on the CPU: ``load_nerfstudio`` on a capture in nerfstudio's
transforms.json layout (images, K, R, T, GT points, the splits,
``downscale_factor``), the trained-pipeline path with a mocked
``nerfstudio`` package, the capture writer against the loader's camera
conversions, the factory, and a tiny Trainer run on a written capture with
``configs/nerfstudio/campanile.yml``'s schedule."""

import copy
import sys
import types

import numpy as np
import pytest

import jax.numpy as jnp
import torch
from PIL import Image

from dbw_tpu.data.nerfstudio import _c2w_to_internal as jax_c2w_to_internal
from dbw_tpu.data.nerfstudio import load_nerfstudio as jax_load_nerfstudio
from dbw_tpu.ops.rotations import look_at_rotation as jax_look_at
from dbw_torch.data import create_train_val_test_loader
from dbw_torch.data.nerfstudio import BBOX_MAX, BBOX_MIN, _c2w_to_internal, load_nerfstudio
from dbw_torch.data.scan_writer import write_nerfstudio_capture
from dbw_torch.ops.rotations import look_at_rotation

H, W = 32, 48
FIELDS = ("imgs", "K", "R", "T", "pc_gt")


def _write_capture(root, tag="scene", n=5, seed=0, with_points=True):
    """A capture of ``n`` random views around the origin: written with the
    port's writer from internal cameras (look_at), a NDC K with an
    off-centre principal point, and 300 GT points."""
    rng = np.random.default_rng(seed)
    imgs = rng.random((n, H, W, 3)).astype(np.float32)
    R, T = look_at_rotation(2.5, 20.0, torch.linspace(-60.0, 60.0, n))
    K = np.zeros((4, 4), np.float32)
    K[0, 0], K[1, 1], K[0, 2], K[1, 2] = 2.2, 2.3, 0.05, -0.03
    K[2, 3] = K[3, 2] = 1.0
    pts = rng.standard_normal((300, 3)).astype(np.float32) if with_points else None
    write_nerfstudio_capture(root, tag, imgs, K, R.numpy(), T.numpy(), points=pts)
    return imgs, K, R.numpy(), T.numpy(), pts


@pytest.mark.parametrize("split", ["train", "val", "test"])
@pytest.mark.parametrize("downscale", [1, 2])
def test_transforms_json_matches_jax(tmp_path, split, downscale):
    _write_capture(tmp_path, "scene")
    got = load_nerfstudio(split, None, "scene", downscale_factor=downscale, root=tmp_path)
    ref = jax_load_nerfstudio(split, None, "scene", downscale_factor=downscale,
                              root=tmp_path)
    assert len(got) == len(ref) == (0 if split == "val" else 5)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(ref, f), err_msg=f)
    assert got.name == ref.name == "nerfstudio"
    if split != "val":
        assert got.img_size == (H // downscale, W // downscale)


def test_writer_inverts_the_loader(tmp_path):
    """The written capture loads back as the cameras, K and points it was
    written from (train split, no downscale; images to 8 bits)."""
    imgs, K, R, T, pts = _write_capture(tmp_path, "scene")
    ds = load_nerfstudio("train", (H, W), "scene", root=tmp_path)
    np.testing.assert_allclose(ds.R, R, atol=1e-6)
    np.testing.assert_allclose(ds.T, T, atol=1e-6)
    np.testing.assert_allclose(ds.K, np.broadcast_to(K, (5, 4, 4)), atol=1e-6)
    np.testing.assert_allclose(ds.imgs, imgs, atol=0.5 / 255 + 1e-6)
    np.testing.assert_array_equal(ds.pc_gt, pts)


def test_c2w_conversion_matches_jax():
    """OpenGL camera-to-world -> internal (R, T) against the JAX function,
    and inverting look_at's cameras."""
    R0, T0 = jax_look_at(3.0, 20.0, jnp.asarray([35.0, -60.0]))
    S = np.diag([-1.0, 1.0, -1.0])
    for i in range(2):
        R, T = np.asarray(R0[i], np.float64), np.asarray(T0[i], np.float64)
        c2w = np.eye(4)
        c2w[:3, :3] = np.linalg.inv(S @ R.T)
        c2w[:3, 3] = -np.linalg.inv(S @ R.T) @ (S @ T)
        got, ref = _c2w_to_internal(c2w), jax_c2w_to_internal(c2w)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_allclose(got[0], R, atol=1e-5)
        np.testing.assert_allclose(got[1], T, atol=1e-5)


def _mock_nerfstudio(monkeypatch, tmp_path):
    """A mocked ``nerfstudio`` package whose trained pipeline holds 4 views
    (the JAX package's own mock, tests/test_datasets.py)."""
    rng = np.random.default_rng(0)
    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    files, c2ws = [], []
    for i in range(4):
        p = img_dir / f"f{i}.png"
        Image.fromarray((rng.random((H, W, 3)) * 255).astype(np.uint8)).save(p)
        files.append(p)
        c2w = np.eye(4)[:3]
        c2w[:3, 3] = [0.1 * i, 0.0, 2.0 + i]
        c2ws.append(c2w)

    class Cameras:
        fx = np.array([40.0]); fy = np.array([41.0])  # noqa: E702
        cx = np.array([W / 2 + 1.0]); cy = np.array([H / 2])  # noqa: E702
        width = np.array([W]); height = np.array([H])  # noqa: E702
        camera_to_worlds = np.stack(c2ws)

    dataset = types.SimpleNamespace(_dataparser_outputs=types.SimpleNamespace(
        image_filenames=files, cameras=Cameras()))
    pipeline = types.SimpleNamespace(datamanager=types.SimpleNamespace(
        train_dataset=dataset, eval_dataset=dataset))
    calls = {}
    cloud = np.random.default_rng(1).random((500, 3))

    def eval_setup(cfg_path):
        calls["config"] = cfg_path
        return None, pipeline, None

    def generate_point_cloud(pipeline, bounding_box_min, bounding_box_max):
        calls["bbox"] = (bounding_box_min, bounding_box_max)
        return types.SimpleNamespace(points=cloud)

    mods = {n: types.ModuleType(n) for n in (
        "nerfstudio", "nerfstudio.utils", "nerfstudio.utils.eval_utils",
        "nerfstudio.exporter", "nerfstudio.exporter.exporter_utils")}
    mods["nerfstudio.utils.eval_utils"].eval_setup = eval_setup
    mods["nerfstudio.exporter.exporter_utils"].generate_point_cloud = generate_point_cloud
    for name, mod in mods.items():
        monkeypatch.setitem(sys.modules, name, mod)
    model_dir = tmp_path / "outputs" / "scene" / "nerfacto" / "run0"
    model_dir.mkdir(parents=True)
    (model_dir / "config.yml").write_text("x: 1")
    return calls, model_dir


@pytest.mark.parametrize("split", ["train", "test"])
def test_trained_pipeline_path_with_mock(tmp_path, monkeypatch, split):
    """Cameras and images from the pipeline's datamanager, the GT cloud
    generated from the NeRF over the reference's bounding box; the run is
    found under ``<root>/outputs/<tag>`` or given as ``model_dir``."""
    calls, model_dir = _mock_nerfstudio(monkeypatch, tmp_path)
    for kw in ({}, {"model_dir": model_dir}):
        got = load_nerfstudio(split, None, "scene", root=tmp_path, **kw)
        assert calls["bbox"] == (BBOX_MIN, BBOX_MAX) == ((-4.0,) * 3, (4.0,) * 3)
        assert calls["config"] == model_dir / "config.yml"
        ref = jax_load_nerfstudio(split, None, "scene", root=tmp_path, **kw)
        assert len(got) == 4 and got.imgs.shape == (4, H, W, 3)
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(got, f), getattr(ref, f), err_msg=f)


def test_factory_loads_a_capture(tmp_path):
    _write_capture(tmp_path, "cap", n=6)
    cfg = {"dataset": {"name": "nerfstudio", "tag": "cap", "root": str(tmp_path),
                       "downscale_factor": 2}, "training": {"batch_size": 4}}
    loaders = create_train_val_test_loader(cfg, device="cpu")
    assert [len(ld.dataset) for ld in loaders] == [6, 0, 6]
    assert [len(ld) for ld in loaders] == [2, 0, 2]
    assert loaders[0].dataset.img_size == (H // 2, W // 2)
    with pytest.raises(ValueError):
        load_nerfstudio("train", None, "cap", root=tmp_path, bogus=1)


def test_trainer_runs_on_a_capture(tmp_path):
    """The Trainer on campanile.yml's schedule, cut to a tiny model, on a
    written capture of the port's synthetic scene (12 views at 48x64,
    ``downscale_factor`` 2): finite losses that fall, the final scores and
    the final eval's renders; the empty val split leaves the viz samples
    to the train split."""
    from dbw_torch.data.synthetic import make_synthetic_scene
    from dbw_torch.train.trainer import Trainer
    from dbw_torch.utils.config import load_yaml
    from dbw_torch.utils.path import CONFIGS_PATH

    ds, model, params = make_synthetic_scene((48, 64), n_views=12, seed=3, device="cpu")
    write_nerfstudio_capture(tmp_path / "ns", "campanile", ds.imgs, ds.K[0], ds.R, ds.T,
                             points=ds.pc_gt)
    cfg = load_yaml(CONFIGS_PATH / "nerfstudio" / "campanile.yml")
    cfg["dataset"]["root"] = str(tmp_path / "ns")
    cfg["model"]["mesh"].update(n_blocks=2, txt_size=8, opacity_init=0.9)
    cfg["model"]["renderer"]["faces_per_pixel"] = 2
    cfg["training"].update(n_epoches=3, train_stat_interval=3, val_stat_interval=6,
                           eval={"n_traj_videos": 1, "NV": 2, "n_views": 2})
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        t = Trainer(copy.deepcopy(cfg), tmp_path / "run", device="cpu",
                    seed=cfg["training"]["seed"])
        assert t.dataset.img_size == (24, 32) and len(t.val_loader) == 0
        t.run(seed=cfg["training"]["seed"])
    finally:
        torch.set_num_threads(n)
    log = t.train_metrics.read_log()
    assert np.isfinite(np.stack([log[k] for k in log])).all()
    assert log["loss_total"][-1] < log["loss_total"][0]
    scores = (tmp_path / "run" / "final_scores.tsv").read_text().splitlines()
    assert np.isfinite([float(v) for v in scores[1].split("\t")]).all()
    assert (tmp_path / "run" / "model.pkl").exists()
    assert any((tmp_path / "run" / "quali_eval").glob("rotated_mesh.*"))
