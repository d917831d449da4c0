"""The DTU and BlendedMVS scan path of the port against the JAX package:
the PLY reader, the camera conversions, the file listing and image reader,
the DTU and BMVS loaders on a fake IDR scan, the dataset factory, the
neighbour library and the official DTU protocol."""

import numpy as np
import pytest
from PIL import Image

from dbw_tpu.data import base as jbase
from dbw_tpu.data.bmvs import load_bmvs as jax_load_bmvs
from dbw_tpu.data.dtu import load_dtu as jax_load_dtu
from dbw_tpu.ops.icosphere import icosphere
from dbw_tpu.render import cameras as jcams
from dbw_tpu.utils import misc as jmisc
from dbw_tpu.utils.obj_io import load_ply as jax_load_ply
from dbw_tpu.utils.obj_io import save_ply as jax_save_ply
from dbw_torch.data import base as tbase
from dbw_torch.data import create_train_val_test_loader
from dbw_torch.data.bmvs import load_bmvs
from dbw_torch.data.dtu import load_dtu
from dbw_torch.render import cameras as tcams
from dbw_torch.utils import misc as tmisc
from dbw_torch.utils.obj_io import load_ply, save_ply

# the scan's millimetre world: a DTU-like scale matrix
SCALE_MAT = np.array([[210.0, 0, 0, -12.0], [0, 210.0, 0, 40.0], [0, 0, 210.0, 615.0],
                      [0, 0, 0, 1]])


def make_idr_scan(root, tag, n_views=6, hw=(24, 32), scale_mat=np.eye(4),
                  n_points=500, seed=0):
    """An IDR-layout scan: image/*.png, cameras.npz with world and scale
    matrices (raw-size intrinsics), and, with n_points, a GT cloud in
    Points/stl."""
    scan = root / tag
    (scan / "image").mkdir(parents=True)
    rng = np.random.default_rng(seed)
    H, W = hw
    cams = {}
    for i in range(n_views):
        img = (rng.random((H, W, 3)) * 255).astype(np.uint8)
        Image.fromarray(img).save(scan / "image" / f"{i:06d}.png")
        K = np.array([[2400.0 + 10 * i, 3.0, 800.0 + i], [0, 2410.0, 600.0 - i],
                      [0, 0, 1.0]])
        a = i * 0.3
        R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])
        t = np.array([0.1 * i, -0.05, 3.0])
        world = np.eye(4)
        world[:3, :4] = K @ np.concatenate([R, t[:, None]], 1)
        cams[f"world_mat_{i}"] = world @ np.linalg.inv(scale_mat)
        cams[f"scale_mat_{i}"] = scale_mat
    np.savez(scan / "cameras.npz", **cams)
    if n_points:
        pts_dir = root / "Points" / "stl"
        pts_dir.mkdir(parents=True, exist_ok=True)
        num = tag.replace("scan", "").zfill(3)
        pts = (rng.random((n_points, 3)) * 100 + 500).astype(np.float32)
        jax_save_ply(pts_dir / f"stl{num}_total.ply", pts)
    return scan


def _same_dataset(ds, jds):
    assert (ds.name, ds.tag, len(ds)) == (jds.name, jds.tag, len(jds))
    np.testing.assert_array_equal(ds.imgs, jds.imgs)
    for k in ("K", "R", "T"):  # both from the same float64 decomposition
        np.testing.assert_allclose(getattr(ds, k), getattr(jds, k), rtol=1e-6,
                                   atol=1e-6, err_msg=k)
    np.testing.assert_array_equal(ds.pc_gt, jds.pc_gt)


# -- PLY, cameras, files, images ------------------------------------------


@pytest.mark.parametrize("colors", [False, True])
def test_ply_reader_reads_jax_binary_ply(tmp_path, colors):
    pts = np.random.default_rng(0).random((100, 3)).astype(np.float32)
    cols = np.random.default_rng(1).random((100, 3)) if colors else None
    jax_save_ply(tmp_path / "j.ply", pts, cols)
    np.testing.assert_array_equal(load_ply(tmp_path / "j.ply"), pts)
    # and the port's writer writes the JAX writer's bytes
    save_ply(tmp_path / "t.ply", pts, cols)
    assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()


def test_ply_reader_reads_ascii(tmp_path):
    pts = np.random.default_rng(2).random((50, 3)).astype(np.float32)
    header = ["ply", "format ascii 1.0", "comment written by hand", "element vertex 50",
              "property float x", "property float y", "property float z",
              "property uchar red", "property uchar green", "property uchar blue",
              "element face 0", "property list uchar int vertex_indices", "end_header"]
    rows = [f"{x:.7f} {y:.7f} {z:.7f} 10 20 30" for x, y, z in pts]
    (tmp_path / "a.ply").write_text("\n".join(header + rows) + "\n")
    got = load_ply(tmp_path / "a.ply")
    np.testing.assert_array_equal(got, jax_load_ply(tmp_path / "a.ply"))
    np.testing.assert_allclose(got, pts, atol=1e-6)


def test_camera_conversions_match_jax():
    rng = np.random.default_rng(3)
    for i in range(5):
        K = np.array([[2400.0 + 50 * i, 2.0, 790.0 + 5 * i], [0, 2380.0, 610.0],
                      [0, 0, 1.0]])
        q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
        R = q * np.sign(np.linalg.det(q))
        P = K @ np.concatenate([R, rng.standard_normal((3, 1))], 1) * (1 + i)
        for got, ref in zip(tcams.decompose_projection(P), jcams.decompose_projection(P)):
            np.testing.assert_array_equal(got, np.asarray(ref))
        for size in ((1200, 1600), (576, 768)):
            got = tcams.camera_from_opencv_projection(P, size)
            ref = jcams.camera_from_opencv_projection(P, size)
            for g, r in zip(got, ref):
                np.testing.assert_array_equal(g, np.asarray(r))
        # the inverse gives back a projection without skew (the internal
        # camera has none), up to its scale
        K[0, 1] = 0.0
        P = K @ np.concatenate([R, rng.standard_normal((3, 1))], 1) * (1 + i)
        back = tcams.opencv_projection_from_camera(
            *tcams.camera_from_opencv_projection(P, (1200, 1600)), (1200, 1600))
        np.testing.assert_allclose(back / back[2, 3], P / P[2, 3], rtol=1e-5,
                                   atol=1e-5 * np.abs(P / P[2, 3]).max())


def test_get_files_from_and_load_image_match_jax(tmp_path):
    (tmp_path / "sub").mkdir()
    rng = np.random.default_rng(4)
    for name in ("b.png", "a.jpg", "sub/c.PNG", "d.txt"):
        if name.endswith("txt"):
            (tmp_path / name).write_text("x")
            continue
        img = (rng.random((20, 30, 3)) * 255).astype(np.uint8)
        Image.fromarray(img).save(tmp_path / name)
    for kw in (dict(valid_extensions=tbase.IMG_EXTENSIONS, recursive=True, sort=True),
               dict(valid_extensions="png", sort=True), dict(sort=True)):
        assert (tmisc.get_files_from(tmp_path, **kw)
                == jmisc.get_files_from(tmp_path, **kw))
    assert tbase.IMG_EXTENSIONS == jbase.IMG_EXTENSIONS
    for size in ((20, 30), (12, 16)):
        np.testing.assert_array_equal(tbase.load_image(tmp_path / "b.png", size),
                                      jbase.load_image(tmp_path / "b.png", size))


# -- loaders ----------------------------------------------------------------


@pytest.mark.parametrize("split", ["train", "val", "test"])
def test_load_dtu_matches_jax(tmp_path, split):
    make_idr_scan(tmp_path / "DTU", "scan24", n_views=7, scale_mat=SCALE_MAT)
    kw = dict(root=tmp_path / "DTU")
    for view_ids in (None, [5, 1, 3, 0]):
        ds = load_dtu(split, (24, 32), "scan24", view_ids=view_ids, **kw)
        jds = jax_load_dtu(split, (24, 32), "scan24", view_ids=view_ids, **kw)
        _same_dataset(ds, jds)
        np.testing.assert_array_equal(ds.scale_mat, jds.scale_mat)
    # the GT goes into the normalized world through the inverse scale matrix
    raw = jax_load_ply(tmp_path / "DTU" / "Points" / "stl" / "stl024_total.ply")
    np.testing.assert_allclose(ds.pc_gt * 210.0 + SCALE_MAT[:3, 3], raw, rtol=1e-6)
    ordered = load_dtu(split, (24, 32), "scan24", **kw)
    if split != "train":  # the seeded split shuffle reorders the views
        assert not np.array_equal(ordered.imgs, load_dtu("train", (24, 32), "scan24",
                                                          **kw).imgs)


def test_load_dtu_without_points_and_unknown_keys(tmp_path):
    make_idr_scan(tmp_path / "DTU", "scan3", n_points=0)
    ds = load_dtu("train", (12, 16), "scan3", root=tmp_path / "DTU")
    jds = jax_load_dtu("train", (12, 16), "scan3", root=tmp_path / "DTU")
    _same_dataset(ds, jds)
    assert (ds.pc_gt == 0).all() and ds.pc_gt.shape == (1, 3)
    with pytest.raises(ValueError):
        load_dtu("train", (12, 16), "scan3", root=tmp_path / "DTU", n_views=3)


@pytest.mark.parametrize("split,n", [("train", 12), ("val", 5), ("test", 10)])
def test_load_bmvs_matches_jax(tmp_path, split, n):
    make_idr_scan(tmp_path / "BMVS", "scan6", n_views=12, n_points=0)
    ds = load_bmvs(split, (24, 32), "scan6", root=tmp_path / "BMVS")
    jds = jax_load_bmvs(split, (24, 32), "scan6", root=tmp_path / "BMVS")
    _same_dataset(ds, jds)
    assert len(ds) == n and (ds.pc_gt == 0).all() and ds.scale_mat is None
    ds = load_bmvs(split, (24, 32), "scan6", view_ids=[7, 2, 9, 4, 0, 1, 3],
                   root=tmp_path / "BMVS")
    jds = jax_load_bmvs(split, (24, 32), "scan6", view_ids=[7, 2, 9, 4, 0, 1, 3],
                        root=tmp_path / "BMVS")
    _same_dataset(ds, jds)


def test_factory_loads_dtu_and_bmvs_and_refuses_nerfstudio(tmp_path):
    make_idr_scan(tmp_path / "DTU", "scan24", n_views=9)
    make_idr_scan(tmp_path / "BMVS", "scan6", n_views=12, n_points=0)
    cfgs = {"dtu": ({"name": "dtu", "tag": "scan24", "img_size": [24, 32],
                     "root": str(tmp_path / "DTU"), "n_workers": 4}, (9, 9, 9)),
            "bmvs": ({"name": "bmvs", "tag": "scan6", "img_size": [24, 32],
                      "root": str(tmp_path / "BMVS")}, (12, 5, 10))}
    for cfg, sizes in cfgs.values():
        loaders = create_train_val_test_loader(
            {"dataset": cfg, "training": {"batch_size": 4}}, device="cpu")
        assert tuple(len(ld.dataset) for ld in loaders) == sizes
        assert [ld.shuffle for ld in loaders] == [True, False, False]
        inp, lab = next(iter(loaders[0]))
        assert inp["imgs"].shape == (4, 24, 32, 3)
    # an unknown dataset name fails as in the JAX package
    from dbw_tpu.data import get_dataset as jax_get_dataset
    from dbw_torch.data import get_dataset

    for lookup in (get_dataset, jax_get_dataset):
        with pytest.raises(KeyError):
            lookup("colmap")


# -- the neighbour library and the protocol --------------------------------


def test_neighbour_library_matches_jax_native():
    from dbw_tpu import native as jnative
    from dbw_torch import native

    assert native.SRC.read_bytes() == (
        jnative._SRC.read_bytes()), "the port's neighbors.cpp is a copy"
    rng = np.random.default_rng(5)
    pts = rng.random((5000, 3)).astype(np.float32) * 10
    q = rng.random((2000, 3)).astype(np.float32) * 10
    d, i = native.NativeKDTree(pts).query(q)
    jd, ji = jnative.NativeKDTree(pts).query(q)
    np.testing.assert_array_equal(d, jd)
    np.testing.assert_array_equal(i, ji)
    for r in (0.05, 0.3):
        np.testing.assert_array_equal(native.greedy_radius_mask(pts / 10, r),
                                      jnative.greedy_radius_downsample_native(pts / 10, r))
    assert native.build().parent.name == ".dbw_torch_build"


def test_neighbour_library_build_failure_raises(tmp_path, monkeypatch):
    from dbw_torch import native

    bad = tmp_path / "neighbors.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build()


def test_sample_mesh_surface_bitwise():
    from dbw_tpu.eval.dtu_eval import sample_mesh_surface as jax_sample
    from dbw_torch.eval.dtu_eval import sample_mesh_surface

    v, f = icosphere(2)
    for scale in (20.0, 3.0):
        np.testing.assert_array_equal(sample_mesh_surface(v * scale, f),
                                      jax_sample(v * scale, f))


@pytest.fixture
def protocol_scan(tmp_path):
    """The icosphere scan of tests/test_datasets.py's protocol test: GT
    points on a 20 mm sphere, an all-observed 1 mm grid, the ground plane
    far below."""
    from scipy.io import savemat

    from dbw_tpu.eval.metrics import sample_points_from_mesh

    scan_id = 7
    root = tmp_path / "DTU"
    (root / "ObsMask").mkdir(parents=True)
    (root / "Points" / "stl").mkdir(parents=True)
    v, f = icosphere(2)
    v = v * 20.0
    gt = sample_points_from_mesh(v, f, 30000)
    jax_save_ply(root / "Points" / "stl" / f"stl{scan_id:03}_total.ply", gt)
    savemat(root / "ObsMask" / f"ObsMask{scan_id}_10.mat",
            {"ObsMask": np.ones((60, 60, 60), np.uint8),
             "BB": np.array([[-30.0, -30.0, -30.0], [30.0, 30.0, 30.0]]),
             "Res": np.array([[1.0]])})
    savemat(root / "ObsMask" / f"Plane{scan_id}.mat",
            {"P": np.array([[0.0], [0.0], [1.0], [100.0]])})
    return root, scan_id, v, f


def test_evaluate_mesh_matches_jax(tmp_path, protocol_scan):
    from dbw_tpu.eval.dtu_eval import evaluate_mesh as jax_evaluate_mesh
    from dbw_torch.eval.dtu_eval import evaluate_mesh

    root, scan_id, v, f = protocol_scan
    outs = {}
    for name, fn in (("port", evaluate_mesh), ("jax", jax_evaluate_mesh)):
        out = tmp_path / name
        out.mkdir()
        outs[name] = (out, fn(v, f, scan_id, root, out, save_viz=True),
                      fn(v + np.array([5.0, 0, 0]), f, scan_id, root, out, suffix="_s",
                         save_viz=False))
    (out, res, shifted), (jout, jres, jshifted) = outs["port"], outs["jax"]
    for got, ref in ((res, jres), (shifted, jshifted)):
        for k in ("acc", "comp", "avg"):  # the same float64 numpy: 1e-9
            assert got[k] == pytest.approx(ref[k], rel=1e-9), k
    assert res["avg"] < 0.5 and shifted["avg"] > res["avg"] + 1.0
    for name in ("dtu_scores.tsv", "dtu_scores_s.tsv", f"vis_{scan_id:03}_d2s.ply",
                 f"vis_{scan_id:03}_s2d.ply"):
        assert (out / name).read_bytes() == (jout / name).read_bytes(), name
    assert (out / "dtu_scores.tsv").read_text().splitlines()[0] == "acc\tcomp\tavg"


def test_evaluate_mesh_reports_its_timings(tmp_path, protocol_scan):
    from dbw_torch.eval.dtu_eval import evaluate_mesh

    root, scan_id, v, f = protocol_scan
    timings = {}
    evaluate_mesh(v, f, scan_id, root, tmp_path, save_viz=False, timings=timings)
    assert set(timings) == {"sample", "downsample", "d2s", "s2d"}
    assert all(t >= 0 for t in timings.values())
