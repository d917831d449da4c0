"""The scans on the CPU: the IDR layout written exactly as before
``scan.write`` chose by layout, a nerfstudio capture that the port's own
loader reads as the harness's reader does, an unknown layout refused, the
render size taken from the scan where the dataset gives none, and nothing
of the port imported by ``scan.py``."""

import hashlib
import json
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image

from benchmark import scan
from benchmark.tests.toycell import ROOT, toy_config

# the IDR scan below as the harness wrote it before ``scan.write`` (its
# files' contents: each PNG's mode, size and pixels, each array of
# cameras.npz; the npz's zip headers carry the time of writing)
IDR_SEED, IDR_VIEWS, IDR_WRITE, IDR_RAW = 2**31 + 7, 3, [12, 16], [48, 64]
IDR_DIGEST = "e8268c8b4601b4d322eb896e23d3e79a33505673874b2463a92692d173ef5e66"


def content_digest(d):
    h = hashlib.sha256()
    for f in sorted(p for p in d.rglob("*") if p.is_file()):
        h.update(f.relative_to(d).as_posix().encode())
        if f.suffix == ".npz":
            with np.load(f) as z:
                for k in sorted(z.files):
                    a = np.ascontiguousarray(z[k])
                    h.update(f"{k} {a.dtype.str} {a.shape}".encode())
                    h.update(a.tobytes())
        else:
            img = Image.open(f)
            h.update(f"{img.mode} {img.size}".encode())
            h.update(img.tobytes())
    return h.hexdigest()


def test_idr_scan_is_written_as_before(tmp_path):
    config = {"scan": {"layout": "idr", "n_views": IDR_VIEWS, "write_size": IDR_WRITE,
                       "raw_size": IDR_RAW},
              "config": {"dataset": {"name": "dtu", "tag": "scan24"}}}
    d = scan.write(config, tmp_path, IDR_SEED)
    assert d == tmp_path / "scan24"
    assert content_digest(d) == IDR_DIGEST


def test_idr_scan_takes_the_configured_camera(tmp_path):
    config = toy_config("idr")
    config["scan"]["intrinsics"] = {"fl_x": 2000.0, "fl_y": 2000.0, "cx": 810.0, "cy": 590.0}
    d = scan.write(config, tmp_path, 4)
    imgs, K, R, T = scan.read(config, d)
    assert imgs.shape == (8, 16, 20, 3)
    np.testing.assert_allclose(K[0], scan.ndc_from_pixels(config["scan"]["intrinsics"],
                                                          (1200, 1600)), rtol=1e-5)
    # through the projection matrix and its decomposition, in float32
    assert K[0, 0, 0] == pytest.approx(2000 / 600, abs=1e-6)
    assert K[0, 0, 2] == pytest.approx(-10 / 600, abs=1e-6)


@pytest.mark.parametrize("n_views", [3, 12])
def test_port_reads_the_nerfstudio_capture_as_the_harness(tmp_path, n_views):
    from dbw_torch.data import load_nerfstudio

    config = toy_config("nerfstudio")
    config["scan"]["n_views"] = n_views
    d = scan.write(config, tmp_path, 2**31 + 9)
    assert sorted(p.name for p in d.iterdir()) == ["images", "transforms.json"]
    meta = json.loads((d / "transforms.json").read_text())
    assert (meta["h"], meta["w"]) == (36, 64)
    assert {k: meta[k] for k in ("fl_x", "fl_y", "cx", "cy")} == config["scan"]["intrinsics"]
    imgs, K, R, T = scan.read(config, d)
    ds = load_nerfstudio("train", None, "campanile", downscale_factor=2, root=tmp_path)
    assert imgs.shape == (n_views, 18, 32, 3)
    assert np.array_equal(ds.imgs, imgs)
    for got, want in ((ds.K, K), (ds.R, R), (ds.T, T)):
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # the arc of ``views``, in view order, and the configuration's camera
    _, R0, T0 = scan.views(2**31 + 9, n_views, (18, 32))
    np.testing.assert_allclose(R, R0, rtol=0, atol=1e-6)
    np.testing.assert_allclose(T, T0, rtol=0, atol=1e-6)
    np.testing.assert_allclose(K[0], scan.camera(config), rtol=0, atol=1e-6)


def test_nerfstudio_capture_without_intrinsics_has_the_default_camera(tmp_path):
    config = toy_config("nerfstudio")
    del config["scan"]["intrinsics"]
    K = scan.read(config, scan.write(config, tmp_path, 5))[1]
    np.testing.assert_allclose(K[0], scan.K_NDC, rtol=0, atol=1e-6)


def test_an_unknown_layout_is_refused(tmp_path):
    config = toy_config("idr")
    config["scan"]["layout"] = "colmap"
    with pytest.raises(ValueError, match="colmap"):
        scan.write(config, tmp_path, 1)
    with pytest.raises(ValueError, match="colmap"):
        scan.read(config, tmp_path)
    assert not any(tmp_path.iterdir())


def test_sizes_that_disagree_are_refused(tmp_path):
    config = toy_config("nerfstudio")
    assert scan.render_size(config) == (18, 32)
    config["config"]["dataset"]["img_size"] = [18, 32]
    assert scan.render_size(config) == (18, 32)
    config["config"]["dataset"]["img_size"] = [36, 64]
    with pytest.raises(ValueError, match="img_size"):
        scan.render_size(config)
    config = toy_config("nerfstudio")
    config["config"]["dataset"]["downscale_factor"] = 4
    with pytest.raises(ValueError, match="downscale_factor"):
        scan.write(config, tmp_path, 1)


def test_scan_imports_nothing_of_the_port(tmp_path):
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from benchmark import scan\n"
        "from benchmark.tests.toycell import toy_config\n"
        "for layout in ('idr', 'nerfstudio'):\n"
        "    c = toy_config(layout)\n"
        "    scan.read(c, scan.write(c, %r + '/' + layout, 3))\n"
        "print(sorted({m.split('.')[0] for m in sys.modules} & {'dbw_torch', 'dbw_tpu', 'jax'}))\n"
    ) % (str(ROOT), str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd="/", timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
