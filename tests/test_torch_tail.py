"""The tail modules of the PyTorch port against the JAX package on the CPU:
``ops/mesh_utils.py`` (the cases of tests/test_eval_utils.py), the EMS /
MBF baseline pipelines of ``eval/baselines.py`` on tests/test_baselines.py's
fake DTU scan, the builders of ``models/tools.py`` (the same initial
weights, parameter counts and outputs), and the pipeline scripts'
commands."""

import os
import subprocess
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from dbw_tpu.models import tools as jtools
from dbw_tpu.ops import mesh_utils as jmu
from dbw_tpu.ops.icosphere import icosphere
from dbw_torch.models import tools
from dbw_torch.ops import mesh_utils as mu
from tests.test_baselines import SCAN, dtu_root  # noqa: F401  (the fixture)

ROOT = Path(__file__).resolve().parents[1]


# -- mesh utilities ---------------------------------------------------------


@pytest.mark.parametrize("scale_mode", ["unit_cube", "unit_sphere", "none"])
def test_normalize_mesh_matches_jax(scale_mode):
    v, _ = icosphere(1)
    v = v * np.array([3.0, 1.0, 2.0], np.float32) + 1
    got, ref = mu.normalize_mesh(v, scale_mode=scale_mode), jmu.normalize_mesh(
        v, scale_mode=scale_mode)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    if scale_mode == "unit_cube":
        assert np.abs(got[0]).max() == pytest.approx(0.5, rel=1e-5)


def test_repeat_mesh_matches_jax():
    v, f = icosphere(0)
    got, ref = mu.repeat_mesh(v, f, 3), jmu.repeat_mesh(v, f, 3)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    assert got[1].max() == 3 * len(v) - 1


@pytest.mark.parametrize("level", [1, 2])
def test_normal_consistency_matches_jax(level):
    """Value and gradient in the vertices, on a bumped icosphere."""
    v, f = icosphere(level)
    v = v * (1 + 0.1 * np.random.default_rng(level).random((len(v), 1))).astype(np.float32)
    tv = torch.tensor(v, requires_grad=True)
    got = mu.normal_consistency(tv, f)
    got.backward()
    got = got.detach()
    ref, jg = jax.value_and_grad(lambda x: jmu.normal_consistency(x, f))(jnp.asarray(v))
    assert float(got) == pytest.approx(float(ref), rel=1e-5)
    np.testing.assert_allclose(tv.grad.numpy(), np.asarray(jg), atol=1e-5 * np.abs(jg).max())
    smooth = float(mu.normal_consistency(icosphere(2)[0], icosphere(2)[1]))
    assert 0 < smooth < 0.1


def test_voxelize_matches_jax():
    v, f = icosphere(1)
    got = mu.voxelize(v, f, size=16)
    np.testing.assert_array_equal(got, jmu.voxelize(v, f, size=16))
    assert got.shape == (16, 16, 16) and got.sum() > 50


@pytest.mark.parametrize("kw", [dict(n_elev=3, n_azim=4),
                                dict(n_elev=2, n_azim=5, elev_range=(-30, 60),
                                     azim_range=(0, 90), N=10)])
def test_init_rotations_matches_jax(kw):
    got = mu.init_rotations("uniform", **kw)
    np.testing.assert_array_equal(got, jmu.init_rotations("uniform", **kw))
    assert got.shape == (kw["n_elev"] * kw["n_azim"], 3)
    rnd = mu.init_rotations("random", N=4, rng=np.random.default_rng(2))
    np.testing.assert_allclose(rnd, jmu.init_rotations("random", N=4,
                                                       rng=np.random.default_rng(2)),
                               atol=1e-6)
    with pytest.raises(NotImplementedError):
        mu.init_rotations("bogus")


# -- the EMS / MBF baselines --------------------------------------------------


def _patch(monkeypatch, tmp_path, dtu_root, which):
    """Point one package's baselines at the fake DTU root and its own
    external/ directories under tmp_path/which."""
    if which == "jax":
        import dbw_tpu.data.dtu as dtu_mod
        import dbw_tpu.eval.baselines as bl
    else:
        import dbw_torch.data.dtu as dtu_mod
        import dbw_torch.eval.baselines as bl
    monkeypatch.setattr(dtu_mod, "DATASETS_PATH", dtu_root)
    monkeypatch.setattr(bl, "DATASETS_PATH", dtu_root)
    monkeypatch.setattr(bl, "EVAL_SCAN_IDS", [SCAN])
    monkeypatch.setattr(bl, "EMS_PATH", tmp_path / which / "external" / "ems")
    monkeypatch.setattr(bl, "MBF_PATH", tmp_path / which / "external" / "mbf")
    monkeypatch.setattr(bl, "N_POINTS_EVAL", 5000)
    return bl


def _scores(path):
    rows = path.read_text().splitlines()
    return dict(zip(rows[0].split("\t"), map(float, rows[1].split("\t"))))


def _ems_fit(pre_dir, scale):
    sq = np.array([[1.0, 1.0, 20 * scale[3], 20 * scale[3], 20 * scale[3], 0.0, 0.3, 0.0,
                    -scale[0] * scale[3], -scale[1] * scale[3], -scale[2] * scale[3]]],
                  np.float32)
    np.save(pre_dir / f"{SCAN}_spq.npy", sq)


def _mbf_fit(pre_dir, scale):
    h, c = 20 * scale[3], -scale[:3] * scale[3]
    corners = np.array([[x, y, z] for x in (-h, h) for y in (-h, h) for z in (-h, h)]) + c
    (pre_dir / SCAN).mkdir()
    (pre_dir / SCAN / "UH.json").write_text(
        __import__("json").dumps({"bbox": [corners.tolist()]}))


@pytest.mark.parametrize("name", ["ems", "mbf"])
def test_baseline_pipeline_matches_jax(tmp_path, monkeypatch, dtu_root, name):  # noqa: F811
    """Preprocessing (the standardized cloud and its scale record, equal),
    then the evaluation of a fake fit (its chamfer scores and the official
    protocol's scores within 1e-4 relative of the JAX package's)."""
    out = {}
    for which in ("jax", "port"):
        bl = _patch(monkeypatch, tmp_path, dtu_root, which)
        kw = {} if which == "jax" else {"device": "cpu"}
        base = bl.EMS_PATH if name == "ems" else bl.MBF_PATH
        pre_dir = base / "dtu" / "run1"
        bl.DTU3DPreprocess(pre_dir, name, **kw).run(seed=0)
        scale = np.load(pre_dir / f"{SCAN}_scale.npy")
        (_ems_fit if name == "ems" else _mbf_fit)(pre_dir, scale)
        ev_dir = tmp_path / which / "runs" / name / "run1"
        (bl.EMSEvaluator if name == "ems" else bl.MBFEvaluator)(ev_dir, "run1", **kw).run(seed=0)
        out[which] = (pre_dir, ev_dir, scale)
    (jpre, jev, jscale), (pre, ev, scale) = out["jax"], out["port"]
    np.testing.assert_array_equal(scale, jscale)
    assert (pre / f"{SCAN}.ply").read_bytes() == (jpre / f"{SCAN}.ply").read_bytes()
    for tsv in (f"{SCAN}_scores.tsv", f"dtu_scores_{SCAN}.tsv"):
        got, ref = _scores(ev / tsv), _scores(jev / tsv)
        assert list(got) == list(ref)
        for k in ref:
            assert got[k] == pytest.approx(ref[k], rel=1e-4, abs=1e-5), (tsv, k)
    assert _scores(ev / f"{SCAN}_scores.tsv")["n_blocks"] == 1


def test_baselines_cli_runs_on_the_cpu(tmp_path):
    """``python -m dbw_torch.eval.baselines`` parses its modes and takes
    ``--cpu``; without a DTU scan under datasets/ it fails for want of it."""
    proc = subprocess.run(
        ["python", "-m", "dbw_torch.eval.baselines", "--help"], cwd=ROOT,
        capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert proc.returncode == 0 and "--cpu" in proc.stdout and "process" in proc.stdout


# -- the generic builders -----------------------------------------------------


@pytest.mark.parametrize("kw", [dict(), dict(n_layers=0), dict(zero_last_init=True),
                                dict(zero_last_init=0.01, bias_last=False, n_units=16)])
def test_mlp_matches_jax(kw):
    jp, japply = jtools.create_mlp(5, 4, seed=3, **kw)
    m = tools.create_mlp(5, 4, seed=3, **kw)
    assert tools.count_parameters(m) == int(jtools.count_parameters(
        [x for wb in jp for x in wb if x is not None]))
    for lin, (w, b) in zip(m.layers, jp):
        np.testing.assert_array_equal(lin.weight.detach().numpy().T, np.asarray(w))
        assert (lin.bias is None) == (b is None)
    x = np.random.default_rng(0).standard_normal((7, 5)).astype(np.float32)
    np.testing.assert_allclose(m(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(japply(jp, jnp.asarray(x))), atol=1e-5)


def test_conv_blur_upsample_match_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 6, 8, 4)).astype(np.float32)
    w3, w1 = tools.make_conv3x3(4, 5, seed=2), tools.make_conv1x1(4, 5, seed=2)
    np.testing.assert_array_equal(w3.numpy(), np.asarray(jtools.make_conv3x3(4, 5, seed=2)))
    np.testing.assert_array_equal(w1.numpy(), np.asarray(jtools.make_conv1x1(4, 5, seed=2)))
    assert not tools.make_conv3x3(4, 5, zero_init=True).any()
    b = rng.standard_normal(5).astype(np.float32)
    tx = torch.from_numpy(x)
    for w, pad, stride in ((w3, 1, 1), (w1, 0, 1), (w3, 1, 2)):
        got = tools.conv2d(tx, w, torch.from_numpy(b), stride=stride, padding=pad)
        ref = jtools.conv2d(jnp.asarray(x), jnp.asarray(w.numpy()), b, stride=stride,
                            padding=pad)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4)
    np.testing.assert_allclose(tools.blur3x3(tx).numpy(),
                               np.asarray(jtools.blur3x3(jnp.asarray(x))), atol=1e-5)
    for mode in ("nn", "bilinear", "bilinear_blur"):
        got = tools.upsample2x(tx, mode)
        assert got.shape == (2, 12, 16, 4)
        np.testing.assert_allclose(got.numpy(), np.asarray(
            jtools.upsample2x(jnp.asarray(x), mode)), atol=1e-5, err_msg=mode)
    t = torch.tensor([3.0, 5.0, 4.0])
    np.testing.assert_allclose(tools.linear_normalize(t).numpy(),
                               np.asarray(jtools.linear_normalize(jnp.asarray(t.numpy()))))


# -- the pipeline scripts -----------------------------------------------------


def _run_script(tmp_path, script, **env):
    """Run a pipeline script with a ``python`` stub first on the PATH that
    records its arguments; returns the recorded command lines."""
    stub = tmp_path / "bin" / "python"
    stub.parent.mkdir(exist_ok=True)
    log = tmp_path / "calls.txt"
    stub.write_text(f'#!/bin/bash\necho "$@" >> {log}\n')
    stub.chmod(0o755)
    env = dict(os.environ, PATH=f"{stub.parent}:{os.environ['PATH']}", **env)
    subprocess.run(["bash", script], cwd=ROOT, env=env, check=True, timeout=60)
    return log.read_text().splitlines()


def test_pipeline_scripts_call_the_port(tmp_path):
    calls = _run_script(tmp_path, "scripts/torch_pipeline.sh", config="dtu/scan24.yml",
                        tag="7_a", cpu="1")
    assert calls == ["-m dbw_torch.train.trainer --tag 7_a --config dtu/scan24.yml --cpu"]
    calls = _run_script(tmp_path, "scripts/torch_dtu.sh", tag="9sweep")
    assert len(calls) == 11 and calls[-1].startswith("-m dbw_torch.train.trainer --tag "
                                                     "9sweep_scan105 --config dtu/scan105.yml")
    calls = _run_script(tmp_path, "scripts/torch_dtu.sh", tag="sw", sharded="1", cpu="1")
    assert calls[-1].startswith("scripts/torch_multi_scene_pipeline.py -t sw -c dtu/scan24.yml")
    assert calls[-1].endswith("dtu/scan105.yml --cpu")
