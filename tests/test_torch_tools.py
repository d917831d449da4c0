"""The port's model registry and its tools around a finished run.

- ``dbw_torch.models.create_model`` raises KeyError where the JAX
  package's does: a config without ``model.name`` (the overlay configs
  loaded without ``-d``) and an unknown name; the trainers build their
  model through it. ``load_model_from_checkpoint`` raises KeyError for an
  unknown ``model_name``, as JAX's does.
- ``scripts/torch_requant_run.py`` on a tiny CPU Trainer run (10 blocks, so
  that ``final_scores.tsv`` has r5's columns) rewrites the scores equal to
  the Trainer's own (rtol 1e-6) and writes its provenance note, also from
  a JAX-written ``model.pkl`` of the same parameters.
- ``scripts/torch_viz_probe.py`` and ``scripts/torch_trace_bench.py`` print
  their tables on the CPU, every row finite.
"""

import copy
import importlib
import math
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from dbw_torch import models
from dbw_torch.train import checkpoint as ck
from dbw_torch.train import multi_scene, multi_seed
from dbw_torch.train import trainer as trainer_mod
from dbw_torch.train.trainer import Trainer
from dbw_torch.utils.config import dump_yaml, load_yaml

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = ROOT / "configs"
R5_SCORES = ROOT / "runs" / "synthetic" / "dtu_shaped_r5" / "final_scores.tsv"
SCORES_RTOL = 1e-6
# configs that set no model.name: each works over a -d default only
OVERLAYS = ("synthetic/ab_nopercep.yml", "synthetic/ab_vgg_s0.yml",
            "synthetic/ab_vggseed1.yml", "synthetic/divergent.yml",
            "synthetic/dtu_shaped_p300.yml", "synthetic/dtu_shaped_seed2.yml",
            "probe/proto_probe.yml", "probe/proto_probe_vmap.yml",
            "probe/interval_probe.yml")

CFG = {
    "dataset": {"name": "synthetic", "tag": "t0", "img_size": [16, 20],
                "n_views": 8, "seed": 3},
    "model": {
        "name": "dbw",
        "mesh": dict(n_blocks=10, S_world=1.0, R_world=[0, 0, 0], txt_size=8,
                     T_range=[0.5, 0.5, 0.5], opacity_init=0.9),
        "renderer": dict(faces_per_pixel=2, detach_bary=True, z_clip=0.001),
        "rend_optim": dict(coarse_learning=3, decimate_txt=2, decimate_factor=4,
                           kill_blocks=True, decouple_rendering=True,
                           opacity_noise=True),
        "loss": dict(rgb_weight=1, parsimony_weight=0.01, tv_weight=0.1,
                     overlap_weight=1),
    },
    "training": {
        "batch_size": 3, "n_epoches": 2, "steps_per_call": 2,
        "optimizer": {"name": "adam", "lr": 5e-3, "texture": {"lr": 5e-2}},
        "scheduler": {"name": "multi_step", "gamma": [0.1, 0.1], "milestones": [2]},
        "train_stat_interval": 2, "val_stat_interval": 4,
        "eval": {"n_traj_videos": 0, "NV": 2, "n_views": 2, "render_videos": False},
        "seed": 123,
    },
}


def _script(name):
    sys.path.insert(0, str(ROOT / "scripts"))
    try:
        return importlib.import_module(name)
    finally:
        sys.path.remove(str(ROOT / "scripts"))


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two torch threads: the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# -- the registry ----------------------------------------------------------------


def test_create_model_raises_key_error_as_jax():
    """No model.name and an unknown name raise KeyError in both packages; a
    named config builds the blocks-world model."""
    from dbw_tpu.models import create_model as jax_create_model

    nameless = {"model": {k: v for k, v in copy.deepcopy(CFG["model"]).items()
                          if k != "name"}}
    unknown = {"model": dict(copy.deepcopy(CFG["model"]), name="nerf")}
    for cfg in (nameless, unknown):
        with pytest.raises(KeyError):
            jax_create_model(copy.deepcopy(cfg), (16, 20))
        with pytest.raises(KeyError):
            models.create_model(copy.deepcopy(cfg), (16, 20), device="cpu")
    m = models.create_model(copy.deepcopy(CFG), (16, 20), device="cpu")
    assert isinstance(m, models.get_model("dbw")) and m.n_blocks == 10
    with pytest.raises(KeyError):
        models.get_model("nerf")


@pytest.mark.parametrize("config", OVERLAYS)
def test_overlay_config_without_default_raises(config):
    """An overlay config loaded without -d has no model.name: both packages
    refuse to build it."""
    from dbw_tpu.models import create_model as jax_create_model
    from dbw_tpu.utils.config import load_yaml as jax_load_yaml

    cfg, jcfg = load_yaml(CONFIGS / config), jax_load_yaml(CONFIGS / config)
    assert "name" not in cfg.get("model", {})
    with pytest.raises(KeyError):
        jax_create_model(jcfg, (16, 20))
    with pytest.raises(KeyError):
        models.create_model(cfg, (16, 20), device="cpu")


def test_trainers_build_through_the_registry(tmp_path):
    """The Trainer, the protocol and the multi-scene trainer take
    create_model from dbw_torch.models: a Trainer on a nameless config
    raises KeyError."""
    for mod in (trainer_mod, multi_seed, multi_scene):
        assert mod.create_model is models.create_model
    cfg = copy.deepcopy(CFG)
    del cfg["model"]["name"]
    with pytest.raises(KeyError):
        Trainer(cfg, tmp_path / "run", device="cpu", seed=123)


def test_load_model_from_checkpoint_unknown_name_raises(tmp_path):
    """An unknown model_name raises KeyError in both packages; the name
    among the model kwargs is ignored (JAX's rule)."""
    from dbw_tpu.models import load_model_from_checkpoint as jax_load

    assert models.load_model_from_checkpoint is ck.load_model_from_checkpoint
    m = models.create_model(copy.deepcopy(CFG), (16, 20), device="cpu")
    params = m.init_params(seed=0)
    kw = copy.deepcopy(CFG["model"])
    for name, ok in (("nerf", False), ("dbw", True)):
        path = ck.save_checkpoint(tmp_path / f"{name}.pkl", params, None, 1, 1,
                                  model_name=name, model_kwargs=dict(kw, name="nerf"))
        if ok:
            model, p, _ = models.load_model_from_checkpoint(path, (16, 20), device="cpu")
            assert model.n_blocks == 10 and torch.equal(p["T"], params["T"])
            continue
        with pytest.raises(KeyError):
            jax_load(path, (16, 20))
        with pytest.raises(KeyError):
            models.load_model_from_checkpoint(path, (16, 20), device="cpu")


# -- the tools on a finished run -------------------------------------------------


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """A tiny finished Trainer run with its dumped config, as the Trainer's
    CLI leaves it: (run dir, its final_scores.tsv text)."""
    run = tmp_path_factory.mktemp("tools") / "run"
    t = Trainer(copy.deepcopy(CFG), run, device="cpu", seed=123)
    dump_yaml(copy.deepcopy(CFG), run / "tiny10.yml")
    t.run(seed=123)
    return run, (run / "final_scores.tsv").read_text()


def _scores(text):
    lines = text.splitlines()
    return lines[0].split("\t"), np.array([float(v) for v in lines[1].split("\t")])


def _requant(run_dir, tmp_path, jax_ckpt=False):
    d = tmp_path / "copy"
    shutil.copytree(run_dir, d)
    if jax_ckpt:
        from dbw_tpu.models.dbw import SceneParams
        from dbw_tpu.train.checkpoint import save_checkpoint

        state = ck.load_checkpoint(d / "model.pkl")
        params = SceneParams(**{k: np.asarray(v) for k, v in state["model_state"].items()})
        save_checkpoint(d / "model.pkl", params, None, state["epoch"], state["batch"],
                        model_kwargs=state["model_kwargs"])
    _script("torch_requant_run").main(["--run", str(d), "--cpu"])
    return d


@pytest.mark.parametrize("jax_ckpt", [False, True], ids=["port_ckpt", "jax_ckpt"])
def test_requant_rewrites_the_trainer_scores(run, tmp_path, jax_ckpt):
    run_dir, old = run
    d = _requant(run_dir, tmp_path, jax_ckpt)
    new = (d / "final_scores.tsv").read_text()
    header, vals = _scores(new)
    old_header, old_vals = _scores(old)
    assert header == R5_SCORES.read_text().splitlines()[0].split("\t") == old_header
    np.testing.assert_allclose(vals, old_vals, rtol=SCORES_RTOL)
    assert np.isfinite(vals).all()
    note = (d / "final_scores.requant.txt").read_text()
    assert note.startswith("== requant ") and "ckpt model.pkl" in note
    assert f"previous final_scores.tsv:\n{old}\n" in note
    assert f"new final_scores.tsv:\n{new}\n" in note


def test_viz_probe_prints_finite_times(run, capsys):
    ms, nbytes = _script("torch_viz_probe").main(["--run", str(run[0]), "--cpu"])
    out = capsys.readouterr().out
    labels = ("soft predict (4 views)", "edge overlay (ss4 raster)", "hard predict",
              "synthetic predict", "SUM (viz streams)", "viz D2H pull (3x uint8)",
              "ckpt snapshot (device copy)", "ckpt D2H pull")
    assert tuple(ms) == labels
    assert all(math.isfinite(v) and v > 0 for v in ms.values())
    for label in labels + ("ckpt snapshot bytes",):
        assert label in out
    # the parameters and Adam's two moments of each
    n_params = sum(p.numel() for p in models.create_model(
        copy.deepcopy(CFG), (16, 20), device="cpu").init_params(0).values())
    assert nbytes >= 3 * 4 * n_params


@pytest.mark.parametrize("band", [None, 16], ids=["full", "band"])
def test_trace_bench_prints_finite_table(band, capsys):
    argv = ["--cpu", "--img-size", "24", "32", "--blocks", "3", "--steps", "1",
            "--top", "6"]
    if band:
        argv += ["--band", str(band), "--batch", "2"]
    rows = _script("torch_trace_bench").main(argv)
    out = capsys.readouterr().out
    assert len(rows) == 7 and rows[-1][2].endswith("other ops]")
    assert all(math.isfinite(ms) and ms >= 0 for ms, _, _ in rows)
    assert all(n > 0 for _, n, _ in rows[:-1])
    assert "total CPU op time" in out and rows[0][0] > 0
