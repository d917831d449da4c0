"""The port's multi-scene trainer on the CPU: each scene's slot against the
port Trainer on that scene's config (bit for bit under the map executor,
with scene intrinsics that differ, so the camera swap must be undone;
within a stated tolerance under the default batched (scene, seed) step), the loop against the JAX
MultiSceneTrainer's (the device work stubbed on both sides), per-scene
view accounting, the config checks, and a bitwise kill/resume."""

import copy

import numpy as np
import pytest
import torch

from dbw_torch import data as tdata
from dbw_torch.train import checkpoint as ck
from dbw_torch.train.multi_scene import MULTI_SCENE_CKPT, MultiSceneTrainer
from dbw_torch.train.trainer import Trainer, _pad_ids
from test_torch_trainer import CFG

# the second scene's focal lengths, against the synthetic camera's 2.5
FOCAL = {"sA": 2.5, "sB": 2.2}


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two torch threads: the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def scene_intrinsics(monkeypatch):
    """Synthetic scenes whose dataset intrinsics follow FOCAL by tag."""
    load = tdata.LOADERS["synthetic"]

    def load_with_focal(split, img_size, tag="", **kw):
        ds = load(split, img_size, tag, **kw)
        ds.K = ds.K.copy()
        ds.K[:, 0, 0] = ds.K[:, 1, 1] = FOCAL.get(tag, 2.5)
        return ds

    monkeypatch.setitem(tdata.LOADERS, "synthetic", load_with_focal)


def _scene_cfg(tag, seed, **training):
    cfg = copy.deepcopy(CFG)
    cfg["dataset"].update(tag=tag, seed=seed)
    cfg["training"].update(seed=100 + seed, **training)
    return cfg


def _cfgs(**training):
    return [_scene_cfg("sA", 5, **training), _scene_cfg("sB", 9, **training)]


def test_slots_equal_trainers_bitwise(tmp_path, scene_intrinsics, monkeypatch):
    """Under the map executor scene i's slot is the port Trainer's run of
    scene i's config: the same per-step losses, parameters and Adam
    moments, bit for bit; the scenes' cameras differ, and the model's is
    restored after each."""
    monkeypatch.setenv("DBW_SEED_EXEC", "map")
    cfgs = _cfgs()
    dirs = [tmp_path / "sA", tmp_path / "sB"]
    ms = MultiSceneTrainer(copy.deepcopy(cfgs), dirs, n_seeds=1, device="cpu")
    own = ms.model.camera
    losses = []
    step = ms._train_step

    def record(ids_sc):
        step(ids_sc)
        losses.append(ms._loss_buffer[-1][0].clone())
        assert ms.model.camera is own

    ms._train_step = record
    ms.run()
    losses = torch.stack(losses)  # (steps, n_scene, 1)
    for i, cfg in enumerate(cfgs):
        seed = cfg["training"]["seed"]
        t = Trainer(copy.deepcopy(cfg), tmp_path / f"trainer{i}", device="cpu", seed=seed)
        t.log_visualizations = lambda it: None
        t.save_metric_plots = lambda: None
        t.evaluate = lambda: None
        mine, total = [], t._loss_keys.index("total")
        tstep = t._train_step

        def rec(ids, t=t, mine=mine, tstep=tstep):
            tstep(ids)
            mine.append(t._loss_buffer[-1][0][total].clone())

        t._train_step = rec
        t.run(seed=seed)
        assert torch.equal(losses[:, i, 0], torch.stack(mine)), i
        for k, p in t.params.items():
            assert torch.equal(ms.params[k][i, 0], p), (i, k)
            a, b = ms.optimizer.state[ms.params[k]], t.optimizer.state[p]
            for f in ("exp_avg", "exp_avg_sq"):
                assert torch.equal(a[f][i, 0], b[f]), (i, k, f)
        got = ms.train_metrics[i].read_log()
        ref = t.train_metrics.read_log()
        np.testing.assert_array_equal(got[f"loss_s{seed}"], ref["loss_total"])
        state = ck.load_checkpoint(dirs[i] / "model.pkl")
        np.testing.assert_array_equal(state["model_state"]["T"], t.params["T"].detach().numpy())


def test_batched_slots_match_trainers(tmp_path, scene_intrinsics):
    """Under the default (batched) executor every (scene, seed) slot runs
    in one step, each scene's views with its own intrinsics, and scene i's
    slot follows the port Trainer's run of scene i's config: each step's
    loss within rtol 1e-5 and the final parameters within 1e-5 (the
    backward rounds a few sums otherwise than one slot's, and Adam carries
    that on; measured 2.4e-7 and 1.2e-7); the model keeps its camera."""
    cfgs = _cfgs()
    ms = MultiSceneTrainer(copy.deepcopy(cfgs), [tmp_path / "sA", tmp_path / "sB"],
                           n_seeds=1, device="cpu")
    own = ms.model.camera
    losses = []
    step = ms._train_step

    def record(ids_sc):
        step(ids_sc)
        losses.append(ms._loss_buffer[-1][0].clone())
        assert ms.model.camera is own

    ms._train_step = record
    ms.run()
    losses = torch.stack(losses)
    for i, cfg in enumerate(cfgs):
        seed = cfg["training"]["seed"]
        t = Trainer(copy.deepcopy(cfg), tmp_path / f"trainer{i}", device="cpu", seed=seed)
        t.log_visualizations = lambda it: None
        t.save_metric_plots = lambda: None
        t.evaluate = lambda: None
        mine, total = [], t._loss_keys.index("total")
        tstep = t._train_step

        def rec(ids, t=t, mine=mine, tstep=tstep):
            tstep(ids)
            mine.append(t._loss_buffer[-1][0][total].clone())

        t._train_step = rec
        t.run(seed=seed)
        np.testing.assert_allclose(losses[:, i, 0].numpy(), torch.stack(mine).numpy(),
                                   rtol=1e-5)
        for k, p in t.params.items():
            np.testing.assert_allclose(ms.params[k][i, 0].detach().numpy(),
                                       p.detach().numpy(), atol=1e-5, err_msg=(i, k))


def test_scene_cameras_differ(scene_intrinsics, tmp_path):
    ms = MultiSceneTrainer(_cfgs(), [tmp_path / "a", tmp_path / "b"], device="cpu")
    assert ms.datasets[0].K[0, 0, 0] == 2.5 and ms.datasets[1].K[0, 0, 0] == 2.2
    with torch.no_grad():
        p = {k: v[0, 0] for k, v in ms.params.items()}
        R = torch.from_numpy(ms.datasets[0].R[:1])
        T = torch.from_numpy(ms.datasets[0].T[:1])
        phase = ms.model.phase_for_epoch(0)
        from dbw_torch.parallel.scenes import use_camera

        renders = []
        for cam in ms.cameras:
            with use_camera(ms.model, cam):
                renders.append(ms.model.predict(p, phase, R, T)[0])
        own = ms.model.predict(p, phase, R, T)[0]
    assert not torch.equal(renders[0], renders[1])
    assert torch.equal(own, renders[0])  # the model keeps the first scene's


def _record_scenes(t, events, jax_side):
    """Stub the device work of a MultiSceneTrainer (either package's) so
    that a run records its groups (per-scene padded view ids, LRs) and
    interval actions."""
    lr32 = lambda lrs: {k: float(np.float32(v)) for k, v in lrs.items()}
    if jax_side:
        def step(K, params, opt, imgs, R, T, idx, phase, lrs, keys):
            events.append(("group", [np.asarray(idx).tolist()], lr32(lrs)))
            return params, opt, None

        def multi(K, params, opt, imgs, R, T, idx_s, phase, lrs, keys_s):
            events.append(("group", np.asarray(idx_s).tolist(), lr32(lrs)))
            return params, opt, None

        t._step, t._multi_step = step, multi
    else:
        t._run_group = lambda group: events.append((
            "group", [[_pad_ids(ids, t.batch_size)[0].tolist() for ids in ids_sc]
                      for _, ids_sc in group],
            lr32({g["name"]: g["lr"] for g in t.optimizer.param_groups})))
    log = t.train_metrics[0].log_and_reset
    t.train_metrics[0].log_and_reset = lambda it, epoch, batch: (
        events.append(("log", it, epoch, batch)), log(it=it, epoch=epoch, batch=batch))
    t._val_and_log = lambda it, epoch, batch: events.append(("val", it, epoch, batch))
    t.save = lambda epoch, batch: events.append(("save", epoch, batch))
    t._drain_losses = lambda: t._loss_buffer.clear()


@pytest.mark.parametrize("steps_per_call", [1, 2])
def test_loop_matches_jax_multi_scene(tmp_path, steps_per_call):
    """Two scenes of 8 views in batches of 3 (a ragged last batch), 4
    epochs with an LR milestone: the same per-scene view ids in the same
    groups at the same LRs, and the same log, val and save iterations."""
    from dbw_tpu.train.multi_scene import MultiSceneTrainer as JaxMultiSceneTrainer

    cfgs = _cfgs(steps_per_call=steps_per_call, train_stat_interval=3, val_stat_interval=5)
    runs = []
    for cls, kw in ((JaxMultiSceneTrainer, {}), (MultiSceneTrainer, {"device": "cpu"})):
        events = []
        root = tmp_path / cls.__module__
        t = cls(copy.deepcopy(cfgs), [root / "a", root / "b"], n_seeds=1, **kw)
        _record_scenes(t, events, jax_side=not kw)
        t.run()
        runs.append(events)
    jax_events, torch_events = runs
    assert torch_events == jax_events
    kinds = [e[0] for e in torch_events]
    assert kinds.count("val") >= 2 and kinds.count("log") >= 3
    groups = [e[1] for e in torch_events if e[0] == "group"]
    assert sum(len(g) for g in groups) == 4 * 3
    assert all(len(step) == 2 for g in groups for step in g)  # both scenes each step
    if steps_per_call == 2:
        assert {len(g) for g in groups} == {1, 2}


def test_unequal_view_counts_accounting(tmp_path):
    """Scenes of 3 and 4 views in batches of 2 (2 batches each, ragged
    tails of 1 and 2 real views): each scene counts its own real views, as
    the JAX package's accounting pins."""
    a, b = _scene_cfg("sA", 5, n_epoches=1, batch_size=2), _scene_cfg("sB", 9, n_epoches=1,
                                                                      batch_size=2)
    a["dataset"]["n_views"], b["dataset"]["n_views"] = 3, 4
    t = MultiSceneTrainer([a, b], [tmp_path / "a", tmp_path / "b"], device="cpu")
    _, _, losses = t.run()
    assert t.n_seen.tolist() == [3, 4]
    assert losses.shape == (2, 1) and np.isfinite(losses).all()


@pytest.mark.parametrize("what", ["model", "training", "batches"])
def test_mismatched_configs_raise(tmp_path, what):
    a, b = _cfgs()
    if what == "model":
        b["model"]["mesh"]["n_blocks"] = 3
    elif what == "training":
        b["training"]["batch_size"] = 2
    else:
        b["dataset"]["n_views"] = 16
    with pytest.raises(ValueError, match="identical"):
        MultiSceneTrainer([a, b], [tmp_path / "a", tmp_path / "b"], device="cpu")


def test_kill_and_resume_is_bitwise(tmp_path):
    """Killed right after its first save and resumed from
    multi_scene_model.pkl, every scene ends as in the uninterrupted run:
    losses, parameters and Adam state bit for bit, and the same TSVs."""
    cfgs = _cfgs(val_stat_interval=4)
    full = MultiSceneTrainer(copy.deepcopy(cfgs), [tmp_path / "u" / "a", tmp_path / "u" / "b"],
                             n_seeds=2, device="cpu")
    _, best0, losses0 = full.run()
    dirs = [tmp_path / "k" / "a", tmp_path / "k" / "b"]
    killed = MultiSceneTrainer(copy.deepcopy(cfgs), dirs, n_seeds=2, device="cpu")
    save = killed.save

    def save_and_die(epoch, batch):
        save(epoch, batch)
        raise KeyboardInterrupt("killed")

    killed.save = save_and_die
    with pytest.raises(KeyboardInterrupt):
        killed.run()
    state = ck.read_pickle(dirs[0] / MULTI_SCENE_CKPT)
    assert (state["epoch"], state["batch"], state["step_ctr"]) == (2, 2, 5)
    assert np.asarray(state["opt_state"].count).shape == (2, 2)
    resumed = MultiSceneTrainer(copy.deepcopy(cfgs), dirs, n_seeds=2, resume=True, device="cpu")
    assert (resumed.epoch_start, resumed.batch_start, resumed._step_ctr) == (2, 3, 5)
    _, best2, losses2 = resumed.run()
    np.testing.assert_array_equal(best2, best0)
    np.testing.assert_array_equal(losses2, losses0)
    for k, p in full.params.items():
        assert torch.equal(resumed.params[k], p), k
        a, b = full.optimizer.state[p], resumed.optimizer.state[resumed.params[k]]
        for f in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(a[f], b[f]), (k, f)
    for d in ("a", "b"):
        for name in ["train_metrics.tsv"] + [
                f"seed{s}/val_metrics.tsv" for s in full.scene_seeds["ab".index(d)]]:
            assert ((tmp_path / "k" / d / name).read_text()
                    == (tmp_path / "u" / d / name).read_text()), (d, name)
        assert (tmp_path / "k" / d / "model.pkl").exists()


def test_evaluate_writes_each_scene(tmp_path):
    cfgs = _cfgs(n_epoches=1)
    dirs = [tmp_path / "a", tmp_path / "b"]
    t = MultiSceneTrainer(copy.deepcopy(cfgs), dirs, device="cpu")
    t.run()
    scores = t.evaluate(quali=False)
    assert len(scores) == 2 and scores[0] != scores[1]
    for d in dirs:
        for f in ("train_metrics.tsv", "val_metrics.tsv", "model.pkl", "final_scores.tsv"):
            assert (d / f).exists(), (d, f)
        assert not (d / "quali_eval").exists()
    assert (dirs[0] / MULTI_SCENE_CKPT).exists() and not (dirs[1] / MULTI_SCENE_CKPT).exists()


def test_needs_a_card_unless_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MultiSceneTrainer(_cfgs(), [tmp_path / "a", tmp_path / "b"])
