"""The port's single-scene Trainer on the CPU: its loop against the JAX
Trainer's (the same batches, LRs and interval iterations, with the device
work stubbed on both sides), a tiny end-to-end run with every artifact,
and a kill/resume that replays the uninterrupted run bit for bit."""

import copy

import numpy as np
import pytest
import torch

from dbw_torch.train import trainer as trainer_mod
from dbw_torch.train.trainer import Trainer, step_seed

CFG = {
    "dataset": {"name": "synthetic", "tag": "t0", "img_size": [16, 20],
                "n_views": 8, "seed": 3},
    "model": {
        "name": "dbw",
        "mesh": dict(n_blocks=2, S_world=1.0, R_world=[0, 0, 0], txt_size=8,
                     T_range=[0.5, 0.5, 0.5], opacity_init=0.9),
        "renderer": dict(faces_per_pixel=2, detach_bary=True, z_clip=0.001),
        "rend_optim": dict(coarse_learning=3, decimate_txt=2, decimate_factor=4,
                           kill_blocks=True, decouple_rendering=True,
                           opacity_noise=True),
        "loss": dict(rgb_weight=1, parsimony_weight=0.01, tv_weight=0.1,
                     overlap_weight=1),
    },
    "training": {
        "batch_size": 3, "n_epoches": 4, "steps_per_call": 2,
        "optimizer": {"name": "adam", "lr": 5e-3, "texture": {"lr": 5e-2}},
        "scheduler": {"name": "multi_step", "gamma": [0.1, 0.1], "milestones": [2]},
        "train_stat_interval": 2, "val_stat_interval": 4,
        "eval": {"n_traj_videos": 1, "NV": 2, "n_views": 2},
        "seed": 123,
    },
}


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two torch threads: the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfg(**training):
    cfg = copy.deepcopy(CFG)
    cfg["training"].update(training)
    return cfg


def _record_loop(t, events):
    """Stub the device work of a Trainer (either package's) so that a run
    records its batches, epochs, LRs and interval actions only."""
    def lrs():  # float32, as the JAX side holds them
        return {k: float(np.float32(v)) for k, v in t._epoch_consts()[1].items()}

    t.run_single_batch_train = lambda ids: events.append(
        ("step", t.cur_epoch, [int(i) for i in ids], lrs()))
    t.run_scanned_batches = lambda ids_list: events.append(
        ("group", t.cur_epoch, [[int(i) for i in ids] for ids in ids_list], lrs()))
    t.log_train_metrics = lambda it, epoch, batch: events.append(("log", it, epoch, batch))
    t.run_val_and_log = lambda it, epoch, batch: events.append(("val", it, epoch, batch))
    t.log_visualizations = lambda it: events.append(("viz", it))
    t.save = lambda epoch, batch, checkpoint=False: events.append(
        ("save", epoch, batch, checkpoint))
    t._drain_losses = lambda: None
    t.save_metric_plots = lambda: events.append(("plots",))
    t.evaluate = lambda: events.append(("eval",))


@pytest.mark.parametrize("steps_per_call", [1, 2])
def test_loop_matches_jax_trainer(tmp_path, steps_per_call):
    """8 views in batches of 3 (a ragged last batch), 4 epochs with an LR
    milestone, save_epoches: both Trainers take the same view ids in the
    same groups, at the same LRs, and log, validate, render and save at the
    same iterations."""
    from dbw_tpu.train.trainer import Trainer as JaxTrainer

    cfg = _cfg(steps_per_call=steps_per_call, save_epoches=[3], train_stat_interval=3,
               val_stat_interval=5)
    runs = []
    for cls, kw in ((JaxTrainer, {}), (Trainer, {"device": "cpu"})):
        events = []
        t = cls(copy.deepcopy(cfg), tmp_path / cls.__module__, seed=123, **kw)
        _record_loop(t, events)
        t.run(seed=123)
        runs.append(events)
    jax_events, torch_events = runs
    assert torch_events == jax_events
    kinds = [e[0] for e in torch_events]
    assert kinds.count("val") >= 2 and kinds.count("log") >= 3
    assert ("save", 3, 3, True) in torch_events
    if steps_per_call == 2:
        assert "group" in kinds and "step" in kinds  # full groups and ragged tails


def _cursor_schedule(epoch, start, n_batches, size, log_every, val_every):
    """The schedule as the JAX trainers write it (a running iteration
    cursor, the groups flushed when full and at the epoch's end) ->
    [(batches, last iteration, do_log, do_val)]."""
    cur, out, pending = (epoch - 1) * n_batches + start, [], []

    def flush():
        nonlocal cur
        do_log = do_val = False
        for _ in pending:
            do_log |= bool(log_every) and cur % log_every == 0
            do_val |= bool(val_every) and cur % val_every == 0
            cur += 1
        out.append((list(pending), cur - 1, do_log, do_val))

    for b in range(start, n_batches + 1):
        pending.append(b)
        if len(pending) == size:
            flush()
            pending = []
    if pending:
        flush()
    return out


@pytest.mark.parametrize("size,batch_start,epoch,log_every,val_every", [
    (1, 1, 1, 3, 5), (2, 1, 2, 3, 5), (3, 2, 1, 2, 4), (2, 4, 3, 3, 5), (4, 1, 2, 0, 3)])
def test_epoch_groups_is_the_jax_schedule(size, batch_start, epoch, log_every, val_every):
    """The one schedule of the three trainers (``epoch_groups``) against
    the JAX trainers' cursor loop: 7 batches, the resume's batch_start in
    the first epoch only, full groups and a ragged tail, the log and val
    intervals each group crosses (an interval of 0: none)."""
    from types import SimpleNamespace

    from dbw_torch.train.trainer import epoch_groups

    t = SimpleNamespace(epoch_start=1, batch_start=batch_start, n_batches=7,
                        steps_per_call=size, train_stat_interval=log_every,
                        val_stat_interval=val_every)
    got = [([b for b, _ in g], it, do_log, do_val)
           for g, it, do_log, do_val in epoch_groups(t, epoch, iter("abcdefg"))]
    start = batch_start if epoch == 1 else 1
    assert got == _cursor_schedule(epoch, start, 7, size, log_every, val_every)
    assert [b for g, *_ in got for b in g] == list(range(start, 8))


def _quali_files(n_views=2):
    names = ["mesh.obj", "mesh.mtl", "mesh.png", "mesh_full.obj", "gt.ply",
             "index.html", "textures/bkg.png", "textures/ground.png",
             "textures/block_00.png", "textures/block_01.png"]
    for i in range(n_views):
        names += [f"{i}_{s}.png" for s in ("inp", "rec", "rec_col", "rec_col_inp",
                                           "rec_syn_nobkg", "rec_syn_nobkg_edged")]
    return names


def test_end_to_end_run_writes_every_artifact(tmp_path):
    """A tiny run: the losses fall, every artifact of the JAX Trainer's
    synthetic run is written (videos as GIFs without ffmpeg), model.pkl
    loads in the JAX package, and a resume from it starts at the next
    epoch."""
    from dbw_tpu.train.checkpoint import load_checkpoint as jax_load_checkpoint

    run = tmp_path / "run"
    t = Trainer(_cfg(), run, device="cpu", seed=123)
    t.run(seed=123)

    log = t.train_metrics.read_log()
    assert len(log["iteration"]) >= 3
    assert log["loss_total"][-1] < log["loss_total"][0]
    assert np.isfinite(np.stack([log[k] for k in log])).all()
    header = (run / "train_metrics.tsv").read_text().splitlines()[0].split("\t")
    assert header == ["iteration", "epoch", "batch", "time/img", "loss_rgb",
                      "loss_parsimony", "loss_tv", "loss_overlap", "loss_total"]
    val = t.val_metrics.read_log()
    assert list(val) == ["iteration", "epoch", "batch", "alpha0", "alpha1"]

    scores = (run / "final_scores.tsv").read_text().splitlines()
    assert scores[0].split("\t") == ["n_blocks", "L_tot", "L_rec", "PSNR", "SSIM",
                                     "LPIPS_randvgg", "alpha0", "alpha1"]
    vals = [float(v) for v in scores[1].split("\t")]
    assert np.isfinite(vals).all() and vals[0] >= 1
    quali = run / "quali_eval"
    for name in _quali_files():
        assert (quali / name).exists(), name
    for stem in ("rotated_mesh", "0_rec_traj", "0_rec_traj_syn"):
        assert any(quali.glob(stem + ".*")), stem
    assert not any(quali.glob("1_rec_traj.*"))  # n_traj_videos: 1
    for stream in ("reconstructions", "reconstructions_hard", "reconstructions_syn"):
        for k in range(2):
            d = run / stream / f"img{k}"
            assert (d / "input.png").exists() and (d / "final.png").exists()
            assert any(d.glob("evolution.*")), (stream, k)
    assert (run / "txt_blocks" / "img0" / "final.png").exists()

    state = jax_load_checkpoint(run / "model.pkl")
    assert (state["epoch"], state["batch"]) == (4, 3)
    assert int(np.asarray(state["optimizer_state"].count)) == 12
    np.testing.assert_array_equal(np.asarray(state["model_state"].T),
                                  t.params["T"].detach().numpy())

    t2 = Trainer(_cfg(resume=str(run / "model.pkl"), n_epoches=5), run,
                 device="cpu", seed=123)
    assert (t2.epoch_start, t2.batch_start, t2._step_ctr) == (5, 1, 12)
    assert t2.optimizer.state[t2.params["T"]]["step"] == 12


def _quiet(t):
    """No viz, plots or final eval: the kill/resume test checks the
    optimization's state only."""
    t.log_visualizations = lambda it: None
    t.save_metric_plots = lambda: None
    t.evaluate = lambda: None
    return t


def test_kill_and_resume_replays_the_run(tmp_path):
    """A run killed after its checkpoint and resumed from model.pkl ends
    with the parameters and Adam state of the uninterrupted run, bit for
    bit; the resumed TSV drops the killed run's rows past the checkpoint."""
    cfg = _cfg(val_stat_interval=4)
    full = _quiet(Trainer(copy.deepcopy(cfg), tmp_path / "full", device="cpu", seed=123))
    full.run(seed=123)

    killed = _quiet(Trainer(copy.deepcopy(cfg), tmp_path / "killed", device="cpu", seed=123))
    step = killed._train_step

    def dying_step(ids):
        if killed._step_ctr == 7:  # past the checkpoint of iteration 5
            raise KeyboardInterrupt("killed")
        step(ids)

    killed._train_step = dying_step
    with pytest.raises(KeyboardInterrupt):
        killed.run(seed=123)
    from dbw_torch.train.checkpoint import load_checkpoint

    state = load_checkpoint(tmp_path / "killed" / "model.pkl")
    assert (state["epoch"], state["batch"]) == (2, 2)

    resumed = _quiet(Trainer(_cfg(val_stat_interval=4, resume=str(tmp_path / "killed" / "model.pkl")),
                             tmp_path / "killed", device="cpu", seed=123))
    assert (resumed.epoch_start, resumed.batch_start, resumed._step_ctr) == (2, 3, 5)
    resumed.run(seed=123)
    for k, p in full.params.items():
        assert torch.equal(resumed.params[k], p), k
        a, b = full.optimizer.state[p], resumed.optimizer.state[resumed.params[k]]
        for f in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(a[f], b[f]), (k, f)
    its = resumed.train_metrics.read_log()["iteration"]
    np.testing.assert_array_equal(its, full.train_metrics.read_log()["iteration"])


def test_step_seeds_differ_per_step_and_seed():
    seeds = {step_seed(s, c) for s in (0, 1) for c in range(50)}
    assert len(seeds) == 100 and all(0 <= s < 2**63 for s in seeds)
    assert step_seed(5, 7) == step_seed(5, 7)


def test_cli_needs_a_card_unless_cpu(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trainer_mod.main(["-t", "x", "-c", "synthetic/tiny.yml"])
