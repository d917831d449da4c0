"""The port's multi-seed protocol on the CPU: the seed helpers and the
stacked step against the JAX package's, each slot against the port
Trainer with that seed (bit for bit under the map executor, within
BATCHED_LOSS_RTOL and BATCHED_PARAM_ATOL under the default batched one),
the loop against the JAX MultiSeedTrainer's (the device work stubbed on
both sides), selection and dead seeds, a bitwise kill/resume,
``multi_model.pkl`` read by each package from the other, the run
directory, and the eval arguments the protocol passes (``quali``,
``lpips``, ``label``, ``hard_inference``).

The JAX trainer sees the 8 virtual CPU devices of tests/conftest.py and
takes its mesh path, which may pad the seed slots; only the valid slots
are compared. Tolerances of the stacked step: loss rtol 2e-5, parameters
atol 3e-4 after 3 Adam steps (ROADMAP.md), but for the ground texture of
seed 7: after these 3 steps the JAX package's own jit and eager runs of
seed 7 differ by 4.6e-4 on that leaf (a few small-gradient texels whose
Adam updates amplify the float noise), so it is held to 5e-4, and the
port lands 4.6e-4 from the jit run; the single-seed port step lands there
too, so the stacking adds nothing."""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dbw_torch.parallel import seeds as tseeds
from dbw_torch.train import checkpoint as ck
from dbw_torch.train.multi_seed import MULTI_CKPT, MultiSeedTrainer, write_seed_selection
from dbw_torch.train.trainer import Trainer, _pad_ids
from test_torch_trainer import CFG

SEEDS = [123, 7]
LOSS_RTOL = 2e-5
PARAM_ATOL = 3e-4
# the JAX package's own jit-vs-eager gap on the ground texture of seed 7
# after 3 steps is 4.6e-4 (see the module docstring)
GROUND_TXT_ATOL = 5e-4
# the batched protocol's slots against the Trainer over the whole tiny run
# (12 steps; measured 1.5e-6 and 3.6e-7)
BATCHED_LOSS_RTOL = 1e-5
BATCHED_PARAM_ATOL = 1e-5


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


def _quiet(t):
    """No evolution stream: the optimization's state only."""
    t.viz = False
    return t


def _arrays(seed, shapes=((2, 3), (4,), (1, 2, 2))):
    rng = np.random.default_rng(seed)
    return {f"a{i}": rng.standard_normal(s).astype(np.float32) for i, s in enumerate(shapes)}


# ---------------------------------------------------------------------------
# the seed helpers


@pytest.mark.parametrize("n", [1, 2, 5])
def test_stack_unstack_match_jax(n):
    from dbw_tpu.parallel.seeds import stack_params as jstack
    from dbw_tpu.parallel.seeds import unstack_params as junstack

    plist = [_arrays(s) for s in range(n)]
    ref = jstack(plist)
    got = tseeds.stack_params([{k: torch.from_numpy(v) for k, v in p.items()} for p in plist])
    for k in ref:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))
    for i in range(n):
        r, g = junstack(ref, i), tseeds.unstack_params(got, i)
        for k in r:
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(r[k]))


@pytest.mark.parametrize("seeds,n_slots", [([11], 1), ([11, 22], 8), ([11, 22, 33, 44, 55], 8),
                                           ([5, 6, 7], 3)])
def test_pad_seeds_matches_jax(seeds, n_slots):
    from dbw_tpu.parallel.seeds import pad_seeds as jpad

    assert tseeds.pad_seeds(seeds, n_slots) == jpad(seeds, n_slots)


@pytest.mark.parametrize("losses,n_valid", [
    ([0.3, 0.1, 0.2], None), ([0.3, 0.2, 0.1], 2), ([0.1, 0.1, 0.2], None),
    ([np.inf, 0.5, 0.4, 0.1], 3), ([0.2, 0.2, 0.2, 0.2], 1)])
def test_select_best_seed_matches_jax(losses, n_valid):
    from dbw_tpu.parallel.seeds import select_best_seed as jselect
    from dbw_tpu.parallel.seeds import stack_params as jstack

    plist = [_arrays(s) for s in range(len(losses))]
    ref_p, ref_best = jselect(jstack(plist), losses, n_valid)
    got_p, got_best = tseeds.select_best_seed(
        tseeds.stack_params([{k: torch.from_numpy(v) for k, v in p.items()} for p in plist]),
        losses, n_valid)
    assert got_best == ref_best
    for k in ref_p:
        np.testing.assert_array_equal(got_p[k].numpy(), np.asarray(ref_p[k]))


def test_seed_axis_exec_runs_slots_in_order(monkeypatch):
    """The map executor: one call a slot, in slot order."""
    monkeypatch.setenv("DBW_SEED_EXEC", "map")
    calls = []

    def fn(p, g):
        calls.append(g)
        return p["a"].sum() * g

    x = {"a": torch.arange(6.0).reshape(3, 2)}
    out = tseeds.seed_axis_exec(fn, x, [1.0, 2.0, 3.0])
    assert calls == [1.0, 2.0, 3.0]
    torch.testing.assert_close(out, torch.tensor([1.0, 10.0, 27.0]))


# ---------------------------------------------------------------------------
# the stacked step against JAX's per-seed step


def test_stacked_step_matches_jax():
    """2 seeds, 3 Adam steps of the decoupled model (full loss stack,
    random VGG): the port's stacked step against JAX's per-seed step
    (forward, jax.grad, optimizer.update) through ``seed_axis_exec``, with
    each seed's opacity noise and overlap points drawn by JAX."""
    from dbw_tpu.models.dbw import BlocksWorld as JaxBlocksWorld
    from dbw_tpu.ops.rotations import look_at_rotation as jax_look_at
    from dbw_tpu.parallel.seeds import seed_axis_exec as jexec
    from dbw_tpu.parallel.seeds import stack_params as jstack
    from dbw_tpu.train.optimizer import create_optimizer as jax_create_optimizer
    from dbw_torch.models.dbw import BlocksWorld
    from dbw_torch.train.optimizer import create_optimizer
    from test_torch_step import B, DEC_CFG, H, K_NDC, TRAIN_CFG, W, _draws

    jm = JaxBlocksWorld((H, W), backend="xla", **copy.deepcopy(DEC_CFG))
    jm.set_camera(K_NDC)
    tm = BlocksWorld((H, W), device="cpu", **copy.deepcopy(DEC_CFG))
    tm.set_camera(K_NDC)
    R, T = jax_look_at(3.0, 25.0, jnp.linspace(-40.0, 40.0, B))
    imgs = np.random.default_rng(0).random((B, H, W, 3), np.float32)
    plist = [jm.init_params(seed=s) for s in SEEDS]
    jopt = jax_create_optimizer(TRAIN_CFG, plist[0])
    jp, jo = jstack(plist), jstack([jopt.init(p) for p in plist])
    lrs = {"main": jnp.float32(5e-3), "texture": jnp.float32(5e-2)}
    phase = jm.phase_for_epoch(0)

    @jax.jit
    def jstep(params_S, opt_S, keys):
        def one(p, o, k):
            def lf(pp):
                losses = jm.forward(pp, phase, jnp.asarray(imgs), R, T, k)
                return losses["total"], losses
            grads, losses = jax.grad(lf, has_aux=True)(p)
            updates, o = jopt.update(grads, o, lrs)
            return jax.tree_util.tree_map(lambda a, u: a + u, p, updates), o, losses["total"]
        return jexec(one, params_S, opt_S, keys)

    tp = tseeds.stacked_leaves([tm.init_params(seed=s) for s in SEEDS])
    topt = create_optimizer(TRAIN_CFG, tp)
    Rt, Tt, it = (torch.tensor(np.asarray(R)), torch.tensor(np.asarray(T)),
                  torch.from_numpy(imgs))
    tphase = tm.phase_for_epoch(0)
    for step in range(3):
        keys = jnp.stack([jax.random.fold_in(jax.random.PRNGKey(s), step) for s in SEEDS])
        jp, jo, jl = jstep(jp, jo, keys)
        draws = dict(zip(("opacity_noise", "overlap_u"),
                         map(torch.stack, zip(*[_draws(tm, keys[i]) for i in range(len(SEEDS))]))))
        tl = tseeds.train_step(tm, topt, tp, tphase, (it, Rt, Tt), draws=draws)["total"]
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=LOSS_RTOL)
    for k in jp._fields:
        got, ref = tp[k].detach().numpy(), np.asarray(getattr(jp, k))
        for i, s in enumerate(SEEDS):
            atol = GROUND_TXT_ATOL if (k, s) == ("texture_ground", 7) else PARAM_ATOL
            np.testing.assert_allclose(got[i], ref[i], atol=atol, err_msg=(k, s))
    assert int(topt.state[tp["T"]]["step"]) == int(np.asarray(jo.count)[0]) == 3


# ---------------------------------------------------------------------------
# slot s against the port Trainer with seed s


def _record(t, out, pick):
    step = t._train_step

    def wrapper(*a, **kw):
        step(*a, **kw)
        out.append(pick(t))
    t._train_step = wrapper


@pytest.fixture(scope="module")
def slot_runs(tmp_path_factory):
    """A 2-seed protocol under the map executor (each slot's step is the
    Trainer's own code) and the Trainer with each seed, with their
    per-step losses."""
    tmp = tmp_path_factory.mktemp("slots")
    ms = _quiet(MultiSeedTrainer(_cfg(), tmp / "protocol", SEEDS, device="cpu"))
    ms_losses = []
    _record(ms, ms_losses, lambda t: t._loss_buffer[-1][0].clone())
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DBW_SEED_EXEC", "map")
        ms.run()
    trainers = []
    for s in SEEDS:
        t = Trainer(_cfg(seed=s), tmp / f"trainer{s}", device="cpu", seed=s)
        t.log_visualizations = lambda it: None
        t.save_metric_plots = lambda: None
        t.evaluate = lambda: None
        losses = []
        total = t._loss_keys.index("total")
        _record(t, losses, lambda t: t._loss_buffer[-1][0][total].clone())
        t.run(seed=s)
        trainers.append((t, torch.stack(losses)))
    return tmp, ms, torch.stack(ms_losses), trainers


@pytest.mark.parametrize("slot", [0, 1])
def test_slot_equals_trainer_bitwise(slot_runs, slot):
    """Slot s of the protocol is the Trainer's run with training.seed = s:
    every step's loss, the TSV's losses and the final parameters and Adam
    moments, bit for bit."""
    tmp, ms, ms_losses, trainers = slot_runs
    t, losses = trainers[slot]
    s = SEEDS[slot]
    assert torch.equal(ms_losses[:, slot], losses)
    for k, p in t.params.items():
        assert torch.equal(ms.params[k][slot], p), k
        a, b = ms.optimizer.state[ms.params[k]], t.optimizer.state[p]
        assert torch.equal(a["step"], b["step"])
        for f in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(a[f][slot], b[f]), (k, f)
    mine = ms.train_metrics.read_log()
    ref = t.train_metrics.read_log()
    np.testing.assert_array_equal(mine["iteration"], ref["iteration"])
    np.testing.assert_array_equal(mine[f"loss_s{s}"], ref["loss_total"])


def test_batched_slots_match_trainers(slot_runs, tmp_path):
    """Under the default (batched) executor slot s follows the Trainer's
    run with training.seed = s, every slot in one forward: each step's
    loss within rtol BATCHED_LOSS_RTOL, the final parameters within
    BATCHED_PARAM_ATOL (the batched forward's values are each slot's bit
    for bit; its backward rounds a few sums otherwise, which Adam carries
    on over the run's steps)."""
    _, ms_map, map_losses, trainers = slot_runs
    ms = _quiet(MultiSeedTrainer(_cfg(), tmp_path / "protocol", SEEDS, device="cpu"))
    losses = []
    _record(ms, losses, lambda t: t._loss_buffer[-1][0].clone())
    ms.run()
    losses = torch.stack(losses)
    assert losses.shape == map_losses.shape
    for i, (t, tl) in enumerate(trainers):
        np.testing.assert_allclose(losses[:, i].numpy(), tl.numpy(), rtol=BATCHED_LOSS_RTOL)
        for k, p in t.params.items():
            np.testing.assert_allclose(ms.params[k][i].detach().numpy(),
                                       p.detach().numpy(), atol=BATCHED_PARAM_ATOL,
                                       err_msg=(i, k))


def test_protocol_checkpoints_load_as_trainer_checkpoints(slot_runs):
    """seed{s}/model.pkl is the slot's model.pkl: it resumes a Trainer
    with the slot's parameters and Adam state."""
    tmp, ms, _, trainers = slot_runs
    for slot, s in enumerate(SEEDS):
        state = ck.load_checkpoint(tmp / "protocol" / f"seed{s}" / "model.pkl")
        ref = ck.load_checkpoint(tmp / f"trainer{s}" / "model.pkl")
        assert (state["epoch"], state["batch"]) == (ref["epoch"], ref["batch"])
        for k, v in ref["model_state"].items():
            np.testing.assert_array_equal(state["model_state"][k], v)
        for f in ("mu", "nu"):
            for k in ref["model_state"]:
                np.testing.assert_array_equal(getattr(getattr(state["optimizer_state"], f), k),
                                              getattr(getattr(ref["optimizer_state"], f), k))
        assert int(state["optimizer_state"].count) == int(ref["optimizer_state"].count)
    best = ck.load_checkpoint(tmp / "protocol" / "model.pkl")
    np.testing.assert_array_equal(best["model_state"]["T"],
                                  ms.params["T"][ms.best].detach().numpy())


# ---------------------------------------------------------------------------
# the loop against the JAX MultiSeedTrainer


def _record_protocol(t, events, jax_side):
    """Stub the device work of a MultiSeedTrainer (either package's) so that
    a run records its groups (padded view ids, LRs) and interval actions."""
    lr32 = lambda lrs: {k: float(np.float32(v)) for k, v in lrs.items()}
    if jax_side:
        def step(params, opt, imgs, R, T, idx, phase, lrs, keys):
            events.append(("group", [np.asarray(idx).tolist()], lr32(lrs)))
            return params, opt, None

        def multi(params, opt, imgs, R, T, idx_s, phase, lrs, keys_s):
            events.append(("group", np.asarray(idx_s).tolist(), lr32(lrs)))
            return params, opt, None

        t._step, t._multi_step = step, multi
    else:
        t._run_group = lambda group: events.append((
            "group", [_pad_ids(ids, t.batch_size)[0].tolist() for _, ids in group],
            lr32({g["name"]: g["lr"] for g in t.optimizer.param_groups})))
    t._log_train = lambda it, epoch, batch: events.append(("log", it, epoch, batch))
    t._val_and_log = lambda it, epoch, batch: events.append(("val", it, epoch, batch))
    t.save = lambda epoch, batch: events.append(("save", epoch, batch))
    t._drain_losses = lambda: t._loss_buffer.clear()


@pytest.mark.parametrize("steps_per_call", [1, 2])
def test_loop_matches_jax_protocol(tmp_path, steps_per_call):
    """8 views in batches of 3 (a ragged last batch), 4 epochs with an LR
    milestone: both protocols take the same view ids in the same groups at
    the same LRs, and log, validate and save at the same iterations."""
    from dbw_tpu.train.multi_seed import MultiSeedTrainer as JaxMultiSeedTrainer

    cfg = _cfg(steps_per_call=steps_per_call, train_stat_interval=3, val_stat_interval=5)
    runs = []
    for cls, kw in ((JaxMultiSeedTrainer, {}), (MultiSeedTrainer, {"device": "cpu"})):
        events = []
        t = cls(copy.deepcopy(cfg), tmp_path / cls.__module__, SEEDS, **kw)
        _record_protocol(t, events, jax_side=not kw)
        t.run()
        runs.append(events)
    jax_events, torch_events = runs
    assert torch_events == jax_events
    kinds = [e[0] for e in torch_events]
    assert kinds.count("val") >= 2 and kinds.count("log") >= 3
    assert ("save", 4, 3) in torch_events  # the final save
    groups = [e[1] for e in torch_events if e[0] == "group"]
    assert sum(len(g) for g in groups) == 4 * 3
    assert any(len(set(ids)) < 3 for g in groups for ids in g)  # a padded tail
    if steps_per_call == 2:
        assert {len(g) for g in groups} == {1, 2}


# ---------------------------------------------------------------------------
# selection and dead seeds


def test_dead_seed_is_excluded(tmp_path):
    cfg = _cfg(n_epoches=1, val_stat_interval=1)
    t = _quiet(MultiSeedTrainer(cfg, tmp_path, SEEDS, device="cpu"))
    with torch.no_grad():
        t.params["alpha_logit"][0] = -20.0
    _, best_seed, losses = t.run()
    assert t.dead.tolist() == [True, False]
    assert best_seed == SEEDS[1] and len(losses) == 2
    rows = (tmp_path / "seed_selection.tsv").read_text().splitlines()
    assert rows[0] == "seed\tfinal_train_loss\tdead\tselected"
    assert [r.split("\t")[2:] for r in rows[1:]] == [["1", "0"], ["0", "1"]]


def test_all_seeds_dead_raises(tmp_path):
    t = _quiet(MultiSeedTrainer(_cfg(n_epoches=1, val_stat_interval=1), tmp_path, SEEDS,
                                device="cpu"))
    with torch.no_grad():
        t.params["alpha_logit"].fill_(-20.0)
    with pytest.raises(RuntimeError, match="No more blocks"):
        t.run()


@pytest.fixture(scope="module")
def jax_selector(tmp_path_factory):
    """A JAX MultiSeedTrainer that runs no epoch: its run() only selects
    and writes seed_selection.tsv from the losses and flags it is given."""
    from dbw_tpu.train.multi_seed import MultiSeedTrainer as JaxMultiSeedTrainer

    j = JaxMultiSeedTrainer(_cfg(n_epoches=1), tmp_path_factory.mktemp("jax_sel"), SEEDS)
    j.epoch_start = 2  # past the last epoch
    j.save = lambda epoch, batch: None
    j.viz = False
    return j


@pytest.mark.parametrize("losses,dead", [([0.0123456, 0.0098765], [False, False]),
                                         ([0.002, 0.001], [False, True]),
                                         ([0.5, 0.25], [True, False])])
def test_seed_selection_tsv_equals_jax(tmp_path, jax_selector, losses, dead):
    """seed_selection.tsv byte for byte as the JAX protocol writes it for
    the same final losses and dead flags."""
    j = jax_selector
    n = len(j.seeds)
    j.loss_sums = np.resize(np.asarray(losses) * 3.0, n)
    j.n_seen = 3
    j.dead = np.zeros(n, bool)
    j.dead[:2] = dead
    _, best_seed, _ = j.run()
    final = np.asarray(losses, np.float64) * 3.0 / 3
    best = int(np.argmin(np.where(np.asarray(dead), np.inf, final)))
    assert best_seed == SEEDS[best]
    write_seed_selection(tmp_path / "port.tsv", SEEDS, final, np.asarray(dead), best)
    assert (tmp_path / "port.tsv").read_bytes() == (j.run_dir / "seed_selection.tsv").read_bytes()


# ---------------------------------------------------------------------------
# kill and resume


def test_kill_and_resume_is_bitwise(tmp_path):
    """Killed right after its first save and resumed from multi_model.pkl,
    the protocol ends with the uninterrupted run's per-seed losses,
    parameters and Adam state, bit for bit, and its TSVs' rows."""
    cfg = _cfg(val_stat_interval=4)
    full = _quiet(MultiSeedTrainer(copy.deepcopy(cfg), tmp_path / "full", SEEDS, device="cpu"))
    _, best0, losses0 = full.run()

    killed = _quiet(MultiSeedTrainer(copy.deepcopy(cfg), tmp_path / "k", SEEDS, device="cpu"))
    save = killed.save

    def save_and_die(epoch, batch):
        save(epoch, batch)
        raise KeyboardInterrupt("killed")

    killed.save = save_and_die
    with pytest.raises(KeyboardInterrupt):
        killed.run()
    state = ck.read_pickle(tmp_path / "k" / MULTI_CKPT)
    assert (state["epoch"], state["batch"], state["step_ctr"]) == (2, 2, 5)

    resumed = _quiet(MultiSeedTrainer(copy.deepcopy(cfg), tmp_path / "k", resume=True,
                                      device="cpu"))
    assert (resumed.epoch_start, resumed.batch_start, resumed._step_ctr) == (2, 3, 5)
    assert resumed.seeds == SEEDS
    _, best2, losses2 = resumed.run()
    assert best2 == best0
    np.testing.assert_array_equal(losses2, losses0)
    for k, p in full.params.items():
        assert torch.equal(resumed.params[k], p), k
        a, b = full.optimizer.state[p], resumed.optimizer.state[resumed.params[k]]
        for f in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(a[f], b[f]), (k, f)
    for name in ["train_metrics.tsv"] + [f"seed{s}/val_metrics.tsv" for s in SEEDS]:
        assert (tmp_path / "k" / name).read_text() == (tmp_path / "full" / name).read_text()


# ---------------------------------------------------------------------------
# multi_model.pkl both ways


def _jax_state(t):
    """The JAX trainer's restored state as numpy."""
    return ({k: np.asarray(v) for k, v in t.params._asdict().items()},
            (np.asarray(t.opt_state.count),
             {k: np.asarray(v) for k, v in t.opt_state.mu._asdict().items()},
             {k: np.asarray(v) for k, v in t.opt_state.nu._asdict().items()}))


def _torch_state(t):
    st = [t.optimizer.state[t.params[k]] for k in t.params]
    return ({k: v.detach().numpy() for k, v in t.params.items()},
            (np.full(len(t.seeds), int(st[0]["step"]), np.int32),
             {k: t.optimizer.state[v]["exp_avg"].numpy() for k, v in t.params.items()},
             {k: t.optimizer.state[v]["exp_avg_sq"].numpy() for k, v in t.params.items()}))


def _same_state(a, b):
    (pa, (ca, ma, na)), (pb, (cb, mb, nb)) = a, b
    np.testing.assert_array_equal(ca, cb)
    for k in pa:
        np.testing.assert_array_equal(pa[k], pb[k], err_msg=k)
        np.testing.assert_array_equal(ma[k], mb[k], err_msg=k)
        np.testing.assert_array_equal(na[k], nb[k], err_msg=k)


def _same_books(a, b):
    assert (a.epoch_start, a.batch_start) == (b.epoch_start, b.batch_start)
    np.testing.assert_array_equal(a.dead[: a.n_valid], b.dead[: b.n_valid])
    np.testing.assert_array_equal(a.loss_sums[: a.n_valid], b.loss_sums[: b.n_valid])
    assert int(a.n_seen) == int(b.n_seen)


def test_port_multi_model_restores_in_jax(tmp_path):
    """batch_size 4: the JAX trainer's 8-device mesh holds 2 seeds in 2
    slots, as the port does, so each restores the other's file."""
    from dbw_tpu.train.multi_seed import MultiSeedTrainer as JaxMultiSeedTrainer

    cfg = _cfg(batch_size=4, n_epoches=2, val_stat_interval=3, steps_per_call=1)
    t = _quiet(MultiSeedTrainer(copy.deepcopy(cfg), tmp_path, SEEDS, device="cpu"))
    save = t.save
    t.save = lambda epoch, batch: (save(epoch, batch), t._host.join(),
                                   setattr(t, "saved", _torch_state(t)),
                                   setattr(t, "books", (t.dead.copy(), t.loss_sums.copy(),
                                                        t.n_seen)))
    t.dead[1] = True  # carried as bookkeeping only
    t.run()
    j = JaxMultiSeedTrainer(copy.deepcopy(cfg), tmp_path, None, resume=True)
    assert j.seeds == SEEDS and j.n_valid == 2
    _same_state(_jax_state(j), t.saved)
    assert (j.epoch_start, j.batch_start) == (3, 1)
    dead, sums, seen = t.books
    np.testing.assert_array_equal(j.dead, dead)
    np.testing.assert_array_equal(j.loss_sums, sums)
    assert j.n_seen == seen


def test_jax_multi_model_restores_in_port(tmp_path):
    from dbw_tpu.train.multi_seed import MultiSeedTrainer as JaxMultiSeedTrainer

    cfg = _cfg(batch_size=4, n_epoches=2)
    j = JaxMultiSeedTrainer(copy.deepcopy(cfg), tmp_path, SEEDS)
    assert j.seeds == SEEDS
    j.params = jax.tree_util.tree_map(lambda a: a * 1.5 + 0.25, j.params)
    j.opt_state = j.opt_state._replace(
        count=j.opt_state.count + 4,
        mu=jax.tree_util.tree_map(lambda a: a + 0.5, j.opt_state.mu),
        nu=jax.tree_util.tree_map(lambda a: a + 2.0, j.opt_state.nu))
    j.dead = np.array([False, True])
    j.loss_sums = np.array([0.125, 0.375])
    j.n_seen = 6
    j.save(1, 1)
    j._host.join()
    t = MultiSeedTrainer(copy.deepcopy(cfg), tmp_path, resume=True, device="cpu")
    assert t.seeds == SEEDS and t._step_ctr == 1
    _same_state(_torch_state(t), _jax_state(j))
    j.epoch_start, j.batch_start = 1, 2
    _same_books(t, j)


# ---------------------------------------------------------------------------
# the run directory and the eval arguments


def _tree(d):
    return sorted(str(p.relative_to(d)) for p in d.rglob("*") if p.is_file()
                  and "evolution" not in p.parts)


@pytest.mark.parametrize("per_seed_full", [False, True])
def test_output_surface(tmp_path, per_seed_full):
    cfg = _cfg(n_epoches=2)
    t = MultiSeedTrainer(cfg, tmp_path, SEEDS, device="cpu")
    t.run()
    results = t.evaluate(per_seed_full=per_seed_full,
                         quali_kwargs=dict(NV=2, n_views=1, render_videos=False))
    assert set(results) == set(SEEDS) | {"best"}
    files = _tree(tmp_path)
    for f in ("train_metrics.tsv", "seed_selection.tsv", MULTI_CKPT, "model.pkl",
              "final_scores.tsv", "quali_eval/mesh.obj", "quali_eval/index.html",
              "quali_eval/textures/bkg.png", "quali_eval/textures/block_01.png",
              "reconstructions_best/img0/input.png"):
        assert f in files, f
    assert any(p.name.startswith("evolution.")
               for p in (tmp_path / "reconstructions_best" / "img0").iterdir())
    for s in SEEDS:
        for f in ("model.pkl", "val_metrics.tsv", "final_scores.tsv"):
            assert f"seed{s}/{f}" in files
        assert (tmp_path / f"seed{s}" / "quali_eval").exists() == per_seed_full
    header = (tmp_path / "final_scores.tsv").read_text().splitlines()[0].split("\t")
    assert header[:6] == ["n_blocks", "L_tot", "L_rec", "PSNR", "SSIM", "LPIPS_randvgg"]
    best = SEEDS[t.best]
    assert ((tmp_path / "final_scores.tsv").read_text()
            == (tmp_path / f"seed{best}" / "final_scores.tsv").read_text())


def test_one_card_only():
    with pytest.raises(ValueError, match="only 1 device"):
        MultiSeedTrainer(_cfg(), "unused", SEEDS, n_data=2, device="cpu")
    with pytest.raises(ValueError, match="only 1 device"):
        MultiSeedTrainer(_cfg(), "unused", SEEDS, n_spatial=2, device="cpu")
    with pytest.raises(ValueError, match=">= 1"):
        MultiSeedTrainer(_cfg(), "unused", SEEDS, n_data=0, device="cpu")


def test_needs_a_card_unless_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MultiSeedTrainer(_cfg(), tmp_path, SEEDS)


@pytest.fixture(scope="module")
def eval_case():
    """Both packages' models on the same parameters, a ragged 5-view loader."""
    from dbw_tpu.data.base import Loader as JaxLoader
    from dbw_tpu.data.base import MultiViewDataset as JaxDataset
    from dbw_tpu.models.dbw import SceneParams
    from test_torch_viz import CFG as VCFG
    from test_torch_viz import H, K_NDC, W
    from dbw_tpu.models.dbw import BlocksWorld as JaxBlocksWorld
    from dbw_torch.convert import scene_params_from_numpy
    from dbw_torch.data.base import Loader, MultiViewDataset
    from dbw_torch.models.dbw import BlocksWorld
    from dbw_torch.ops.rotations import look_at_rotation

    jm = JaxBlocksWorld((H, W), backend="xla", **copy.deepcopy(VCFG))
    jm.set_camera(K_NDC)
    tm = BlocksWorld((H, W), device="cpu", **copy.deepcopy(VCFG))
    tm.set_camera(K_NDC)
    p = {k: np.asarray(v) for k, v in jm.init_params(3)._asdict().items()}
    p["alpha_logit"] = np.array([2.0, -0.5], np.float32)
    n = 5
    R, T = look_at_rotation(2.5, 20.0, torch.linspace(-50.0, 50.0, n))
    imgs = np.random.default_rng(3).random((n, H, W, 3), np.float32)
    arrs = (imgs, np.broadcast_to(K_NDC, (n, 4, 4)), R.numpy(), T.numpy())
    return dict(jm=jm, tm=tm, jp=SceneParams(**{k: jnp.asarray(v) for k, v in p.items()}),
                tp=scene_params_from_numpy(p, "cpu", requires_grad=False),
                jl=JaxLoader(JaxDataset(*arrs), batch_size=2),
                tl=Loader(MultiViewDataset(*arrs), batch_size=2))


def test_quantitative_eval_soft_matches_jax(eval_case):
    """hard_inference=False scores the eval phase's predict: the same scores
    as JAX's to 1e-4 relative, and not the hard render's."""
    from dbw_tpu.eval.quant import quantitative_eval as jax_quantitative_eval
    from dbw_torch.eval.quant import quantitative_eval

    c = eval_case
    ref = jax_quantitative_eval(c["jm"], c["jp"], c["jl"], hard_inference=False)
    got = quantitative_eval(c["tm"], c["tp"], c["tl"], hard_inference=False)
    hard = quantitative_eval(c["tm"], c["tp"], c["tl"], hard_inference=True)
    assert list(got) == list(ref)
    for k in ref:
        assert got[k] == pytest.approx(ref[k], rel=1e-4, abs=1e-7), k
    assert got["PSNR"] != hard["PSNR"]


def test_quantitative_eval_uses_the_given_lpips(eval_case):
    from dbw_torch.eval.quant import quantitative_eval
    from dbw_torch.losses.vgg import LPIPSLoss

    c = eval_case
    calls = []

    class Counting(LPIPSLoss):
        def __call__(self, *a, **kw):
            calls.append(1)
            return super().__call__(*a, **kw)

    lp = Counting(vgg=c["tm"].perceptual_loss.vgg if c["tm"].perceptual_loss else None,
                  device="cpu")
    got = quantitative_eval(c["tm"], c["tp"], c["tl"], lpips=lp)
    ref = quantitative_eval(c["tm"], c["tp"], c["tl"])
    assert len(calls) == 3  # one call per batch
    assert got == ref


@pytest.mark.parametrize("quali", [False, True])
def test_evaluate_run_quali_and_label(tmp_path, eval_case, quali, capsys):
    from dbw_torch.eval.full import evaluate_run

    c = eval_case
    scores = evaluate_run(c["tm"], c["tp"], c["tl"], c["tl"].dataset, tmp_path, quali=quali,
                          label="seed7", quali_kwargs=dict(NV=2, n_views=1,
                                                           render_videos=False))
    assert (tmp_path / "final_scores.tsv").exists() and scores["n_blocks"] == 1
    assert (tmp_path / "quali_eval").exists() == quali
    assert (tmp_path / "quali_eval" / "index.html").exists() == quali
    assert "[seed7] final_scores:" in capsys.readouterr().out
