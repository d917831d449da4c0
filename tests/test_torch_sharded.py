"""The port's sharded step and its sharded trainers on CPU ranks under
gloo (``test_torch_mesh.spawn_ranks``, 4 ranks).

- ``MultiSeedRunner.step`` on (seed=2, data=2), (seed=1, sp=4) and
  (seed=1, data=2, sp=2), 3 Adam steps of the decoupled model with the
  full loss stack (the perceptual loss among them) at 24x32, against the
  JAX package's ``MultiSeedRunner.step`` on the same layout over 4 of the
  8 CPU devices, and against the port's runner on one rank (itself
  ``train_step`` without a mesh bit for bit). JAX's draws are passed in. Each rank of an
  ``sp`` axis selects faces for its own band of rows only. Tolerances
  (ROADMAP.md): loss rtol 2e-5 a step, parameters atol 3e-4 after 3
  steps, but the ground texture of seed 7 at 5e-4 (the JAX package's own
  jit and eager runs differ by 4.6e-4 there:
  ROADMAP.md section 3, ``test_torch_protocol.py``).
- The protocol on 4 ranks on ``synthetic/tiny.yml``: on its automatic
  layout (all-seed, 4 slots for 2 seeds) bit for bit the one-rank run and
  within the tolerances of the JAX trainer's mesh run; with batch_size 4,
  the (seed=2, data=2) layout killed after its first save and resumed on
  one rank, and the other way round, each ending within the tolerances of
  the uninterrupted run; its ``multi_model.pkl`` resumes in the JAX
  package.
- The multi-scene trainer on 4 ranks, (scene=2, seed=1, data=2) on two
  tiny scenes, against the one-rank run and the JAX trainer's mesh run,
  and killed on 4 ranks, resumed on one.
"""

import contextlib
import copy

import numpy as np
import pytest
import torch

from test_torch_mesh import Ranks, spawn_ranks

LOSS_RTOL = 2e-5
PARAM_ATOL = 3e-4
GROUND_TXT_ATOL = 5e-4  # seed 7's ground texture (module docstring)
H, W, B = 24, 32, 4
N_STEPS = 3
LAYOUTS = {"seed2-data2": (dict(n_seed=2, n_data=2), [123, 7]),
           "seed1-sp4": (dict(n_seed=1, n_data=1, n_spatial=4), [123]),
           "seed1-data2-sp2": (dict(n_seed=1, n_data=2, n_spatial=2), [7])}


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two torch threads in this process: the test workers share the
    host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _atol(name, seed):
    return GROUND_TXT_ATOL if (name, seed) == ("texture_ground", 7) else PARAM_ATOL


def _port_model(cfg, k_ndc, size=(H, W)):
    from dbw_torch.models.dbw import BlocksWorld

    tm = BlocksWorld(size, device="cpu", **copy.deepcopy(cfg))
    tm.set_camera(k_ndc)
    return tm


@contextlib.contextmanager
def raster_rows():
    """The (row0, rows) of every face selection the renderer makes inside
    the block: row0 from its ``row_range``, rows from its pix_to_face."""
    from dbw_torch.render import renderer

    seen, inner = set(), renderer.rasterize

    def record(*args, row_range=None, **kw):
        p2f = inner(*args, row_range=row_range, **kw)
        seen.add((0 if row_range is None else int(row_range[0]), int(p2f.shape[1])))
        return p2f

    renderer.rasterize = record
    try:
        yield seen
    finally:
        renderer.rasterize = inner


def _port_steps(mesh, cfg, train_cfg, k_ndc, seeds, imgs, R, T, draws):
    """N_STEPS of this rank's slots through MultiSeedRunner -> (its slot
    slice, (N_STEPS, S_local) losses, params, the rows its face selections
    covered)."""
    from dbw_torch.parallel.seeds import MultiSeedRunner, stacked_leaves
    from dbw_torch.train.optimizer import create_optimizer

    tm = _port_model(cfg, k_ndc, imgs.shape[1:3])
    sl = mesh.slot_slice(len(seeds))
    params = stacked_leaves([tm.init_params(seed=s) for s in seeds[sl]])
    opt = create_optimizer(train_cfg, params)
    runner = MultiSeedRunner(tm, opt, mesh)
    v = mesh.data_slice(len(imgs))
    imgs, R, T = (torch.from_numpy(np.array(a))[v] for a in (imgs, R, T))
    phase = tm.phase_for_epoch(0)
    losses = []
    with raster_rows() as rows:
        for step in range(N_STEPS):
            noise, ou = (torch.from_numpy(np.stack(a)) for a in zip(*draws[step][sl]))
            d = dict(opacity_noise=noise, overlap_u=ou)
            losses.append(runner.step(params, phase, imgs, R, T, draws=d))
    return sl, torch.stack(losses), {k: p.detach() for k, p in params.items()}, rows


def sharded_steps_rank(rank, layout, *args):
    from dbw_torch.parallel.mesh import make_mesh

    return _port_steps(make_mesh(**layout), *args)


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_sharded_step_matches_jax_and_one_rank(tmp_path, name):
    import jax
    import jax.numpy as jnp

    from dbw_tpu.models.dbw import BlocksWorld as JaxBlocksWorld
    from dbw_tpu.ops.rotations import look_at_rotation as jax_look_at
    from dbw_tpu.parallel.mesh import make_mesh as jmake
    from dbw_tpu.parallel.seeds import MultiSeedRunner as JaxRunner
    from dbw_tpu.parallel.seeds import stack_params as jstack
    from dbw_tpu.train.optimizer import create_optimizer as jax_create_optimizer
    from dbw_torch.parallel.mesh import make_mesh
    from test_torch_step import DEC_CFG, K_NDC, TRAIN_CFG, _draws

    layout, seeds = LAYOUTS[name]
    jm = JaxBlocksWorld((H, W), backend="xla", **copy.deepcopy(DEC_CFG))
    jm.set_camera(K_NDC)
    R, T = jax_look_at(3.0, 25.0, jnp.linspace(-40.0, 40.0, B))
    imgs = np.random.default_rng(0).random((B, H, W, 3), np.float32)
    plist = [jm.init_params(seed=s) for s in seeds]
    jopt = jax_create_optimizer(TRAIN_CFG, plist[0])
    jp, jo = jstack(plist), jstack([jopt.init(p) for p in plist])
    lrs = {"main": jnp.float32(5e-3), "texture": jnp.float32(5e-2)}
    runner = JaxRunner(jm, jopt, jmake(devices=jax.devices()[:4], **layout))
    phase = jm.phase_for_epoch(0)
    tm = _port_model(DEC_CFG, K_NDC)
    keys = [jnp.stack([jax.random.fold_in(jax.random.PRNGKey(s), step) for s in seeds])
            for step in range(N_STEPS)]
    draws = [[tuple(t.numpy() for t in _draws(tm, k[i])) for i in range(len(seeds))]
             for k in keys]
    args = (DEC_CFG, TRAIN_CFG, K_NDC, seeds, imgs, np.asarray(R), np.asarray(T), draws)
    ranks = Ranks(tmp_path, 4, sharded_steps_rank, layout, *args)
    jl = []
    for step in range(N_STEPS):
        jp, jo, losses = runner.step(jp, jo, jnp.asarray(imgs), R, T, phase, lrs, keys[step])
        jl.append(np.asarray(losses))
    jl = np.stack(jl)
    _, one_l, one_p, one_rows = _port_steps(make_mesh(1, 1, world_size=1), *args)
    ranks = ranks.results()
    np.testing.assert_allclose(one_l.numpy(), jl, rtol=LOSS_RTOL)
    assert one_rows == {(0, H)}
    n_sp = layout.get("n_spatial", 1)
    Hb = -(-H // n_sp)
    # rank r's sp coordinate is r % n_sp (the innermost axis): its own band
    assert [rows for *_, rows in ranks] == [{(r % n_sp * Hb, Hb)} for r in range(4)]
    covered = set()
    for sl, losses, params, _ in ranks:
        covered |= set(range(len(seeds))[sl])
        np.testing.assert_allclose(losses.numpy(), jl[:, sl], rtol=LOSS_RTOL)
        np.testing.assert_allclose(losses.numpy(), one_l[:, sl].numpy(), rtol=LOSS_RTOL)
        for k in jp._fields:
            ref = np.asarray(getattr(jp, k))[sl]
            for i, s in enumerate(seeds[sl]):
                np.testing.assert_allclose(params[k][i].numpy(), ref[i], atol=_atol(k, s),
                                           err_msg=(name, k, s))
                np.testing.assert_allclose(params[k][i].numpy(), one_p[k][sl][i].numpy(),
                                           atol=_atol(k, s), err_msg=(name, k, s))
    assert covered == set(range(len(seeds)))


def test_one_rank_runner_is_seed_step():
    """On a mesh of one rank, whose collectives do nothing,
    MultiSeedRunner.step is ``train_step`` without a mesh bit for bit: the
    trainer's one-card path."""
    from dbw_torch.ops.rotations import look_at_rotation
    from dbw_torch.parallel.mesh import make_mesh
    from dbw_torch.parallel.seeds import MultiSeedRunner, stacked_leaves, train_step
    from dbw_torch.train.optimizer import create_optimizer
    from dbw_torch.train.trainer import step_seed
    from test_torch_step import DEC_CFG, K_NDC, TRAIN_CFG

    seeds = [123, 7]
    imgs = torch.from_numpy(np.random.default_rng(0).random((B, H, W, 3), np.float32))
    R, T = look_at_rotation(3.0, 25.0, torch.linspace(-40.0, 40.0, B))
    out = []
    for one_rank in (False, True):
        tm = _port_model(DEC_CFG, K_NDC)
        params = stacked_leaves([tm.init_params(seed=s) for s in seeds])
        opt = create_optimizer(TRAIN_CFG, params)
        runner = MultiSeedRunner(tm, opt, make_mesh(1, 1, world_size=1))
        phase = tm.phase_for_epoch(0)
        losses = []
        for k in range(N_STEPS):
            gens = [torch.Generator().manual_seed(step_seed(s, k)) for s in seeds]
            losses.append(runner.step(params, phase, imgs, R, T, gens) if one_rank else
                          train_step(tm, opt, params, phase, (imgs, R, T), gens)["total"])
        out.append((torch.stack(losses), {k: p.detach() for k, p in params.items()}))
    (la, pa), (lb, pb) = out
    assert torch.equal(la, lb)
    for k in pa:
        assert torch.equal(pa[k], pb[k]), k


# ---------------------------------------------------------------------------
# the trainers on 4 ranks


def _tiny(**training):
    from dbw_torch.utils.config import load_yaml
    from dbw_torch.utils.path import CONFIGS_PATH

    cfg = load_yaml(CONFIGS_PATH / "synthetic" / "tiny.yml")
    cfg["training"].update(training)
    return cfg


def run_protocol(rank, cfg, run_dir, seeds=None, resume=False, kill=False, world_size=None):
    """A MultiSeedTrainer run on the CPU (killed right after its first save
    with ``kill``) -> its slots, final losses and every slot's parameters
    and Adam state (None when killed)."""
    from dbw_torch.train.multi_seed import MultiSeedTrainer

    t = MultiSeedTrainer(copy.deepcopy(cfg), run_dir, seeds, resume=resume, device="cpu",
                         world_size=world_size)
    if kill:
        save = t.save

        def save_and_die(epoch, batch):
            save(epoch, batch)
            raise KeyboardInterrupt("killed")

        t.save = save_and_die
        try:
            t.run()
        except KeyboardInterrupt:
            return None
        raise AssertionError("the run was not killed")
    _, _, losses = t.run()
    st = [t.optimizer.state[p] for p in t.params.values()]
    return dict(seeds=t.seeds, mesh=t.mesh.shape, losses=losses,
                params={k: v.detach().clone() for k, v in t.final_params.items()},
                step=int(st[0]["step"]), rank0=t.rank0)


def _same_run(got, ref, seeds, exact=False):
    """The valid slots' final losses and parameters of two runs."""
    n = len(seeds)
    if exact:
        np.testing.assert_array_equal(got["losses"], ref["losses"])
    else:
        np.testing.assert_allclose(got["losses"], ref["losses"], rtol=LOSS_RTOL)
    for k, v in ref["params"].items():
        for i in range(n):
            a, b = got["params"][k][i], np.asarray(v[i])
            if exact:
                np.testing.assert_array_equal(np.asarray(a), b, err_msg=k)
            else:
                np.testing.assert_allclose(np.asarray(a), b, atol=PARAM_ATOL, err_msg=k)


@pytest.fixture(scope="module")
def one_rank_runs(tmp_path_factory):
    """One-rank protocol runs of tiny.yml with batch sizes 3 and 4; batch 3
    under the map executor: the 4-rank all-seed layout holds one slot a
    rank, whose step is the map executor's per-slot step, so the two runs
    agree bit for bit (the batched step of both slots rounds otherwise)."""
    tmp = tmp_path_factory.mktemp("one")
    runs = {}
    for bs in (3, 4):
        with pytest.MonkeyPatch.context() as mp:
            if bs == 3:
                mp.setenv("DBW_SEED_EXEC", "map")
            runs[bs] = run_protocol(0, _tiny(batch_size=bs), tmp / f"bs{bs}", [1, 2],
                                    world_size=1)
    return runs


def test_protocol_on_4_ranks_matches_one_rank_and_jax(tmp_path, one_rank_runs):
    """tiny.yml as shipped (batch 3): 4 ranks take the all-seed layout, 2
    seeds in 4 slots, and end bit for bit as one rank does; the JAX
    trainer's 8-device mesh run ends within the tolerances; rank 0 alone
    wrote the run directory."""
    from dbw_tpu.train.multi_seed import MultiSeedTrainer as JaxMultiSeedTrainer

    ranks = Ranks(tmp_path, 4, run_protocol, _tiny(), tmp_path / "port", [1, 2])
    j = JaxMultiSeedTrainer(_tiny(), tmp_path / "jax", [1, 2])
    j.viz = False
    _, _, jl = j.run()
    outs = ranks.results()
    assert outs[0]["mesh"] == {"seed": 4, "data": 1} and outs[0]["seeds"] == [1, 2, 1, 2]
    assert [o["rank0"] for o in outs] == [True, False, False, False]
    for o in outs:
        _same_run(o, one_rank_runs[3], [1, 2], exact=True)
    _same_run(outs[0], dict(losses=jl, params=j.params._asdict()), [1, 2])
    for f in ("train_metrics.tsv", "seed_selection.tsv", "multi_model.pkl", "model.pkl",
              "seed1/model.pkl", "seed2/val_metrics.tsv", "reconstructions_best/img0"):
        assert (tmp_path / "port" / f).exists(), f


def _restored(t):
    """A JAX trainer's restored state as numpy."""
    return ({k: np.asarray(v) for k, v in t.params._asdict().items()},
            np.asarray(t.opt_state.count))


def test_kill_on_4_ranks_resume_on_one_and_in_jax(tmp_path, one_rank_runs):
    """batch_size 4: 4 ranks take (seed=2, data=2). Killed after the first
    save, the file resumes on one rank, which ends within the tolerances of
    the uninterrupted one-rank run, and in the JAX package with the saved
    state."""
    from dbw_tpu.train.multi_seed import MultiSeedTrainer as JaxMultiSeedTrainer
    from dbw_torch.train import checkpoint as ck

    cfg = _tiny(batch_size=4)
    run = tmp_path / "k"
    assert spawn_ranks(tmp_path, 4, run_protocol, cfg, run, [1, 2], False, True) == [None] * 4
    state = ck.read_pickle(run / "multi_model.pkl")
    assert (state["epoch"], state["batch"], state["step_ctr"]) == (3, 2, 6)
    j = JaxMultiSeedTrainer(copy.deepcopy(cfg), run, None, resume=True)
    assert j.seeds == [1, 2] and (j.epoch_start, j.batch_start) == (4, 1)
    params, count = _restored(j)
    np.testing.assert_array_equal(count, [6, 6])
    for k, v in params.items():
        np.testing.assert_array_equal(v, np.asarray(getattr(state["params"], k)))
    resumed = run_protocol(0, cfg, run, resume=True, world_size=1)
    assert resumed["step"] == 8
    _same_run(resumed, one_rank_runs[4], [1, 2])


def test_kill_on_one_rank_resume_on_4(tmp_path, one_rank_runs):
    """The other way round: a one-rank run killed after its first save
    resumes on 4 ranks, (seed=2, data=2), and ends within the tolerances of
    the uninterrupted one-rank run on every rank."""
    cfg = _tiny(batch_size=4)
    run = tmp_path / "k"
    assert run_protocol(0, cfg, run, [1, 2], kill=True, world_size=1) is None
    outs = spawn_ranks(tmp_path, 4, run_protocol, cfg, run, None, True)
    assert outs[0]["mesh"] == {"seed": 2, "data": 2}
    for o in outs:
        assert o["step"] == 8
        _same_run(o, one_rank_runs[4], [1, 2])


def run_scenes(rank, cfgs, run_dirs, resume=False, kill=False, world_size=None):
    """A MultiSceneTrainer run of 1 seed per scene on the CPU -> its final
    losses and every slot's parameters (None when killed)."""
    from dbw_torch.train.multi_scene import MultiSceneTrainer

    t = MultiSceneTrainer(copy.deepcopy(cfgs), run_dirs, n_seeds=1, resume=resume,
                          device="cpu", world_size=world_size)
    if kill:
        save = t.save

        def save_and_die(epoch, batch):
            save(epoch, batch)
            raise KeyboardInterrupt("killed")

        t.save = save_and_die
        try:
            t.run()
        except KeyboardInterrupt:
            return None
        raise AssertionError("the run was not killed")
    params, best, losses = t.run()
    return dict(mesh=None if t.mesh is None else t.mesh.shape, losses=losses,
                params={k: v.detach().clone() for k, v in params.items()})


def _scene_cfgs():
    cfgs = []
    for k, ds_seed in enumerate((3, 5)):
        cfg = _tiny(batch_size=4, seed=10 + k)
        cfg["dataset"].update(seed=ds_seed, tag=f"s{ds_seed}")
        cfgs.append(cfg)
    return cfgs


def test_scenes_on_4_ranks_match_one_rank_and_jax(tmp_path):
    """Two tiny scenes on 4 ranks, (scene=2, seed=1, data=2): each rank's
    view of the run, the one-rank run and the JAX trainer's 8-device mesh
    run (scene=2, seed=1, data=4) end within the tolerances; killed on 4
    ranks after its first save, the run resumes on one rank and ends
    within them too."""
    from dbw_tpu.train.multi_scene import MultiSceneTrainer as JaxMultiSceneTrainer

    cfgs = _scene_cfgs()
    dirs = lambda tag: [tmp_path / tag / f"s{k}" for k in range(2)]
    ranks = Ranks(tmp_path, 4, run_scenes, cfgs, dirs("port"))
    one = run_scenes(0, cfgs, dirs("one"), world_size=1)
    j = JaxMultiSceneTrainer(copy.deepcopy(cfgs), dirs("jax"), n_seeds=1)
    assert dict(j._mesh.shape) == {"scene": 2, "seed": 1, "data": 4}
    _, _, jl = j.run()
    outs = ranks.results()
    assert outs[0]["mesh"] == {"scene": 2, "seed": 1, "data": 2}
    jref = dict(losses=jl, params={k: np.asarray(v)
                                   for k, v in j.params._asdict().items()})
    for o in outs:
        for ref in (one, jref):
            np.testing.assert_allclose(o["losses"], ref["losses"], rtol=LOSS_RTOL)
            for k, v in ref["params"].items():
                np.testing.assert_allclose(np.asarray(o["params"][k]), np.asarray(v),
                                           atol=PARAM_ATOL, err_msg=k)
    for d in dirs("port"):
        for f in ("train_metrics.tsv", "val_metrics.tsv", "model.pkl"):
            assert (d / f).exists(), (d, f)
    assert (dirs("port")[0] / "multi_scene_model.pkl").exists()

    assert spawn_ranks(tmp_path, 4, run_scenes, cfgs, dirs("k"), False, True) == [None] * 4
    resumed = run_scenes(0, cfgs, dirs("k"), resume=True, world_size=1)
    np.testing.assert_allclose(resumed["losses"], one["losses"], rtol=LOSS_RTOL)
    for k, v in one["params"].items():
        np.testing.assert_allclose(np.asarray(resumed["params"][k]), np.asarray(v),
                                   atol=PARAM_ATOL, err_msg=k)


@pytest.mark.slow
def test_band_layout_at_the_flagship_size(tmp_path):
    """(seed=1, data=2, sp=2) at the flagship's 300x400 with the perceptual
    loss (the twin of the JAX package's slow
    test_spatial_mesh_step_matches_single_device_flagship_shape): 3 steps
    on 4 ranks against the one-rank step."""
    from dbw_torch.ops.rotations import look_at_rotation
    from dbw_torch.parallel.mesh import make_mesh
    from test_torch_step import DEC_CFG, K_NDC, TRAIN_CFG

    R, T = look_at_rotation(3.0, 20.0, torch.linspace(-30.0, 30.0, B))
    imgs = np.random.default_rng(1).random((B, 300, 400, 3), np.float32)
    rng = np.random.default_rng(2)
    n_blocks = DEC_CFG["mesh"]["n_blocks"]
    draws = [[(rng.standard_normal(n_blocks).astype(np.float32),
               rng.random((n_blocks, 1000, 3), np.float32))] for _ in range(N_STEPS)]
    args = (DEC_CFG, TRAIN_CFG, K_NDC, [3], imgs, R.numpy(), T.numpy(), draws)
    layout = dict(n_seed=1, n_data=2, n_spatial=2)
    ranks = spawn_ranks(tmp_path, 4, sharded_steps_rank, layout, *args, timeout=1800)
    _, one_l, one_p = _port_steps(make_mesh(1, 1, world_size=1), *args)
    for sl, losses, params in ranks:
        np.testing.assert_allclose(losses.numpy(), one_l.numpy(), rtol=LOSS_RTOL)
        for k, v in one_p.items():
            np.testing.assert_allclose(params[k].numpy(), v.numpy(), atol=PARAM_ATOL,
                                       err_msg=k)
