"""The batched seed axis (the JAX package's ``vmap`` seed executor) on the
CPU, at the JAX package's own test sizes: 12x16 images, 2 blocks, 16
texels, K=2, S=3 slots, B=2 views.

- the executor's modes agree (``test_seed_axis_exec_modes_agree`` of
  tests/test_parallel.py);
- the batched step equals the ``map`` step after 1 and 3 Adam steps:
  losses rtol 1e-6, parameters atol 1e-6 (the JAX package's check and
  tolerances, tests/test_parallel.py:791-845, on its model: rgb + tv).
  With the full loss stack the losses are held to rtol 1e-6 as well and
  the parameters to ROADMAP.md's budgets (below): batched, the VGG16
  backward runs at S * B images and the ground pose's matrix products
  over all slots at once, which round otherwise than B images and one
  slot, and Adam turns that rounding of near-zero gradients (the ground
  texture's, the ground pose's cancelling edge terms) into lr-sized
  moves (measured after 3 steps: 9.2e-5 on the ground texture, 1.7e-6 on
  the ground rotation, under 3e-7 elsewhere);
- the batched step equals the JAX package's ``MultiSeedRunner`` under
  ``DBW_SEED_EXEC=vmap``, with JAX's draws passed in, and the batched
  (scene, seed) step equals the JAX trainer's single-device nested vmap
  (``_build_vmap_steps``) for two scenes of different intrinsics, within
  ROADMAP.md's budgets: loss rtol 2e-5 a step, parameters atol 3e-4 after
  3 steps, the ground texture 5e-4 (ROADMAP.md section 3);
- on the pixel-band layout (seed=1, sp=2) on 2 gloo ranks, each rank's
  batched step of the 3 slots equals the one-rank batched step within
  those budgets;
- a lit batched render equals the per-slot renders.
"""

import copy
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from dbw_torch.parallel import seeds as tseeds
from test_torch_mesh import Ranks

H, W, B = 12, 16, 2
SEEDS = [123, 7, 11]
N_STEPS = 3
# the batched step against the map step (the JAX package's tolerances)
MAP_RTOL = 1e-6
MAP_ATOL = 1e-6
# against the JAX package (ROADMAP.md)
LOSS_RTOL = 2e-5
PARAM_ATOL = 3e-4
GROUND_TXT_ATOL = 5e-4

# the model of tests/test_parallel.py::test_multi_seed_runner_map_exec_matches_vmap
JAX_CHECK_CFG = dict(mesh=dict(n_blocks=2, txt_size=16),
                     renderer=dict(faces_per_pixel=2),
                     rend_optim=dict(decouple_rendering=True),
                     loss=dict(rgb_weight=1, tv_weight=0.1))
JAX_CHECK_TRAIN = {"training": {"optimizer": {"name": "adam", "lr": 1e-2}}}
# every loss of the shipped config (the perceptual one at relu3_3: 12x16
# is too small for LPIPS's five levels), opacity noise and block killing
FULL_CFG = dict(mesh=dict(n_blocks=2, txt_size=16, T_range=[0.1, 0.1, 0.1],
                          opacity_init=0.9),
                renderer=dict(faces_per_pixel=2, cameras=dict(name="perspective"),
                              detach_bary=True, z_clip=0.001),
                rend_optim=dict(coarse_learning=1500, decimate_txt=750, decimate_factor=8,
                                kill_blocks=True, decouple_rendering=True, opacity_noise=True),
                loss=dict(rgb_weight=1, perceptual_weight=0.1, perceptual_name="perceptual",
                          parsimony_weight=0.01, tv_weight=0.1, overlap_weight=1))
FULL_TRAIN = {"training": {"optimizer": {"name": "adam", "lr": 5e-3,
                                         "texture": {"lr": 5e-2}}}}


def _k_ndc(f=2.0, c=0.0):
    K = np.zeros((4, 4), np.float32)
    K[0, 0] = K[1, 1] = f
    K[0, 2] = K[1, 2] = c
    K[2, 3] = K[3, 2] = 1.0
    return K


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two torch threads: the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _model(cfg, K=None, size=(H, W)):
    from dbw_torch.models.dbw import BlocksWorld

    tm = BlocksWorld(size, device="cpu", **copy.deepcopy(cfg))
    tm.set_camera(_k_ndc() if K is None else K)
    return tm


def _views(n=B, elev=20.0, spread=30.0, seed=0):
    from dbw_torch.ops.rotations import look_at_rotation

    R, T = look_at_rotation(3.0, elev, torch.linspace(-spread, spread, n))
    imgs = torch.from_numpy(np.random.default_rng(seed).random((n, H, W, 3), np.float32))
    return imgs, R, T


def _gaps(ref, got):
    return {k: float((ref[k] - got[k]).abs().max()) for k in ref}


# ---------------------------------------------------------------------------
# the executor


def test_seed_axis_exec_modes_agree(monkeypatch):
    """map / vmap / auto-single slot are interchangeable: identical results,
    identical stacking (fn takes the leading slot axis itself, as the
    model's functions do)."""

    def fn(a, b):
        return a * 2.0 + b.sum(-1, keepdim=True), {"sq": a ** 2}

    a = torch.arange(12.0).reshape(4, 3)
    b = torch.ones((4, 2))
    monkeypatch.setenv("DBW_SEED_EXEC", "vmap")
    ref = tseeds.seed_axis_exec(fn, a, b)
    monkeypatch.setenv("DBW_SEED_EXEC", "map")
    got = tseeds.seed_axis_exec(fn, a, b)
    assert torch.equal(ref[0], got[0]) and torch.equal(ref[1]["sq"], got[1]["sq"])
    # auto + one slot: the direct call keeps the leading axis
    monkeypatch.setenv("DBW_SEED_EXEC", "auto")
    one = tseeds.seed_axis_exec(fn, a[:1], b[:1])
    assert torch.equal(one[0], ref[0][:1]) and torch.equal(one[1]["sq"], ref[1]["sq"][:1])
    # auto with several slots is the batched call: fn runs once
    calls = []
    tseeds.seed_axis_exec(lambda x: calls.append(x.shape) or x, a)
    assert calls == [(4, 3)]


def test_auto_is_batched_and_launches_each_kernel_once(monkeypatch):
    """auto on the CPU is vmap (no compact pipeline in the port): one
    forward of the S slots, each dispatcher called once a step, against S
    times under map."""
    from dbw_torch.ops import scatter
    from dbw_torch.render import fragment, meshes, renderer

    tm = _model(FULL_CFG)
    imgs, R, T = _views()
    calls = {}

    def counted(mod, name):
        inner = getattr(mod, name)

        def wrapper(*a, **kw):
            calls[name] = calls.get(name, 0) + 1
            return inner(*a, **kw)
        monkeypatch.setattr(mod, name, wrapper)

    counted(renderer, "rasterize")
    counted(fragment, "frag_fwd")
    counted(fragment, "frag_bwd")
    counted(meshes, "quad_maps_grad")
    counted(scatter, "small_table_scatter_add")
    per_mode = {}
    for mode in ("auto", "map"):
        monkeypatch.setenv("DBW_SEED_EXEC", mode)
        calls.clear()
        p = tseeds.stacked_leaves([tm.init_params(seed=s) for s in SEEDS])
        gens = [torch.Generator().manual_seed(s) for s in SEEDS]
        S = len(SEEDS)
        tseeds.seed_backward(tm, p, tm.phase_for_epoch(0), imgs, R.repeat(S, 1, 1),
                             T.repeat(S, 1), tm.step_draws(p, gens))
        per_mode[mode] = dict(calls)
    one = {"rasterize": 2, "frag_fwd": 1, "frag_bwd": 1, "quad_maps_grad": 2,
           "small_table_scatter_add": 1}
    assert per_mode["auto"] == one
    assert per_mode["map"] == {k: len(SEEDS) * v for k, v in one.items()}


# ---------------------------------------------------------------------------
# batched against map


def _seed_steps(cfg, train_cfg, n_steps, mode, monkeypatch):
    from dbw_torch.train.optimizer import create_optimizer

    monkeypatch.setenv("DBW_SEED_EXEC", mode)
    tm = _model(cfg)
    imgs, R, T = _views()
    p = tseeds.stacked_leaves([tm.init_params(seed=s) for s in SEEDS])
    opt = create_optimizer(train_cfg, p)
    losses = []
    for step in range(n_steps):
        gens = [torch.Generator().manual_seed(1000 * s + step) for s in SEEDS]
        losses.append(tseeds.train_step(tm, opt, p, tm.phase_for_epoch(0), (imgs, R, T),
                                        gens)["total"])
    return torch.stack(losses), {k: v.detach() for k, v in p.items()}, opt, p


@pytest.mark.parametrize("n_steps", [1, N_STEPS])
def test_batched_step_equals_map(n_steps, monkeypatch):
    """The JAX package's check on its model (rgb + tv)."""
    ml, mp, *_ = _seed_steps(JAX_CHECK_CFG, JAX_CHECK_TRAIN, n_steps, "map", monkeypatch)
    bl, bp, opt, leaves = _seed_steps(JAX_CHECK_CFG, JAX_CHECK_TRAIN, n_steps, "vmap",
                                      monkeypatch)
    np.testing.assert_allclose(bl.numpy(), ml.numpy(), rtol=MAP_RTOL)
    for k, gap in _gaps(mp, bp).items():
        assert gap <= MAP_ATOL, (k, gap)
    assert int(opt.state[leaves["T"]]["step"]) == n_steps


def test_batched_step_equals_map_full_stack(monkeypatch):
    """The full loss stack: 3 steps' losses at rtol 1e-6, the parameters
    within ROADMAP.md's budgets (module docstring)."""
    ml, mp, *_ = _seed_steps(FULL_CFG, FULL_TRAIN, N_STEPS, "map", monkeypatch)
    bl, bp, *_ = _seed_steps(FULL_CFG, FULL_TRAIN, N_STEPS, "vmap", monkeypatch)
    np.testing.assert_allclose(bl.numpy(), ml.numpy(), rtol=MAP_RTOL)
    for k, gap in _gaps(mp, bp).items():
        assert gap <= _jax_atol(k), (k, gap)


def test_batched_forward_is_each_slots(monkeypatch):
    """The batched forward's renders and every loss term are each slot's
    own, bit for bit, with each slot's draws."""
    tm = _model(FULL_CFG)
    imgs, R, T = _views()
    plist = [tm.init_params(seed=s) for s in SEEDS]
    st = tseeds.stack_params(plist)
    phase = tm.phase_for_epoch(0)
    gens = [torch.Generator().manual_seed(s) for s in SEEDS]
    draws = tm.step_draws(st, gens)
    S = len(SEEDS)
    with torch.no_grad():
        rec, aux = tm.predict(st, phase, R.repeat(S, 1, 1), T.repeat(S, 1),
                              noise=draws["opacity_noise"])
        losses = tm.compute_losses(imgs, rec, st, phase, aux, overlap_u=draws["overlap_u"])
        for s in range(S):
            r, a = tm.predict(plist[s], phase, R, T, noise=draws["opacity_noise"][s])
            assert torch.equal(r, rec[s * B:(s + 1) * B]), s
            own = tm.compute_losses(imgs, r, plist[s], phase, a,
                                    overlap_u=draws["overlap_u"][s])
            for k, v in own.items():
                assert torch.equal(v, losses[k][s]), (s, k)


@pytest.mark.parametrize("cfg", [FULL_CFG, JAX_CHECK_CFG], ids=["overlap", "no_overlap"])
def test_step_draws_are_each_generators_own(cfg):
    """``step_draws`` with S generators is each generator's own draws for
    one set of parameters, stacked, bit for bit; the overlap points only
    with an overlap loss."""
    tm = _model(cfg)
    one = tm.init_params(seed=0)
    st = tseeds.stack_params([tm.init_params(seed=s) for s in SEEDS])
    got = tm.step_draws(st, [torch.Generator().manual_seed(s) for s in SEEDS])
    own = [tm.step_draws(one, torch.Generator().manual_seed(s)) for s in SEEDS]
    assert set(got) == ({"opacity_noise", "overlap_u"} if "overlap_weight" in cfg["loss"]
                        else {"opacity_noise"})
    for k, v in got.items():
        assert torch.equal(v, torch.stack([d[k] for d in own])), k
    # the forward's own draws from a generator are these
    gen = torch.Generator().manual_seed(SEEDS[0])
    noise = torch.randn((tm.n_blocks,), generator=gen)
    assert torch.equal(own[0]["opacity_noise"], noise)
    if "overlap_u" in got:
        assert torch.equal(own[0]["overlap_u"], torch.rand((tm.n_blocks, 1000, 3), generator=gen))


# ---------------------------------------------------------------------------
# against the JAX package


def _jax_draws(tm, keys):
    """JAX's draws of the slots of ``keys``, stacked: {name: (S, ...)}."""
    from test_torch_step import _draws

    return dict(zip(("opacity_noise", "overlap_u"),
                    map(torch.stack, zip(*[_draws(tm, k) for k in keys]))))


def _jax_atol(k):
    return GROUND_TXT_ATOL if k == "texture_ground" else PARAM_ATOL


def test_batched_step_matches_jax_vmap_runner(monkeypatch):
    """3 Adam steps of 3 slots, the full loss stack: the port's batched
    runner step against the JAX package's MultiSeedRunner on one device
    under DBW_SEED_EXEC=vmap, JAX's draws passed in."""
    import jax
    import jax.numpy as jnp

    from dbw_tpu.models.dbw import BlocksWorld as JaxBlocksWorld
    from dbw_tpu.parallel.mesh import make_mesh as jmake
    from dbw_tpu.parallel.seeds import MultiSeedRunner as JaxRunner
    from dbw_tpu.parallel.seeds import stack_params as jstack
    from dbw_tpu.train.optimizer import create_optimizer as jax_create_optimizer
    from dbw_torch.parallel.mesh import make_mesh
    from dbw_torch.train.optimizer import create_optimizer

    monkeypatch.setenv("DBW_SEED_EXEC", "vmap")
    K = _k_ndc(2.8, 0.02)
    jm = JaxBlocksWorld((H, W), backend="xla", **copy.deepcopy(FULL_CFG))
    jm.set_camera(K)
    tm = _model(FULL_CFG, K)
    imgs, R, T = _views()
    plist = [jm.init_params(seed=s) for s in SEEDS]
    jopt = jax_create_optimizer(FULL_TRAIN, plist[0])
    jp, jo = jstack(plist), jstack([jopt.init(p) for p in plist])
    lrs = {"main": jnp.float32(5e-3), "texture": jnp.float32(5e-2)}
    runner = JaxRunner(jm, jopt, jmake(n_seed=1, n_data=1, devices=jax.devices()[:1]))
    jphase = jm.phase_for_epoch(0)

    tp = tseeds.stacked_leaves([tm.init_params(seed=s) for s in SEEDS])
    topt = create_optimizer(FULL_TRAIN, tp)
    trunner = tseeds.MultiSeedRunner(tm, topt, make_mesh(1, 1, world_size=1))
    tphase = tm.phase_for_epoch(0)
    for step in range(N_STEPS):
        keys = jnp.stack([jax.random.fold_in(jax.random.PRNGKey(s), step) for s in SEEDS])
        jp, jo, jl = runner.step(jp, jo, jnp.asarray(imgs.numpy()), jnp.asarray(R.numpy()),
                                 jnp.asarray(T.numpy()), jphase, lrs, keys)
        tl = trunner.step(tp, tphase, imgs, R, T, draws=_jax_draws(tm, keys))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=LOSS_RTOL)
    for k in jp._fields:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(getattr(jp, k)),
                                   atol=_jax_atol(k), err_msg=k)


def test_scene_seed_step_matches_jax_nested_vmap(monkeypatch):
    """Two scenes of different intrinsics and views, 2 seeds each, 3 Adam
    steps: the port's batched (scene, seed) step (one step of 4 slots,
    intrinsics per view) against the JAX trainer's single-device program
    (``_build_vmap_steps``: a nested vmap over scenes and seeds), JAX's
    draws passed in."""
    import jax
    import jax.numpy as jnp

    from dbw_tpu.models.dbw import BlocksWorld as JaxBlocksWorld
    from dbw_tpu.parallel.seeds import stack_params as jstack
    from dbw_tpu.train.multi_scene import MultiSceneTrainer as JaxMultiScene
    from dbw_tpu.train.optimizer import create_optimizer as jax_create_optimizer
    from dbw_torch.parallel.scenes import camera_state
    from dbw_torch.train.optimizer import create_optimizer

    monkeypatch.setenv("DBW_SEED_EXEC", "vmap")
    seeds = [[123, 7], [11, 5]]
    Ks = [_k_ndc(2.8, 0.02), _k_ndc(2.2, -0.03)]
    n_views = 4
    scene_views = [_views(n_views, elev=20.0, spread=30.0, seed=0),
                   _views(n_views, elev=30.0, spread=45.0, seed=1)]
    # each step's B views of each scene
    idx = [np.array([[0, 1], [2, 3]]), np.array([[3, 0], [1, 2]]), np.array([[1, 2], [0, 3]])]

    jm = JaxBlocksWorld((H, W), backend="xla", **copy.deepcopy(FULL_CFG))
    jm.set_camera(Ks[0])
    plist = [[jm.init_params(seed=s) for s in ss] for ss in seeds]
    jopt = jax_create_optimizer(FULL_TRAIN, plist[0][0])
    jp = jstack([jstack(pl) for pl in plist])
    jo = jstack([jstack([jopt.init(p) for p in pl]) for pl in plist])
    jstep, _ = JaxMultiScene._build_vmap_steps(SimpleNamespace(model=jm, optimizer=jopt))
    lrs = {"main": jnp.float32(5e-3), "texture": jnp.float32(5e-2)}
    jphase = jm.phase_for_epoch(0)
    arr = lambda c: jnp.asarray(np.stack([v[c].numpy() for v in scene_views]))

    tm = _model(FULL_CFG, Ks[0])
    cams = [camera_state(tm, K) for K in Ks]
    tp = tseeds.stacked_leaves([tseeds.stack_params([tm.init_params(seed=s) for s in ss])
                                for ss in seeds])
    topt = create_optimizer(FULL_TRAIN, tp)
    tphase = tm.phase_for_epoch(0)
    own = tm.camera
    for step in range(N_STEPS):
        keys = jnp.stack([jnp.stack([jax.random.fold_in(jax.random.PRNGKey(s), step)
                                     for s in ss]) for ss in seeds])
        jp, jo, jl = jstep(jnp.asarray(np.stack(Ks)), jp, jo, arr(0), arr(1), arr(2),
                           jnp.asarray(idx[step]), jphase, lrs, keys)
        views = [tuple(v[c][idx[step][i]] for c in range(3))
                 for i, v in enumerate(scene_views)]
        per_scene = [_jax_draws(tm, keys[i]) for i in range(len(seeds))]
        draws = {k: torch.stack([d[k] for d in per_scene]) for k in per_scene[0]}
        tl = tseeds.train_step(tm, topt, tp, tphase, views, draws=draws, cameras=cams)["total"]
        assert tm.camera is own
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=LOSS_RTOL)
    for k in jp._fields:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(getattr(jp, k)),
                                   atol=_jax_atol(k), err_msg=k)


def test_scene_seed_step_equals_map(monkeypatch):
    """The batched (scene, seed) step against the map executor's scenes
    one after the other with the camera swap: losses and gradients of one
    step within the batched-vs-map tolerances."""
    from dbw_torch.parallel.scenes import camera_state, scene_backward

    Ks = [_k_ndc(2.8, 0.02), _k_ndc(2.2, -0.03)]
    tm = _model(FULL_CFG, Ks[0])
    cams = [camera_state(tm, K) for K in Ks]
    views = [_views(B, elev=20.0, seed=0), _views(B, elev=30.0, spread=45.0, seed=1)]
    seeds = [[123, 7], [11, 5]]
    out = {}
    for mode in ("map", "vmap"):
        monkeypatch.setenv("DBW_SEED_EXEC", mode)
        p = tseeds.stacked_leaves([tseeds.stack_params([tm.init_params(seed=s) for s in ss])
                                   for ss in seeds])
        gens = [torch.Generator().manual_seed(s) for ss in seeds for s in ss]
        losses = scene_backward(tm, p, tm.phase_for_epoch(0), views, cams,
                                tm.step_draws(p, gens))["total"]
        out[mode] = losses, {k: v.grad for k, v in p.items()}
    np.testing.assert_allclose(out["vmap"][0].numpy(), out["map"][0].numpy(), rtol=MAP_RTOL)
    for k, g in out["map"][1].items():
        np.testing.assert_allclose(out["vmap"][1][k].numpy(), g.numpy(),
                                   atol=MAP_RTOL * float(g.abs().max()), err_msg=k)


# ---------------------------------------------------------------------------
# the pixel-band layout on 2 ranks


def _band_steps(mesh, draws):
    from dbw_torch.train.optimizer import create_optimizer

    tm = _model(FULL_CFG, _k_ndc(2.8, 0.02))
    imgs, R, T = _views()
    p = tseeds.stacked_leaves([tm.init_params(seed=s) for s in SEEDS])
    runner = tseeds.MultiSeedRunner(tm, create_optimizer(FULL_TRAIN, p), mesh)
    losses = [runner.step(p, tm.phase_for_epoch(0), imgs, R, T, draws=d) for d in draws]
    return torch.stack(losses), {k: v.detach() for k, v in p.items()}


def band_rank(rank, draws):
    from dbw_torch.parallel.mesh import make_mesh
    from test_torch_sharded import raster_rows

    with raster_rows() as rows:
        out = _band_steps(make_mesh(n_seed=1, n_data=1, n_spatial=2), draws)
    return out + (rows,)


def test_batched_step_on_band_layout(tmp_path, monkeypatch):
    """(seed=1, sp=2) on 2 gloo ranks: each rank renders its band of all 3
    slots' views in one batch (K1's band variant), the band images
    gathered over (S * B, Hb, W, 3); losses and parameters against the
    one-rank batched step."""
    from dbw_torch.parallel.mesh import make_mesh

    monkeypatch.setenv("DBW_SEED_EXEC", "vmap")
    gens = [[torch.Generator().manual_seed(1000 * s + k) for s in SEEDS]
            for k in range(N_STEPS)]
    tm = _model(FULL_CFG)
    st = tseeds.stack_params([tm.init_params(seed=s) for s in SEEDS])
    draws = [tm.step_draws(st, gs) for gs in gens]
    ranks = Ranks(tmp_path, 2, band_rank, draws)
    one_l, one_p = _band_steps(make_mesh(1, 1, world_size=1), draws)
    Hb = H // 2
    for r, (losses, params, rows) in enumerate(ranks.results()):
        assert rows == {(r * Hb, Hb)}
        np.testing.assert_allclose(losses.numpy(), one_l.numpy(), rtol=LOSS_RTOL)
        for k, gap in _gaps(one_p, params).items():
            assert gap <= _jax_atol(k), (r, k, gap)


# ---------------------------------------------------------------------------
# the lit renderer


@pytest.mark.parametrize("shading,light", [("flat", "directional"), ("gouraud", "point"),
                                           ("phong", "directional")])
def test_lit_batched_render_equals_per_slot(shading, light):
    """A lit config's batched predict of 3 slots against each slot's own
    render (the blocks' and the env pass's lit shading on S * B views)."""
    lights = {"directional": dict(name="directional", direction=[[1.0, 0.25, -1.0]]),
              "point": dict(name="point", location=[[0.0, 2.0, -2.0]])}
    cfg = copy.deepcopy(FULL_CFG)
    cfg["renderer"].update(shading_type=shading, lights=lights[light])
    tm = _model(cfg)
    _, R, T = _views()
    plist = [tm.init_params(seed=s) for s in SEEDS]
    phase = tm.phase_for_epoch(0)
    noise = torch.randn((len(SEEDS), tm.n_blocks), generator=torch.Generator().manual_seed(0))
    S = len(SEEDS)
    with torch.no_grad():
        rec, _ = tm.predict(tseeds.stack_params(plist), phase, R.repeat(S, 1, 1),
                            T.repeat(S, 1), noise=noise)
        for s in range(S):
            own, _ = tm.predict(plist[s], phase, R, T, noise=noise[s])
            torch.testing.assert_close(rec[s * B:(s + 1) * B], own, rtol=0, atol=1e-6)
