"""The port's device mesh on the CPU: ``factor_devices``, ``make_mesh`` and
``make_scene_mesh`` against the JAX package's (shapes, each rank's
coordinates against the position of device r in JAX's mesh over
``jax.devices()[:n]``, the error messages), the protocol's and the
multi-scene trainer's layout and validation against the JAX trainers',
and the collectives on ranks joined under gloo: the band gather and its
transpose, the averaged gradients, the gathered slots, the backend.

The ranks are processes spawned by ``Ranks`` (at most 4, one torch
thread each, joined by a file store); ``test_torch_sharded.py`` uses it
too. JAX is imported inside the tests, so that the ranks do not load it."""

import copy
import multiprocessing
import pickle
import time

import numpy as np
import pytest
import torch

from dbw_torch.parallel.mesh import factor_devices, make_mesh
from dbw_torch.parallel.scenes import make_scene_mesh

RANK_TIMEOUT_S = 240


def _rank_main(rank, world, tmp, fn, args):
    """One spawned rank: join the group, run fn(rank, *args), keep its
    result."""
    torch.set_num_threads(1)
    from dbw_torch.parallel.mesh import close_distributed, init_distributed

    init_distributed("cpu", init_method=f"file://{tmp}/store", rank=rank, world_size=world)
    try:
        out = fn(rank, *args)
        with open(f"{tmp}/rank{rank}.pkl", "wb") as f:
            pickle.dump(out, f)
    finally:
        close_distributed()


class Ranks:
    """fn(rank, *args) started on ``world`` CPU ranks under gloo; the
    caller may work meanwhile. ``results()`` -> [each rank's result]; a rank
    that fails or outlives ``timeout`` fails it, and every rank is
    stopped."""

    def __init__(self, tmp_path, world, fn, *args, timeout=RANK_TIMEOUT_S):
        self.tmp = tmp_path / f"ranks{time.monotonic_ns()}"
        self.tmp.mkdir()
        ctx = multiprocessing.get_context("spawn")
        self.procs = [ctx.Process(target=_rank_main, args=(r, world, str(self.tmp), fn, args))
                      for r in range(world)]
        for p in self.procs:
            p.start()
        self.deadline = time.monotonic() + timeout

    def results(self):
        try:
            for p in self.procs:
                p.join(max(self.deadline - time.monotonic(), 0.0))
            codes = [p.exitcode for p in self.procs]
            assert all(c == 0 for c in codes), f"rank exit codes {codes}"
        finally:
            for p in self.procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        out = []
        for r in range(len(self.procs)):
            with open(self.tmp / f"rank{r}.pkl", "rb") as f:
                out.append(pickle.load(f))
        return out


def spawn_ranks(tmp_path, world, fn, *args, timeout=RANK_TIMEOUT_S):
    """fn(rank, *args) on ``world`` CPU ranks -> [each rank's result]."""
    return Ranks(tmp_path, world, fn, *args, timeout=timeout).results()


# ---------------------------------------------------------------------------
# layouts against the JAX package's


@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8])
@pytest.mark.parametrize("n_seeds", [None, 1, 2, 3, 5, 9])
def test_factor_devices_matches_jax(n, n_seeds):
    from dbw_tpu.parallel.mesh import factor_devices as jfactor

    assert factor_devices(n, n_seeds) == jfactor(n, n_seeds)


def _jax_coords(mesh, n):
    """Each device's coordinates in a JAX mesh over jax.devices()[:n]."""
    import jax

    devs = list(mesh.devices.flat)
    shape = mesh.devices.shape
    return [tuple(int(c) for c in np.unravel_index(devs.index(d), shape))
            for d in jax.devices()[:n]]


MESH_CASES = [
    (8, {}), (8, dict(n_seeds=5)), (4, dict(n_seeds=2)), (4, dict(n_data=2)),
    (4, dict(n_seed=2)), (4, dict(n_seed=1, n_spatial=4)), (4, dict(n_data=2, n_spatial=2)),
    (2, dict(n_seed=1, n_spatial=2)), (8, dict(n_seed=2, n_data=1, n_spatial=4)),
    (8, dict(n_seed=1, n_data=2, n_spatial=4)), (1, {}),
]


@pytest.mark.parametrize("n,kw", MESH_CASES)
def test_make_mesh_matches_jax(n, kw):
    """The same axes and shape; rank r at device r's place in JAX's mesh."""
    import jax

    from dbw_tpu.parallel.mesh import make_mesh as jmake

    ref = jmake(devices=jax.devices()[:n], **kw)
    coords = _jax_coords(ref, n)
    for r in range(n):
        m = make_mesh(world_size=n, rank=r, **kw)
        assert m.axis_names == tuple(ref.axis_names)
        assert m.shape == dict(ref.shape)
        assert tuple(m.coords[a] for a in m.axis_names) == coords[r]


@pytest.mark.parametrize("n,kw", [(8, dict(n_seed=3)), (8, dict(n_data=3)),
                                  (4, dict(n_spatial=3)), (6, dict(n_spatial=4)),
                                  (4, dict(n_seed=3, n_spatial=2))])
def test_make_mesh_errors_match_jax(n, kw):
    import jax

    from dbw_tpu.parallel.mesh import make_mesh as jmake

    with pytest.raises(ValueError) as ref:
        jmake(devices=jax.devices()[:n], **kw)
    with pytest.raises(ValueError) as got:
        make_mesh(world_size=n, rank=0, **kw)
    assert str(got.value) == str(ref.value)


@pytest.mark.parametrize("n,n_scene,kw", [(4, 2, {}), (8, 2, dict(n_data=2)),
                                          (8, 4, dict(n_seed=2)), (4, 4, {}),
                                          (8, 2, dict(n_seed=1))])
def test_make_scene_mesh_matches_jax(n, n_scene, kw):
    import jax

    from dbw_tpu.parallel.scenes import make_scene_mesh as jmake

    ref = jmake(n_scene, devices=jax.devices()[:n], **kw)
    coords = _jax_coords(ref, n)
    for r in range(n):
        m = make_scene_mesh(n_scene, world_size=n, rank=r, **kw)
        assert m.axis_names == tuple(ref.axis_names) == ("scene", "seed", "data")
        assert m.shape == dict(ref.shape)
        assert tuple(m.coords[a] for a in m.axis_names) == coords[r]


@pytest.mark.parametrize("kw", [dict(n_data=3), dict(n_seed=3)])
def test_make_scene_mesh_errors_match_jax(kw):
    import jax

    from dbw_tpu.parallel.scenes import make_scene_mesh as jmake

    with pytest.raises(ValueError) as ref:
        jmake(2, devices=jax.devices()[:8], **kw)
    with pytest.raises(ValueError) as got:
        make_scene_mesh(2, world_size=8, rank=0, **kw)
    assert str(got.value) == str(ref.value)


def test_layout_mesh_has_no_collectives():
    """A mesh of 4 ranks built outside a process group of 4 is a layout:
    its collectives raise instead of skipping the reduction."""
    m = make_mesh(n_seed=1, n_data=4, world_size=4, rank=1)
    assert m.data_slice(8) == slice(2, 4)
    with pytest.raises(RuntimeError, match="layout only"):
        m.mean([torch.zeros(2)])


# ---------------------------------------------------------------------------
# the trainers' layout and validation against the JAX trainers'


def _tiny(**training):
    from dbw_torch.utils.config import load_yaml
    from dbw_torch.utils.path import CONFIGS_PATH

    cfg = load_yaml(CONFIGS_PATH / "synthetic" / "tiny.yml")
    cfg["training"].update(training)
    return cfg


VALIDATION_CASES = [
    (dict(n_spatial=3), [1, 2]), (dict(n_spatial=8), [1, 2, 3, 4, 5]),
    (dict(n_data=3), [1]), (dict(n_data=2), [1]), (dict(n_data=0), [1]),
    (dict(n_spatial=0), [1]), (dict(n_data=4, batch_size=6), [1]),
]


@pytest.mark.parametrize("kw,seeds", VALIDATION_CASES)
def test_protocol_validation_matches_jax(tmp_path, kw, seeds):
    """On 8 ranks the port's MultiSeedTrainer raises the JAX trainer's
    ValueError for the same invalid layout (batch_size 3 of tiny.yml:
    n_data=2 does not divide it)."""
    from dbw_tpu.train.multi_seed import MultiSeedTrainer as JaxMultiSeedTrainer
    from dbw_torch.train.multi_seed import MultiSeedTrainer

    kw = dict(kw)
    cfg = _tiny(**({"batch_size": kw.pop("batch_size")} if "batch_size" in kw else {}))
    with pytest.raises(ValueError) as ref:
        JaxMultiSeedTrainer(copy.deepcopy(cfg), tmp_path / "jax", seeds, **kw)
    with pytest.raises(ValueError) as got:
        MultiSeedTrainer(copy.deepcopy(cfg), tmp_path / "port", seeds, device="cpu",
                         world_size=8, **kw)
    assert str(got.value) == str(ref.value)
    assert not (tmp_path / "port").exists()


@pytest.mark.parametrize("seeds,kw,batch_size", [
    ([1, 2], {}, 3), ([1, 2], {}, 4), ([1, 2, 3, 4, 5], {}, 4), ([7], dict(n_data=4), 4),
    ([7], dict(n_spatial=4), 3), ([7], dict(n_data=2, n_spatial=2), 4),
    ([1, 2, 3], dict(n_spatial=2), 4)])
def test_protocol_layout_matches_jax(tmp_path, seeds, kw, batch_size):
    """The mesh and the padded seed slots of the JAX trainer on 8 devices:
    the automatic layout (its fall-back to all seeds when the batch does
    not divide the data axis) and the explicit ones."""
    from dbw_tpu.train.multi_seed import MultiSeedTrainer as JaxMultiSeedTrainer
    from dbw_torch.train.multi_seed import seed_layout

    cfg = _tiny(batch_size=batch_size)
    j = JaxMultiSeedTrainer(copy.deepcopy(cfg), tmp_path, seeds, **kw)
    seed_ax, n_data, n_sp, slots = seed_layout(8, len(seeds), batch_size, **kw)
    assert dict(j._mesh.shape) == {"seed": seed_ax, "data": n_data,
                                   **({"sp": n_sp} if n_sp > 1 else {})}
    assert len(j.seeds) == slots and j.n_valid == len(seeds)


def test_one_rank_validation_matches_jax_messages():
    """On one rank the JAX trainer's one-device messages."""
    from dbw_torch.train.multi_seed import seed_layout

    with pytest.raises(ValueError, match="^n_data=2 requested but only 1 device present$"):
        seed_layout(1, 2, 4, n_data=2)
    with pytest.raises(ValueError, match="^n_spatial=2 requested but only 1 device present$"):
        seed_layout(1, 2, 4, n_spatial=2)
    assert seed_layout(1, 2, 4, n_data=1, n_spatial=1) == (1, 1, 1, 2)


@pytest.mark.parametrize("n_dev,n_scene,n_seeds,batch_size,n_data", [
    (8, 2, 1, 4, None), (8, 2, 2, 4, None), (8, 2, 3, 4, None), (8, 2, 1, 3, None),
    (8, 4, 1, 4, None), (8, 2, 1, 4, 2), (8, 2, 2, 2, 2)])
def test_scene_layout_matches_jax(tmp_path, n_dev, n_scene, n_seeds, batch_size, n_data):
    """The JAX multi-scene trainer's choice of the data axis and its padded
    seed slots on 8 devices."""
    from dbw_tpu.train.multi_scene import MultiSceneTrainer as JaxMultiSceneTrainer
    from dbw_torch.train.multi_scene import scene_layout

    cfgs = []
    for k in range(n_scene):
        cfg = _tiny(batch_size=batch_size, seed=10 + k)
        cfg["dataset"]["tag"] = f"s{k}"
        cfgs.append(cfg)
    j = JaxMultiSceneTrainer(copy.deepcopy(cfgs), [tmp_path / f"s{k}" for k in range(n_scene)],
                             n_seeds=n_seeds, n_data=n_data)
    nd, seed_ax = scene_layout(n_dev // n_scene, n_seeds, batch_size, n_data)
    assert dict(j._mesh.shape) == {"scene": n_scene, "seed": seed_ax, "data": nd}
    assert j.S == -(-n_seeds // seed_ax) * seed_ax


def test_scene_layout_error_matches_jax(tmp_path):
    from dbw_tpu.train.multi_scene import MultiSceneTrainer as JaxMultiSceneTrainer
    from dbw_torch.train.multi_scene import scene_layout

    cfgs = [_tiny(batch_size=4, seed=10 + k) for k in range(2)]
    with pytest.raises(ValueError) as ref:
        JaxMultiSceneTrainer(cfgs, [tmp_path / "a", tmp_path / "b"], n_data=3)
    with pytest.raises(ValueError) as got:
        scene_layout(4, 1, 4, n_data=3)
    assert str(got.value) == str(ref.value)


# ---------------------------------------------------------------------------
# the collectives on ranks


H_BAND, W_BAND = 10, 6


def _band_target(shape):
    return torch.from_numpy(np.random.default_rng(5).random(shape).astype(np.float32))


def band_gather_rank(rank, n_sp):
    """Rank ``rank`` of a (seed=1, data=1, sp=n_sp) mesh: its band of a
    known image through band_gather, and the gradient of a weighted sum
    of the gathered image."""
    from dbw_torch.parallel.seeds import band_gather

    mesh = make_mesh(n_seed=1, n_data=1, n_spatial=n_sp)
    axis = mesh.axis("sp")
    Hb = -(-H_BAND // n_sp)
    full = torch.arange(2 * n_sp * Hb * W_BAND * 3, dtype=torch.float32).reshape(
        2, n_sp * Hb, W_BAND, 3)
    band = full[:, axis.index * Hb:(axis.index + 1) * Hb].clone().requires_grad_(True)
    img = band_gather(band, axis, H_BAND)
    (img * _band_target(img.shape)).sum().backward()
    return img.detach(), band.grad, mesh.coords


@pytest.mark.parametrize("n_sp", [2, 3])
def test_band_gather_and_its_transpose(tmp_path, n_sp):
    """The gathered image is the full image's first H rows on every rank
    (the last band overhangs H when n_sp does not divide it); each band's
    gradient is n_sp times its rows of the weights (the cotangent summed
    over the axis, JAX's psum_scatter), zero on the overhang."""
    outs = spawn_ranks(tmp_path, n_sp, band_gather_rank, n_sp)
    Hb = -(-H_BAND // n_sp)
    full = torch.arange(2 * n_sp * Hb * W_BAND * 3, dtype=torch.float32).reshape(
        2, n_sp * Hb, W_BAND, 3)
    w = _band_target((2, H_BAND, W_BAND, 3))
    w_pad = torch.cat([w, torch.zeros(2, n_sp * Hb - H_BAND, W_BAND, 3)], dim=1)
    for k, (img, grad, coords) in enumerate(outs):
        assert coords == {"seed": 0, "data": 0, "sp": k}
        assert torch.equal(img, full[:, :H_BAND])
        torch.testing.assert_close(grad, n_sp * w_pad[:, k * Hb:(k + 1) * Hb])


def mean_gather_rank(rank):
    """A (seed=2, data=2) mesh: mean over the seed column, gather over the
    seed axis, selection over every slot, and the backend of the group."""
    import torch.distributed as dist

    from dbw_torch.parallel.seeds import MultiSeedRunner

    mesh = make_mesh(n_seed=2, n_data=2)
    a = torch.full((3,), float(rank))
    b = torch.full((2, 2), 10.0 * rank)
    mesh.mean([a, b])
    g = mesh.gather(torch.tensor([[float(rank)]]))
    # selection over both seed columns' slots: rank r holds slots 2s, 2s+1
    s = mesh.coords["seed"]
    runner = MultiSeedRunner(None, None, mesh)
    best = runner.select_best({"p": torch.tensor([10.0 * s, 10.0 * s + 1])},
                              torch.tensor([0.5 - 0.2 * s, 0.4 - 0.2 * s]), n_valid=3)
    return (a, b, g, mesh.coords, mesh.axis("reduce").ranks, mesh.axis("gather").ranks,
            dist.get_backend(), best)


def test_mean_and_gather_over_axes(tmp_path):
    """Rank r at (r // 2, r % 2): the column {2s, 2s+1} averages, the seed
    axis {d, d+2} gathers in rank order; selection sees the 4 slots' losses
    (0.5, 0.4, 0.3, 0.2), the last one padded: slot 2 and its parameter on
    every rank; gloo on the CPU."""
    outs = spawn_ranks(tmp_path, 4, mean_gather_rank)
    for r, (a, b, g, coords, red, gat, backend, best) in enumerate(outs):
        s, d = divmod(r, 2)
        assert coords == {"seed": s, "data": d}
        assert red == [2 * s, 2 * s + 1] and gat == [d, d + 2]
        assert torch.equal(a, torch.full((3,), 2 * s + 0.5))
        assert torch.equal(b, torch.full((2, 2), 10.0 * (2 * s + 0.5)))
        assert torch.equal(g, torch.tensor([[float(d)], [float(d + 2)]]))
        assert backend == "gloo"
        params, k = best
        assert k == 2 and float(params["p"]) == 10.0


def test_init_distributed_needs_a_card_unless_cpu():
    """No fall-back to the CPU: a CUDA device with no card raises before
    any group is joined."""
    from dbw_torch.parallel.mesh import init_distributed, world

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_distributed("cuda", rank=0, world_size=2)
    assert world() == (0, 1)
    assert init_distributed("cpu", rank=0, world_size=1) == torch.device("cpu")
