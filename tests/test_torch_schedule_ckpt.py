"""LR schedules and ``model.pkl`` checkpoints of the port against the JAX
package: every scheduler's per-group LRs, a JAX-written checkpoint resumed
in the port, and a port-written checkpoint resumed in the JAX package."""

import copy

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from dbw_tpu.models.dbw import BlocksWorld as JaxBlocksWorld
from dbw_tpu.models.dbw import SceneParams as JaxSceneParams
from dbw_tpu.train.checkpoint import load_checkpoint as jax_load_checkpoint
from dbw_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from dbw_tpu.train.optimizer import create_optimizer as jax_create_optimizer
from dbw_tpu.train.scheduler import create_scheduler as jax_create_scheduler
from dbw_torch.convert import scene_params_from_numpy, scene_params_to_numpy
from dbw_torch.models.dbw import PARAM_NAMES
from dbw_torch.train import checkpoint as ck
from dbw_torch.train.optimizer import create_optimizer
from dbw_torch.train.scheduler import base_lrs, create_scheduler, set_lrs

CFG = dict(mesh=dict(n_blocks=2, txt_size=16, T_range=[0.3, 0.3, 0.3]),
           renderer=dict(faces_per_pixel=2, detach_bary=True),
           rend_optim=dict(decouple_rendering=True))
TRAIN = {"optimizer": {"name": "adam", "lr": 5e-3, "texture": {"lr": 5e-2}}}
LRS = {"main": 5e-3, "texture": 5e-2}
SCHEDULES = [
    {"name": "multi_step", "gamma": [0.1, 0.1], "milestones": [1700]},
    {"name": "multi_step", "gamma": [0.5, 0.2], "milestones": [3, 7, 7, 11],
     "warmup": 4},
    {"name": "multi_step", "gamma": 0.3, "milestones": [2]},
    {"name": "cosine_annealing", "T_max": 9, "eta_min": 1e-4},
    {"name": "exponential", "gamma": 0.9},
]


@pytest.mark.parametrize("sched", SCHEDULES, ids=lambda s: s["name"])
def test_schedulers_match_jax(sched):
    cfg = {"training": {**TRAIN, "scheduler": copy.deepcopy(sched)}}
    opt = create_optimizer(cfg, _torch_params())
    ts = create_scheduler(cfg, base_lrs(opt))
    js = jax_create_scheduler(copy.deepcopy(cfg), LRS)
    for epoch in [*range(15), 1699, 1700, 1799]:
        assert ts.lrs(epoch) == pytest.approx(js.lrs(epoch), rel=1e-12), epoch
        set_lrs(opt, ts.lrs(epoch))
        assert {g["name"]: g["lr"] for g in opt.param_groups} == ts.lrs(epoch)


def _torch_params(seed=0):
    m = JaxBlocksWorld((8, 8), backend="xla", **copy.deepcopy(CFG))
    return scene_params_from_numpy(jax.tree_util.tree_map(
        np.asarray, m.init_params(seed))._asdict())


def _grads(seed):
    """A seeded gradient for every leaf, as numpy."""
    rng = np.random.default_rng(seed)
    p = scene_params_to_numpy(_torch_params())
    return {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in p.items()}


def _jax_steps(params, state, opt, grads_list):
    for g in grads_list:
        updates, state = opt.update(JaxSceneParams(**{k: jnp.asarray(v) for k, v in g.items()}),
                                    state, {k: jnp.float32(v) for k, v in LRS.items()})
        params = jax.tree_util.tree_map(lambda a, u: a + u, params, updates)
    return params, state


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """Two JAX Adam steps from the model's init, saved as model.pkl."""
    cfg = {"training": TRAIN}
    m = JaxBlocksWorld((8, 8), backend="xla", **copy.deepcopy(CFG))
    params = m.init_params(0)
    opt = jax_create_optimizer(cfg, params)
    params, state = _jax_steps(params, opt.init(params), opt, [_grads(1), _grads(2)])
    path = tmp_path_factory.mktemp("jax") / "model.pkl"
    jax_save_checkpoint(path, params, state, epoch=3, batch=7, model_kwargs=CFG)
    return path, params, state, opt


def test_jax_checkpoint_loads_into_the_port(jax_run):
    path, jparams, jstate, _ = jax_run
    state = ck.load_checkpoint(path)
    assert (state["epoch"], state["batch"], state["model_name"]) == (3, 7, "dbw")
    assert state["model_kwargs"] == CFG
    params = _torch_params(seed=5)
    opt = create_optimizer({"training": TRAIN}, params)
    ck.restore(state, params, opt)
    for k in PARAM_NAMES:
        np.testing.assert_array_equal(params[k].detach().numpy(),
                                      np.asarray(getattr(jparams, k)))
        st = opt.state[params[k]]
        assert float(st["step"]) == 2 == int(jstate.count)
        np.testing.assert_array_equal(st["exp_avg"].numpy(), np.asarray(getattr(jstate.mu, k)))
        np.testing.assert_array_equal(st["exp_avg_sq"].numpy(),
                                      np.asarray(getattr(jstate.nu, k)))
    # the next Adam step agrees with the JAX step: torch's Adam arranges the
    # bias corrections differently, so updates (~lr) agree to 2e-5 of the
    # texture lr (5e-2)
    g3 = _grads(3)
    for k, p in params.items():
        p.grad = torch.from_numpy(g3[k])
    opt.step()
    _, _, _, jopt = jax_run
    jp, _ = _jax_steps(jparams, jstate, jopt, [g3])
    for k in PARAM_NAMES:
        np.testing.assert_allclose(params[k].detach().numpy(), np.asarray(getattr(jp, k)),
                                   rtol=0, atol=1e-6, err_msg=k)


def test_port_checkpoint_resumes_in_jax(jax_run, tmp_path):
    """JAX-written file -> port -> port-written file -> JAX: the JAX step from
    the port's file equals the JAX step from the JAX package's own file."""
    path, _, _, jopt = jax_run
    params = _torch_params(seed=5)
    opt = create_optimizer({"training": TRAIN}, params)
    ck.restore(ck.load_checkpoint(path), params, opt)
    port_path = ck.save_checkpoint(tmp_path / "model.pkl", params, opt, epoch=3,
                                   batch=7, model_kwargs=CFG)
    a, b = jax_load_checkpoint(path), jax_load_checkpoint(port_path)
    for k in ("epoch", "batch", "model_name", "model_kwargs"):
        assert a[k] == b[k]
    assert type(b["optimizer_state"]) is type(a["optimizer_state"])
    assert type(b["optimizer_state"].mu) is JaxSceneParams
    assert (jax.tree_util.tree_structure(b["optimizer_state"])
            == jax.tree_util.tree_structure(a["optimizer_state"]))
    g = _grads(4)
    outs = []
    for st in (a, b):
        p, s = _jax_steps(jax.tree_util.tree_map(jnp.asarray, st["model_state"]),
                          jax.tree_util.tree_map(jnp.asarray, st["optimizer_state"]),
                          jopt, [g])
        outs.append((p, s))
    for x, y in zip(jax.tree_util.tree_leaves(outs[0]), jax.tree_util.tree_leaves(outs[1])):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_port_round_trip_after_torch_steps(tmp_path):
    params = _torch_params(seed=2)
    opt = create_optimizer({"training": TRAIN}, params)
    for s in (5, 6):
        for k, p in params.items():
            p.grad = torch.from_numpy(_grads(s)[k])
        opt.step()
    path = ck.save_checkpoint(tmp_path / "model.pkl", params, opt, 1, 2)
    p2 = _torch_params(seed=9)
    o2 = create_optimizer({"training": TRAIN}, p2)
    ck.restore(ck.load_checkpoint(path), p2, o2)
    for k in PARAM_NAMES:
        assert torch.equal(p2[k], params[k])
        for f in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(o2.state[p2[k]][f], opt.state[params[k]][f])
    # a checkpoint without optimizer state
    path = ck.save_checkpoint(tmp_path / "w.pkl", params, None, 0, 0)
    state = ck.load_checkpoint(path)
    assert state["optimizer_state"] is None and set(state["model_state"]) == set(PARAM_NAMES)


def test_reference_spq_prefix_is_renamed(tmp_path):
    import pickle

    ms = scene_params_to_numpy(_torch_params())
    ms["spq_eps"] = ms.pop("sq_eps")
    path = tmp_path / "ref.pkl"
    with open(path, "wb") as f:
        pickle.dump({"epoch": 1, "batch": 1, "model_state": ms,
                     "optimizer_state": None}, f)
    state = ck.load_checkpoint(path)
    assert set(state["model_state"]) == set(PARAM_NAMES)
    np.testing.assert_array_equal(state["model_state"]["sq_eps"], ms["spq_eps"])


def test_reader_refuses_other_jax_classes(tmp_path):
    import pickle

    path = tmp_path / "bad.pkl"
    with open(path, "wb") as f:
        pickle.dump({"model_state": {}, "x": jnp.zeros(2)}, f)
    with pytest.raises(pickle.UnpicklingError):
        ck.load_checkpoint(path)
