"""The loss registry and the optimizers of the PyTorch port against the JAX
package on the CPU: every RGB criterion of ``get_loss`` (value and gradient,
and as the model's ``criterion``), every optimizer's parameters after 3
steps against the optax transformation the JAX package builds (two
learning-rate groups), and ``model.pkl`` written by either package resuming
in the other with the next step reproduced."""

import copy

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from dbw_tpu.losses import get_loss as jax_get_loss
from dbw_tpu.models.dbw import BlocksWorld as JaxBlocksWorld
from dbw_tpu.models.dbw import SceneParams
from dbw_tpu.train import checkpoint as jck
from dbw_tpu.train.optimizer import _transform as jax_transform
from dbw_tpu.train.optimizer import create_optimizer as jax_create_optimizer
from dbw_tpu.train.optimizer import param_group_labels
from dbw_torch.losses import LOSSES, get_loss
from dbw_torch.models.dbw import PARAM_NAMES, BlocksWorld
from dbw_torch.train import checkpoint as ck
from dbw_torch.train.optimizer import create_optimizer

CRITERIA = ["bce", "mse", "l2", "l1", "huber", "perceptual", "lpips", "ssim"]
# per-step parameters after 3 steps: the ROADMAP's 3e-4 budget
PARAM_ATOL = 3e-4
OPTIMIZERS = {
    "sgd": {},
    "sgd_momentum": {"momentum": 0.9},
    "adamw": {"betas": (0.5, 0.6), "eps": 1e-3},  # both ignored, as by optax
    "adamax": {},
    "rmsprop": {},
    "adagrad": {},
    "adadelta": {},
}
SHAPES = {"sq_eps": (3, 2), "R_6d_ground": (1, 6), "T_ground": (1, 3), "S": (3, 3),
          "R_6d": (3, 6), "T": (3, 3), "alpha_logit": (3,),
          "texture_bkg": (1, 4, 4, 3), "texture_ground": (1, 4, 4, 3),
          "textures": (3, 4, 4, 3)}
LRS = {"main": 5e-3, "texture": 5e-2}


def _images(seed=3):
    rng = np.random.default_rng(seed)
    imgs = rng.random((2, 24, 32, 3), np.float32)
    rec = np.clip(imgs + 0.2 * rng.standard_normal(imgs.shape), 0, 1).astype(np.float32)
    return imgs, rec


def test_registry_names_match_jax():
    from dbw_tpu.losses import get_loss as jl

    names = set(LOSSES)
    assert names == {"bce", "mse", "l2", "l1", "huber", "perceptual", "lpips", "ssim",
                     "chamfer", "tv"}
    for n in names:  # every name resolves in both
        jl(n)
        get_loss(n, device="cpu")


@pytest.mark.parametrize("name", CRITERIA)
def test_criterion_matches_jax(name):
    """Value (the mean the model takes) and gradient in rec."""
    imgs, rec = _images()
    tl, jl = get_loss(name, device="cpu"), jax_get_loss(name)
    r = torch.tensor(rec, requires_grad=True)
    got = torch.mean(tl(torch.from_numpy(imgs), r))
    got.backward()
    got = got.detach()
    ref, jg = jax.value_and_grad(lambda x: jnp.mean(jl(jnp.asarray(imgs), x)))(
        jnp.asarray(rec))
    assert float(got) == pytest.approx(float(ref), rel=1e-4, abs=1e-7)
    jg = np.asarray(jg)
    np.testing.assert_allclose(r.grad.numpy(), jg, rtol=1e-3, atol=1e-4 * np.abs(jg).max())


MODEL_CFG = dict(mesh=dict(n_blocks=2, txt_size=8), renderer=dict(faces_per_pixel=2))


@pytest.mark.parametrize("name", CRITERIA)
def test_model_criterion_matches_jax(name):
    """The model's rgb loss term with ``loss.name`` set, on the same images."""
    imgs, rec = _images(5)
    loss = dict(rgb_weight=0.7, name=name)
    tm = BlocksWorld((24, 32), device="cpu", loss=loss, **copy.deepcopy(MODEL_CFG))
    jm = JaxBlocksWorld((24, 32), backend="xla", loss=dict(loss), **copy.deepcopy(MODEL_CFG))
    tp = tm.init_params(0)
    aux = {"alpha_full": torch.zeros(2)}
    got = tm.compute_losses(torch.from_numpy(imgs), torch.from_numpy(rec), tp,
                            tm.phase_for_epoch(0), aux)["rgb"]
    ref = jm.compute_losses(jnp.asarray(imgs), jnp.asarray(rec), jm.init_params(0),
                            jm.phase_for_epoch(0), {})["rgb"]
    assert float(got) == pytest.approx(float(ref), rel=1e-4, abs=1e-7)


@pytest.mark.parametrize("name,error", [("tv", TypeError), ("chamfer", ValueError)])
def test_unusable_criteria_fail_as_in_jax(name, error):
    """``tv`` takes one image and ``chamfer`` takes point clouds: as the
    model's criterion both fail at the first loss evaluation in both
    packages, with the same error type."""
    imgs, rec = _images()
    tm = BlocksWorld((24, 32), device="cpu", loss=dict(name=name), **copy.deepcopy(MODEL_CFG))
    jm = JaxBlocksWorld((24, 32), backend="xla", loss=dict(name=name),
                        **copy.deepcopy(MODEL_CFG))
    with pytest.raises(error):
        tm.compute_losses(torch.from_numpy(imgs), torch.from_numpy(rec), tm.init_params(0),
                          tm.phase_for_epoch(0), {"alpha_full": torch.zeros(2)})
    with pytest.raises(error):
        jm.compute_losses(jnp.asarray(imgs), jnp.asarray(rec), jm.init_params(0),
                          jm.phase_for_epoch(0), {})


def _opt_cfg(key):
    name = key.split("_")[0]
    return {"training": {"optimizer": {"name": name, "lr": LRS["main"],
                                       "texture": {"lr": LRS["texture"]},
                                       **OPTIMIZERS[key]}}}


class _JaxOpt:
    """The JAX package's optimizer: its optax transformation (built by
    ``_transform`` from the same config, as ``create_optimizer`` builds it)
    and the per-group step u * -lr. ``update`` passes the parameters to the
    transformation: ``create_optimizer(...).update`` does not, and adamw's
    ``add_decayed_weights`` raises without them."""

    def __init__(self, cfg, params):
        kw = dict(cfg["training"]["optimizer"])
        name = kw.pop("name")
        kw.pop("lr"), kw.pop("texture")
        self.tx = jax_transform(name, kw)
        self.labels = param_group_labels(params)

    def step(self, params, grads, state):
        upd, state = self.tx.update(grads, state, params)
        upd = jax.tree_util.tree_map(lambda u, lab: u * -jnp.float32(LRS[lab]),
                                     upd, self.labels)
        return jax.tree_util.tree_map(lambda a, u: a + u, params, upd), state


def _case(seed=8):
    rng = np.random.default_rng(seed)
    p0 = {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
             for _ in range(4)]
    grads[1]["T"][0] = 0.0  # a zero gradient row (adagrad's 0 where the sum is 0)
    return p0, grads


def _torch_steps(cfg, p0, grads):
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in p0.items()}
    opt = create_optimizer(cfg, tp)
    for g in grads:
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
    return tp, opt


def _jax_steps(cfg, p0, grads):
    jp = SceneParams(**{k: jnp.asarray(v) for k, v in p0.items()})
    jo = _JaxOpt(cfg, jp)
    state = jo.tx.init(jp)
    for g in grads:
        jp, state = jo.step(jp, SceneParams(**{k: jnp.asarray(v) for k, v in g.items()}),
                            state)
    return jp, state, jo


@pytest.mark.parametrize("key", list(OPTIMIZERS))
def test_optimizer_matches_optax(key):
    """3 steps of the port's optimizer against the optax transformation the
    JAX package builds, with its texture group; the JAX package's own
    ``create_optimizer`` gives the same steps wherever it can step (every
    rule but adamw)."""
    cfg = _opt_cfg(key)
    p0, grads = _case()
    tp, opt = _torch_steps(cfg, p0, grads[:3])
    assert [g["lr"] for g in opt.param_groups] == [LRS["main"], LRS["texture"]]
    jp, _, _ = _jax_steps(cfg, p0, grads[:3])
    for k in SHAPES:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(getattr(jp, k)),
                                   atol=PARAM_ATOL, rtol=0, err_msg=k)
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(getattr(jp, k)),
                                   atol=1e-5, rtol=1e-5, err_msg=k)
    if key != "adamw":
        jparams = SceneParams(**{k: jnp.asarray(v) for k, v in p0.items()})
        jopt = jax_create_optimizer(cfg, jparams)
        st = jopt.init(jparams)
        for g in grads[:3]:
            upd, st = jopt.update(SceneParams(**{k: jnp.asarray(v) for k, v in g.items()}),
                                  st, {n: jnp.float32(v) for n, v in LRS.items()})
            jparams = jax.tree_util.tree_map(lambda a, u: a + u, jparams, upd)
        for k in SHAPES:
            np.testing.assert_allclose(np.asarray(getattr(jparams, k)),
                                       np.asarray(getattr(jp, k)), atol=1e-7, err_msg=k)
    else:
        with pytest.raises(ValueError, match="params"):
            jopt = jax_create_optimizer(cfg, jp)
            jopt.update(jp, jopt.init(jp), {n: jnp.float32(v) for n, v in LRS.items()})


@pytest.mark.parametrize("key", list(OPTIMIZERS))
def test_checkpoint_resumes_both_ways(key, tmp_path):
    """After 3 steps, the port's ``model.pkl`` loads in the JAX package (its
    optimizer state in optax's layout) and the JAX package's loads in the
    port; each resumed side's 4th step equals the other's uninterrupted
    4th step."""
    cfg = _opt_cfg(key)
    p0, grads = _case()
    tp, opt = _torch_steps(cfg, p0, grads[:3])
    jp, jstate, jo = _jax_steps(cfg, p0, grads[:3])
    ck.save_checkpoint(tmp_path / "port.pkl", tp, opt, 1, 3)
    jck.save_checkpoint(tmp_path / "jax.pkl", jp, jstate, 1, 3)

    # the port's file in the JAX package: the same state structure, resumed
    st = jck.load_checkpoint(tmp_path / "port.pkl")
    assert (jax.tree_util.tree_structure(st["optimizer_state"])
            == jax.tree_util.tree_structure(jax.tree_util.tree_map(np.asarray, jstate)))
    g4 = SceneParams(**{k: jnp.asarray(v) for k, v in grads[3].items()})
    jres, _ = jo.step(jax.tree_util.tree_map(jnp.asarray, st["model_state"]), g4,
                      jax.tree_util.tree_map(jnp.asarray, st["optimizer_state"]))
    jfull, _ = jo.step(jp, g4, jstate)

    # the JAX package's file in the port, resumed
    state = ck.load_checkpoint(tmp_path / "jax.pkl")
    tq = {k: torch.zeros(s, requires_grad=True) for k, s in SHAPES.items()}
    topt = create_optimizer(cfg, tq)
    ck.restore(state, tq, topt)
    tfull, _ = _torch_steps(cfg, p0, grads)
    for k, p in tq.items():
        p.grad = torch.from_numpy(grads[3][k])
    topt.step()
    for k in SHAPES:
        np.testing.assert_allclose(np.asarray(getattr(jres, k)), np.asarray(getattr(jfull, k)),
                                   atol=1e-6, err_msg=k)
        np.testing.assert_allclose(tq[k].detach().numpy(), np.asarray(getattr(jfull, k)),
                                   atol=1e-5, rtol=1e-5, err_msg=k)
    # the port's own file resumes bitwise in the port
    tr = {k: torch.zeros(s, requires_grad=True) for k, s in SHAPES.items()}
    ropt = create_optimizer(cfg, tr)
    ck.restore(ck.load_checkpoint(tmp_path / "port.pkl"), tr, ropt)
    for k, p in tr.items():
        p.grad = torch.from_numpy(grads[3][k])
    ropt.step()
    for k in SHAPES:
        np.testing.assert_array_equal(tr[k].detach().numpy(), tfull[k].detach().numpy(),
                                      err_msg=k)


def test_unknown_optimizer_fails_as_in_jax():
    tp = {k: torch.zeros(s, requires_grad=True) for k, s in SHAPES.items()}
    jp = SceneParams(**{k: jnp.zeros(s) for k, s in SHAPES.items()})
    for make, p in ((create_optimizer, tp), (jax_create_optimizer, jp)):
        with pytest.raises(KeyError):
            make({"training": {"optimizer": {"name": "lbfgs"}}}, p)
    assert set(PARAM_NAMES) == set(SHAPES)
