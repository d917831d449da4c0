"""``model.pkl`` checkpoints in the JAX package's layout, both ways
(PyTorch port of dbw_tpu/train/checkpoint.py).

The file is one pickle of
``{epoch, batch, model_name, model_kwargs, model_state, optimizer_state}``:
``model_state`` maps the ``SceneParams`` field names to float32 numpy
arrays, and ``optimizer_state`` is optax's ``ScaleByAdamState(count, mu,
nu)`` with ``mu`` and ``nu`` as ``dbw_tpu.models.dbw.SceneParams`` of numpy
arrays. Those two classes live in packages that import JAX, so this module
never imports them: the reader maps their pickled references to the local
stand-ins below, and the writer emits the same references by name. A file
written here loads with ``dbw_tpu.train.checkpoint.load_checkpoint`` and
resumes a JAX run; a JAX-written file loads here without importing JAX.

Adam's state maps leaf by leaf: ``count`` <-> each parameter's ``step``,
``mu`` <-> ``exp_avg``, ``nu`` <-> ``exp_avg_sq``.
"""

from __future__ import annotations

import pickle
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from ..convert import scene_params_to_numpy
from ..models.dbw import PARAM_NAMES
from ..utils.device import DEFAULT_DEVICE

SceneParams = NamedTuple("SceneParams", [(k, object) for k in PARAM_NAMES])


class ScaleByAdamState(NamedTuple):
    count: object
    mu: object
    nu: object


# local stand-in -> (module, qualified name) of the class the JAX side pickles
_JAX_CLASSES = {
    SceneParams: ("dbw_tpu.models.dbw", "SceneParams"),
    ScaleByAdamState: ("optax._src.transform", "ScaleByAdamState"),
}
_FOREIGN = ("jax", "jaxlib", "optax", "dbw_tpu")


class _Pickler(pickle._Pickler):
    """Writes the stand-in classes as references to the JAX side's classes,
    without importing them (the C pickler would import them to check)."""

    def save_global(self, obj, name=None):
        ref = _JAX_CLASSES.get(obj)
        if ref is None:
            return super().save_global(obj, name)
        module, qualname = ref
        self.save(module)
        self.save(qualname)
        self.write(pickle.STACK_GLOBAL)
        self.memoize(obj)


class _Unpickler(pickle.Unpickler):
    """Reads the JAX side's SceneParams and ScaleByAdamState as the local
    stand-ins and refuses any other class of a JAX package."""

    def find_class(self, module, name):
        if module == "dbw_tpu.models.dbw" and name == "SceneParams":
            return SceneParams
        if module.split(".")[0] == "optax" and name == "ScaleByAdamState":
            return ScaleByAdamState
        if module.split(".")[0] in _FOREIGN:
            raise pickle.UnpicklingError(
                f"checkpoint needs {module}.{name}, which the port cannot load")
        return super().find_class(module, name)


def _adam_states_to_jax(states: dict, params: dict) -> ScaleByAdamState:
    """{name: torch Adam state of the leaf} -> optax's layout (a leaf with
    no state yet gets zeros at step 0)."""
    mu, nu, steps = {}, {}, set()
    for k in PARAM_NAMES:
        st = states[k]
        zero = np.zeros(tuple(params[k].shape), np.float32)
        steps.add(int(st["step"]) if "step" in st else 0)
        mu[k] = st["exp_avg"].detach().cpu().numpy() if "exp_avg" in st else zero
        nu[k] = (st["exp_avg_sq"].detach().cpu().numpy() if "exp_avg_sq" in st
                 else zero.copy())
    if len(steps) != 1:
        raise ValueError(f"parameters at different Adam steps: {sorted(steps)}")
    return ScaleByAdamState(np.asarray(steps.pop(), np.int32),
                            SceneParams(**mu), SceneParams(**nu))


def adam_state_from_jax(state: ScaleByAdamState, optimizer, params: dict):
    """Install optax's Adam state into ``optimizer`` for ``params``."""
    count = float(np.asarray(state.count))
    for k in PARAM_NAMES:
        p = params[k]
        optimizer.state[p] = {
            "step": torch.tensor(count, dtype=torch.float32),
            "exp_avg": torch.as_tensor(
                np.asarray(getattr(state.mu, k), np.float32), device=p.device).clone(),
            "exp_avg_sq": torch.as_tensor(
                np.asarray(getattr(state.nu, k), np.float32), device=p.device).clone(),
        }


def snapshot(params: dict, optimizer=None):
    """A detached copy (on the parameters' device) of the parameters and of
    ``optimizer``'s Adam state, for ``write_snapshot`` to write later while
    training goes on."""
    with torch.no_grad():
        copy = {k: params[k].detach().clone() for k in PARAM_NAMES}
        states = None
        if optimizer is not None:
            states = {k: {f: v.detach().clone() if torch.is_tensor(v) else v
                          for f, v in optimizer.state.get(params[k], {}).items()}
                      for k in PARAM_NAMES}
    return copy, states


def write_snapshot(path, snap, epoch, batch, model_name="dbw", model_kwargs=None):
    """Write ``model.pkl`` from a ``snapshot``."""
    copy, states = snap
    state = {
        "epoch": int(epoch),
        "batch": int(batch),
        "model_name": model_name,
        "model_kwargs": model_kwargs or {},
        "model_state": scene_params_to_numpy(copy),
        "optimizer_state": (None if states is None
                            else _adam_states_to_jax(states, copy)),
    }
    return write_pickle(path, state)


def save_checkpoint(path, params: dict, optimizer, epoch, batch,
                    model_name="dbw", model_kwargs=None):
    """Write ``model.pkl``; ``optimizer`` may be None (no optimizer state)."""
    return write_snapshot(path, snapshot(params, optimizer), epoch, batch,
                          model_name=model_name, model_kwargs=model_kwargs)


def load_checkpoint(path):
    """Read ``model.pkl`` (written here or by the JAX package). Returns the
    dict with ``model_state`` as {name: numpy array} (the reference's
    ``spq_`` prefix renamed to ``sq_``)."""
    state = read_pickle(path)
    ms = state["model_state"]
    ms = ms._asdict() if isinstance(ms, SceneParams) else dict(ms)
    state["model_state"] = {k.replace("spq_", "sq_"): v for k, v in ms.items()}
    return state


def restore(state, params: dict, optimizer=None):
    """Copy a loaded checkpoint's parameters into ``params`` (in place) and,
    with ``optimizer`` and a stored optimizer state, its Adam state."""
    with torch.no_grad():
        for k in PARAM_NAMES:
            params[k].copy_(torch.as_tensor(
                np.asarray(state["model_state"][k], np.float32)))
    if optimizer is not None and state.get("optimizer_state") is not None:
        adam_state_from_jax(state["optimizer_state"], optimizer, params)


def stacked_to_jax(snap, lead_shape):
    """A ``snapshot`` of stacked leaves (lead_shape + the leaf's shape) ->
    (params, opt_state) in the JAX protocol checkpoints' layout: a
    SceneParams of stacked arrays and a ScaleByAdamState whose ``count``
    has the shape ``lead_shape`` (every slot at the same step)."""
    copy, states = snap
    params = SceneParams(**scene_params_to_numpy(copy))
    adam = _adam_states_to_jax(states, copy)
    count = np.full(tuple(lead_shape), int(adam.count), np.int32)
    return params, adam._replace(count=count)


def restore_stacked(params_state, opt_state, params: dict, optimizer):
    """Copy a protocol checkpoint's stacked params (a SceneParams or dict
    of arrays) and its Adam state (``count`` of the stacked shape, equal in
    every slot) into ``params`` and ``optimizer``."""
    ms = params_state._asdict() if isinstance(params_state, SceneParams) else params_state
    counts = np.unique(np.asarray(opt_state.count))
    if len(counts) != 1:
        raise ValueError(f"slots at different Adam steps: {counts.tolist()}")
    restore({"model_state": ms, "optimizer_state": ScaleByAdamState(
        counts[0], opt_state.mu, opt_state.nu)}, params, optimizer)


def write_pickle(path, state):
    """Pickle ``state`` (the JAX side's class references for the stand-ins)
    to ``path`` through a temporary file."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + ".tmp")
    with open(tmp, "wb") as f:
        _Pickler(f, protocol=pickle.HIGHEST_PROTOCOL).dump(state)
    tmp.replace(path)  # a reader never sees a half-written file
    return path


def read_pickle(path):
    """Read a pickle written here or by the JAX package, without JAX."""
    with open(path, "rb") as f:
        return _Unpickler(f).load()


def load_model_from_checkpoint(path, img_size, device=DEFAULT_DEVICE, **overrides):
    """Rebuild (model, params, checkpoint) from a ``model.pkl``'s saved
    model_kwargs (with ``overrides``) on ``device``; the image size comes
    from the dataset, not from the kwargs."""
    from ..convert import scene_params_from_numpy
    from ..models.dbw import BlocksWorld

    state = load_checkpoint(path)
    kwargs = dict(state.get("model_kwargs") or {})
    kwargs.update(overrides)
    name = kwargs.pop("name", state.get("model_name", "dbw"))
    if name != "dbw":
        raise NotImplementedError(f"model {name!r} is not ported")
    kwargs.pop("img_size", None)
    model = BlocksWorld(img_size, device=device, **kwargs)
    params = scene_params_from_numpy(state["model_state"], model.device)
    return model, params, state
