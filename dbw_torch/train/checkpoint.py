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


def adam_state_to_jax(optimizer, params: dict) -> ScaleByAdamState:
    """torch Adam state of ``params`` ({name: leaf}) -> optax's layout."""
    mu, nu, steps = {}, {}, set()
    for k in PARAM_NAMES:
        p = params[k]
        st = optimizer.state.get(p, {})
        zero = np.zeros(tuple(p.shape), np.float32)
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


def save_checkpoint(path, params: dict, optimizer, epoch, batch,
                    model_name="dbw", model_kwargs=None):
    """Write ``model.pkl``; ``optimizer`` may be None (no optimizer state)."""
    state = {
        "epoch": int(epoch),
        "batch": int(batch),
        "model_name": model_name,
        "model_kwargs": model_kwargs or {},
        "model_state": scene_params_to_numpy(params),
        "optimizer_state": (None if optimizer is None
                            else adam_state_to_jax(optimizer, params)),
    }
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        _Pickler(f, protocol=pickle.HIGHEST_PROTOCOL).dump(state)
    return path


def load_checkpoint(path):
    """Read ``model.pkl`` (written here or by the JAX package). Returns the
    dict with ``model_state`` as {name: numpy array} (the reference's
    ``spq_`` prefix renamed to ``sq_``)."""
    with open(path, "rb") as f:
        state = _Unpickler(f).load()
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
