"""``model.pkl`` checkpoints in the JAX package's layout, both ways
(PyTorch port of dbw_tpu/train/checkpoint.py).

The file is one pickle of
``{epoch, batch, model_name, model_kwargs, model_state, optimizer_state}``:
``model_state`` maps the ``SceneParams`` field names to float32 numpy
arrays, and ``optimizer_state`` is the state of the optax transformation of
the configured optimizer, its trees ``dbw_tpu.models.dbw.SceneParams`` of
numpy arrays:

- adam, adamax: ``ScaleByAdamState(count, mu, nu)``;
- adamw: the chain's tuple ``(ScaleByAdamState, EmptyState())``;
- sgd: ``TraceState(trace)`` with momentum, ``EmptyState()`` without;
- rmsprop: ``ScaleByRmsState(nu)``; adagrad: ``ScaleByRssState(
  sum_of_squares)``; adadelta: ``ScaleByAdaDeltaState(e_g, e_x)``.

Those classes live in packages that import JAX, so this module never
imports them: the reader maps their pickled references to the local
stand-ins below, and the writer emits the same references by name. A file
written here loads with ``dbw_tpu.train.checkpoint.load_checkpoint`` and
resumes a JAX run; a JAX-written file loads here without importing JAX.

torch Adam's state maps leaf by leaf: ``count`` <-> each parameter's
``step``, ``mu`` <-> ``exp_avg``, ``nu`` <-> ``exp_avg_sq``; the other
optimizers (``train/optimizer.py``) keep optax's field names per leaf.
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
from .optimizer import optimizer_name

SceneParams = NamedTuple("SceneParams", [(k, object) for k in PARAM_NAMES])


class ScaleByAdamState(NamedTuple):
    count: object
    mu: object
    nu: object


class EmptyState(NamedTuple):
    pass


class TraceState(NamedTuple):
    trace: object


class ScaleByRmsState(NamedTuple):
    nu: object


class ScaleByRssState(NamedTuple):
    sum_of_squares: object


class ScaleByAdaDeltaState(NamedTuple):
    e_g: object
    e_x: object


# local stand-in -> (module, qualified name) of the class the JAX side
# pickles (optax 0.2.6's modules)
_JAX_CLASSES = {
    SceneParams: ("dbw_tpu.models.dbw", "SceneParams"),
    ScaleByAdamState: ("optax._src.transform", "ScaleByAdamState"),
    EmptyState: ("optax._src.base", "EmptyState"),
    TraceState: ("optax.transforms._accumulation", "TraceState"),
    ScaleByRmsState: ("optax._src.transform", "ScaleByRmsState"),
    ScaleByRssState: ("optax._src.transform", "ScaleByRssState"),
    ScaleByAdaDeltaState: ("optax._src.transform", "ScaleByAdaDeltaState"),
}
_OPTAX_BY_NAME = {qual: cls for cls, (mod, qual) in _JAX_CLASSES.items()
                  if mod.startswith("optax")}
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
    """Reads the JAX side's SceneParams and optax states as the local
    stand-ins (an optax state by its class name, wherever optax keeps it)
    and refuses any other class of a JAX package."""

    def find_class(self, module, name):
        if module == "dbw_tpu.models.dbw" and name == "SceneParams":
            return SceneParams
        if module.split(".")[0] == "optax" and name in _OPTAX_BY_NAME:
            return _OPTAX_BY_NAME[name]
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


def _rule_state_to_jax(rule, states: dict):
    """{name: per-leaf state of an optax rule (``train/optimizer.py``)} ->
    the optax transformation's state."""
    trees = {f: SceneParams(**{k: states[k][f].detach().cpu().numpy()
                               for k in PARAM_NAMES})
             for f in next(iter(states.values())) if f != "count"}
    counts = {int(st["count"]) for st in states.values() if "count" in st}
    if len(counts) > 1:
        raise ValueError(f"parameters at different steps: {sorted(counts)}")
    count = np.asarray(counts.pop() if counts else 0, np.int32)
    if rule in ("adamax", "adamw"):
        adam = ScaleByAdamState(count, trees["mu"], trees["nu"])
        return (adam, EmptyState()) if rule == "adamw" else adam
    if rule == "sgd":
        return TraceState(trees["trace"]) if "trace" in trees else EmptyState()
    return {"rmsprop": ScaleByRmsState, "adagrad": ScaleByRssState,
            "adadelta": ScaleByAdaDeltaState}[rule](**trees)


def _rule_state_from_jax(state, optimizer, params: dict):
    """Install an optax transformation's state into the rule ``optimizer``."""
    if isinstance(state, tuple) and not hasattr(state, "_fields"):
        state = state[0]  # adamw's chain: (ScaleByAdamState, EmptyState)
    trees = {f: getattr(state, f) for f in state._fields if f != "count"}
    for k in PARAM_NAMES:
        p = params[k]
        st = {f: torch.as_tensor(np.asarray(getattr(t, k), np.float32),
                                 device=p.device).clone() for f, t in trees.items()}
        if "count" in state._fields:
            st["count"] = int(np.asarray(state.count))
        optimizer.state[p] = st


def optimizer_state_to_jax(rule, states: dict, params: dict):
    """Per-leaf optimizer states (a ``snapshot``'s) -> the JAX layout."""
    if rule == "adam":
        return _adam_states_to_jax(states, params)
    return _rule_state_to_jax(rule, states)


def optimizer_state_from_jax(state, optimizer, params: dict):
    """Install a JAX-layout optimizer state into ``optimizer``."""
    if optimizer_name(optimizer) == "adam":
        adam_state_from_jax(state, optimizer, params)
    else:
        _rule_state_from_jax(state, optimizer, params)


def snapshot(params: dict, optimizer=None):
    """A detached copy (on the parameters' device) of the parameters and of
    ``optimizer``'s per-leaf state, and the optimizer's name, for
    ``write_snapshot`` to write later while training goes on."""
    with torch.no_grad():
        copy = {k: params[k].detach().clone() for k in PARAM_NAMES}
        states = None
        if optimizer is not None:
            init = getattr(optimizer, "init_state", lambda p: {})
            states = {k: {f: v.detach().clone() if torch.is_tensor(v) else v
                          for f, v in (optimizer.state.get(params[k])
                                       or init(params[k])).items()}
                      for k in PARAM_NAMES}
    return copy, states, None if optimizer is None else optimizer_name(optimizer)


def write_snapshot(path, snap, epoch, batch, model_name="dbw", model_kwargs=None):
    """Write ``model.pkl`` from a ``snapshot``."""
    copy, states, rule = snap
    state = {
        "epoch": int(epoch),
        "batch": int(batch),
        "model_name": model_name,
        "model_kwargs": model_kwargs or {},
        "model_state": scene_params_to_numpy(copy),
        "optimizer_state": (None if states is None
                            else optimizer_state_to_jax(rule, states, copy)),
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
    with ``optimizer`` and a stored optimizer state, its optimizer state."""
    with torch.no_grad():
        for k in PARAM_NAMES:
            params[k].copy_(torch.as_tensor(
                np.asarray(state["model_state"][k], np.float32)))
    if optimizer is not None and state.get("optimizer_state") is not None:
        optimizer_state_from_jax(state["optimizer_state"], optimizer, params)


def _map_count(state, fn):
    """The optimizer state with its step ``count`` (where it has one,
    adamw's inside the chain's tuple) replaced by fn(count)."""
    if isinstance(state, tuple) and not hasattr(state, "_fields"):
        return tuple(_map_count(s, fn) for s in state)
    if "count" in getattr(state, "_fields", ()):
        return state._replace(count=fn(state.count))
    return state


def stacked_to_jax(snap, lead_shape):
    """A ``snapshot`` of stacked leaves (lead_shape + the leaf's shape) ->
    (params, opt_state) in the JAX protocol checkpoints' layout: a
    SceneParams of stacked arrays and the optimizer state, its ``count``
    (where it has one) of the shape ``lead_shape`` (every slot at the same
    step)."""
    copy, states, rule = snap
    params = SceneParams(**scene_params_to_numpy(copy))
    opt_state = optimizer_state_to_jax(rule, states, copy)
    return params, _map_count(
        opt_state, lambda c: np.full(tuple(lead_shape), int(c), np.int32))


def _index_slots(tree, slots):
    """``tree`` (tuples, NamedTuples, dicts of arrays) with every array
    indexed by ``slots`` on its leading (stacked) axes."""
    if isinstance(tree, dict):
        return {k: _index_slots(v, slots) for k, v in tree.items()}
    if isinstance(tree, tuple):
        vals = [_index_slots(v, slots) for v in tree]
        return type(tree)(*vals) if hasattr(tree, "_fields") else tuple(vals)
    if np.ndim(tree):
        return np.asarray(tree)[slots]
    return tree


def restore_stacked(params_state, opt_state, params: dict, optimizer, slots=slice(None)):
    """Copy a protocol checkpoint's stacked params (a SceneParams or dict
    of arrays) and its optimizer state (``count`` of the stacked shape,
    equal in every slot) into ``params`` and ``optimizer``: the stacked
    slots ``slots`` of the file (an index into its leading axes; a rank of
    a mesh takes its own), all of them by default."""
    ms = params_state._asdict() if isinstance(params_state, SceneParams) else params_state
    ms, opt_state = _index_slots(dict(ms), slots), _index_slots(opt_state, slots)

    def one_count(c):
        counts = np.unique(np.asarray(c))
        if len(counts) != 1:
            raise ValueError(f"slots at different steps: {counts.tolist()}")
        return counts[0]

    restore({"model_state": ms, "optimizer_state": _map_count(opt_state, one_count)},
            params, optimizer)


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
    from ..models import get_model

    state = load_checkpoint(path)
    kwargs = dict(state.get("model_kwargs") or {})
    kwargs.update(overrides)
    # the checkpoint's model_name picks the model (an unknown one raises
    # KeyError), not the name among the kwargs; the image size comes from
    # the dataset
    kwargs.pop("name", None)
    kwargs.pop("img_size", None)
    model = get_model(state.get("model_name", "dbw"))(img_size, device=device, **kwargs)
    params = scene_params_from_numpy(state["model_state"], model.device)
    return model, params, state
