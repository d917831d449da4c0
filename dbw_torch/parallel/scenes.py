"""The scene axis (PyTorch port of dbw_tpu/parallel/scenes.py): each
scene's slots run with that scene's camera. The model's camera and
renderers are swapped in for the scene and restored after (JAX
``scenes.py:84-98`` re-invokes ``set_camera`` inside the traced scene
function); here each scene's set is built once by ``set_camera`` and kept.

Across ranks, ``make_scene_mesh`` lays the ranks out as JAX's ("scene",
"seed", "data") mesh, and ``MultiSceneRunner`` is its sharded step: each
rank trains its scene's seed slots on its view shard with the scene's
camera, the gradients and losses averaged over the data axis."""

from __future__ import annotations

from contextlib import contextmanager

from .mesh import _mesh, factor_devices, world
from .seeds import mean_and_step, seed_backward, slot, stack_params

CAMERA_ATTRS = ("camera", "renderer", "renderer_env", "renderer_viz",
                "renderer_light")


def camera_state(model, K):
    """The model's camera and renderers for intrinsics ``K``; the model's
    own are left as they were."""
    saved = {a: getattr(model, a) for a in CAMERA_ATTRS}
    model.set_camera(K)
    state = {a: getattr(model, a) for a in CAMERA_ATTRS}
    for a, v in saved.items():
        setattr(model, a, v)
    return state


@contextmanager
def use_camera(model, state):
    """Run with a scene's ``camera_state``, then restore the model's."""
    saved = {a: getattr(model, a) for a in CAMERA_ATTRS}
    for a, v in state.items():
        setattr(model, a, v)
    try:
        yield model
    finally:
        for a, v in saved.items():
            setattr(model, a, v)


def stack_scene_params(per_scene_params_lists):
    """[[seed params...] per scene] -> one dict of (n_scene, S, ...)."""
    return stack_params([stack_params(pl) for pl in per_scene_params_lists])


def make_scene_mesh(n_scene, n_seed=None, n_data=None, world_size=None, rank=None):
    """("scene", "seed", "data") mesh of ``world_size`` ranks (default: the
    process group's); the ranks of a scene factor over seed (preferred: no
    traffic) then data, a missing axis derived from the given one, as
    JAX's ``make_scene_mesh`` does."""
    n = world()[1] if world_size is None else int(world_size)
    if n % n_scene:
        raise ValueError(f"{n_scene} scenes do not divide {n} devices")
    per_scene = n // n_scene
    if n_seed is None and n_data is None:
        n_seed, n_data = factor_devices(per_scene)
    elif n_seed is None:  # derive the missing axis, don't discard the given
        if per_scene % n_data:
            raise ValueError(f"n_data={n_data} does not divide {per_scene} devices/scene")
        n_seed = per_scene // n_data
    elif n_data is None:
        if per_scene % n_seed:
            raise ValueError(f"n_seed={n_seed} does not divide {per_scene} devices/scene")
        n_data = per_scene // n_seed
    if n_seed * n_data != per_scene:
        raise ValueError(f"a ({n_seed}, {n_data}) scene block is not {per_scene} devices")
    return _mesh(("scene", "seed", "data"), (n_scene, n_seed, n_data), n, rank,
                 {"reduce": (2,), "gather": (0, 1)})


class MultiSceneRunner:
    """One rank's step of the (scene, seed, data) sharded trainer (JAX
    ``MultiSceneRunner.step``): ``params`` are this rank's slots of its
    scene, stacked leaves (1, S_local, ...) under ``optimizer``, trained on
    its view shard with the scene's ``camera`` (a ``camera_state``);
    gradients and losses averaged over the data axis, then Adam steps
    locally."""

    def __init__(self, model, optimizer, mesh, camera):
        if tuple(mesh.axis_names) != ("scene", "seed", "data"):
            raise ValueError(f"a (scene, seed, data) mesh is needed, got {mesh.axis_names}")
        self.model = model
        self.optimizer = optimizer
        self.mesh = mesh
        self.camera = camera

    def step(self, params, phase, imgs, R, T, generators=None, draws=None):
        """-> the (1, S_local) total losses, averaged over the data axis."""
        self.optimizer.zero_grad(set_to_none=True)
        with use_camera(self.model, self.camera):
            losses = seed_backward(self.model, slot(params, 0), phase, imgs, R, T,
                                   generators, draws)
        return mean_and_step(self.mesh, self.optimizer, params, losses)[None]
