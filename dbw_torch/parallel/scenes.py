"""The scene axis (PyTorch port of dbw_tpu/parallel/scenes.py): each
scene's slots run with that scene's camera. The model's camera and
renderers are swapped in for the scene and restored after (JAX
``scenes.py:84-98`` re-invokes ``set_camera`` inside the traced scene
function); here each scene's set is built once by ``set_camera`` and kept.

On one device ``scene_backward`` (the forward and backward of
``seeds.train_step`` given cameras) is the JAX trainer's single-device
program, a nested ``seed_axis_exec`` over (scene, seed): batched (``vmap``,
the default) it runs every scene's every seed as one step of n_scene * S
slots, each slot's views rendered with its scene's intrinsics, given per
view (``cameras.view_camera``); under ``map`` the scenes run one after
the other with the camera swap, and each scene's seeds by the executor.

Across ranks, ``make_scene_mesh`` lays the ranks out as JAX's ("scene",
"seed", "data") mesh, and ``MultiSceneRunner`` is its sharded step: each
rank trains its scene's seed slots on its view shard with the scene's
camera, the gradients and losses averaged over the data axis."""

from __future__ import annotations

from contextlib import contextmanager

import torch

from ..render.cameras import view_camera
from ..render.renderer import Renderer
from ..utils import profiling
from .mesh import _mesh, factor_devices, world
from .seeds import one_by_one, seed_backward, slot, stack_params, train_step

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


def views_state(model, cameras, n_views):
    """The renderers of a batched step whose views take their scene's
    intrinsics: ``cameras[i]`` (a ``camera_state``) for the next
    ``n_views[i]`` views; the scenes' own camera where they all share one
    (a fov camera ignores the dataset's K)."""
    cams = [c["camera"] for c in cameras]
    cam = cams[0] if all(c == cams[0] for c in cams) else view_camera(
        cams, n_views, model.device)
    return {a: Renderer(getattr(model, a).config, cam) for a in ("renderer", "renderer_env")}


def scene_backward(model, params, phase, views, cameras, draws):
    """Every (scene, seed) slot's forward and backward on one device (the
    JAX trainer's nested ``seed_axis_exec``): ``params`` (n_scene, S, ...)
    stacked leaves, ``views[i]`` scene i's (imgs, R, T), ``cameras[i]`` its
    ``camera_state``, ``draws`` the step's, (n_scene, S, ...). Scenes run
    one after the other (``one_by_one``) with the camera swap, each scene's
    seeds by ``seed_backward``; batched, slot (i, j) is slot i * S + j of one
    step, on views of scene i. -> the detached losses, (n_scene, S) each."""
    n, S = model.slot_shape(params)
    if one_by_one(n):
        rows = []
        for i, (imgs, R, T) in enumerate(views):
            with use_camera(model, cameras[i]):
                rows.append(seed_backward(model, slot(params, i), phase, imgs,
                                          R.repeat(S, 1, 1), T.repeat(S, 1), slot(draws, i)))
        return {k: torch.stack([r[k] for r in rows]) for k in rows[0]}
    flat = lambda d: {k: v.reshape(n * S, *v.shape[2:]) for k, v in d.items()}
    with profiling.span("dbw.build"):
        imgs, R, T = (torch.cat([v[c].repeat(S, *[1] * (v[c].ndim - 1)) for v in views])
                      for c in range(3))
        state = views_state(model, cameras, [S * len(v[1]) for v in views])
    with use_camera(model, state):
        losses = seed_backward(model, flat(params), phase, imgs, R, T, flat(draws))
    return {k: v.reshape(n, S) for k, v in losses.items()}


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
    its view shard with the scene's ``camera`` (a ``camera_state``), its
    seeds through ``seed_axis_exec`` (batched by default); gradients and
    losses averaged over the data axis, then Adam steps locally."""

    def __init__(self, model, optimizer, mesh, camera):
        if tuple(mesh.axis_names) != ("scene", "seed", "data"):
            raise ValueError(f"a (scene, seed, data) mesh is needed, got {mesh.axis_names}")
        self.model = model
        self.optimizer = optimizer
        self.mesh = mesh
        self.camera = camera

    def step(self, params, phase, imgs, R, T, generators=None, draws=None):
        """``train_step`` of this rank's scene. -> the (1, S_local) total
        losses, averaged over the data axis."""
        return train_step(self.model, self.optimizer, params, phase, [(imgs, R, T)],
                          generators, draws, self.mesh, cameras=[self.camera])["total"]
