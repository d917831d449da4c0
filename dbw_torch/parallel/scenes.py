"""The scene axis on one card (PyTorch port of the single-device parts of
dbw_tpu/parallel/scenes.py): each scene's slots run with that scene's
camera. The model's camera and renderers are swapped in for the scene and
restored after (JAX ``scenes.py:84-98`` re-invokes ``set_camera`` inside
the traced scene function); here each scene's set is built once by
``set_camera`` and kept. ``make_scene_mesh`` and ``MultiSceneRunner`` need
more than one card and are not ported."""

from __future__ import annotations

from contextlib import contextmanager

from .seeds import stack_params

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
