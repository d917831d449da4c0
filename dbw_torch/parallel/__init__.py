"""Independent optimizations of one model config on one card (PyTorch port
of dbw_tpu/parallel/): the seed axis of the multi-seed protocol and the
scene axis of the multi-scene trainer, both as stacked leaves run one slot
after the other. The device meshes of the JAX package (``make_mesh``,
``MultiSeedRunner``, ``MultiSceneRunner``) need more than one card and are
not ported (ROADMAP.md queue 1, item 7)."""

from .scenes import CAMERA_ATTRS, camera_state, stack_scene_params, use_camera
from .seeds import (adam_step, pad_seeds, seed_axis_exec, seed_backward, seed_step,
                    select_best_seed, stack_params, stacked_leaves, unstack_params)
