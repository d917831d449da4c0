"""Independent optimizations of one model config (PyTorch port of
dbw_tpu/parallel/): the seed axis of the multi-seed protocol and the scene
axis of the multi-scene trainer, as stacked leaves run one slot after the
other on a card, and the JAX package's device meshes over torch.distributed
(one process per rank): ``make_mesh`` and ``MultiSeedRunner`` with the
seed, data and pixel-band axes, ``make_scene_mesh`` and
``MultiSceneRunner`` with the scene axis."""

from .mesh import Mesh, close_distributed, factor_devices, init_distributed, make_mesh, world
from .scenes import (CAMERA_ATTRS, MultiSceneRunner, camera_state, make_scene_mesh,
                     stack_scene_params, use_camera)
from .seeds import (MultiSeedRunner, adam_step, band_gather, pad_seeds, seed_axis_exec,
                    seed_backward, seed_step, select_best_seed, stack_params, stacked_leaves,
                    unstack_params)
