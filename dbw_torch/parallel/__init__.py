"""Independent optimizations of one model config (PyTorch port of
dbw_tpu/parallel/): the seed axis of the multi-seed protocol and the scene
axis of the multi-scene trainer, as stacked leaves run batched (one step of
every slot, the JAX package's vmap executor) or one slot after the other
(its map executor) on a card by ``train_step``, the optimizer step of
every trainer of the port, and the JAX package's device meshes over
torch.distributed (one process per rank): ``make_mesh`` and
``MultiSeedRunner`` with the seed, data and pixel-band axes,
``make_scene_mesh`` and ``MultiSceneRunner`` with the scene axis."""

from .mesh import Mesh, close_distributed, factor_devices, init_distributed, make_mesh, world
from .scenes import (CAMERA_ATTRS, MultiSceneRunner, camera_state, make_scene_mesh,
                     scene_backward, stack_scene_params, use_camera)
from .seeds import (MultiSeedRunner, band_gather, pad_seeds, seed_axis_exec, seed_backward,
                    select_best_seed, stack_params, stacked_leaves, train_step, unstack_params)
