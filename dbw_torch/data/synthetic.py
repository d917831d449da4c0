"""Synthetic multi-view dataset rendered from a random ground-truth block
scene (PyTorch port of dbw_tpu/data/synthetic.py): the workload of the
shipped synthetic configs, e.g. configs/synthetic/dtu_shaped.yml.

The ground truth is the port's own decoupled render (hard env pass under a
hard blocks pass) of the JAX package's GT scene: the same seeded numpy
draws, cameras and eval phase. The GT surface points come from
``sample_sq`` on a ``torch.Generator`` and are not the JAX package's
points (its ``jax.random`` draw cannot be replayed).
"""

from __future__ import annotations

import numpy as np
import torch

from ..convert import scene_params_from_numpy
from ..models.dbw import BlocksWorld, Phase
from ..ops.rotations import look_at_rotation, rotation_6d_to_matrix
from ..ops.superquadric import sample_sq
from .base import MultiViewDataset


def make_synthetic_scene(img_size=(64, 80), n_views=12, n_blocks=3,
                         txt_size=32, seed=0, dist=3.0, block_scale=1.0,
                         device="cpu"):
    """Render ``n_views`` cameras on a circle around a random GT block scene
    on ``device``. Returns (MultiViewDataset, gt_model, gt_params)."""
    cfg = dict(
        mesh=dict(
            n_blocks=n_blocks, S_world=1.0, R_world=[0, 0, 0],
            txt_size=txt_size, T_range=[0.5, 0.5, 0.5],
        ),
        renderer=dict(faces_per_pixel=1, z_clip=0.001),
        rend_optim=dict(decouple_rendering=True),
        loss=dict(rgb_weight=1),
    )
    model = BlocksWorld(img_size, device=device, **cfg)
    K = np.zeros((4, 4), np.float32)
    K[0, 0] = K[1, 1] = 2.5
    K[2, 3] = K[3, 2] = 1.0
    model.set_camera(K)

    p = model.init_params_numpy(seed=seed)
    # GT blocks clearly visible: opaque, moderately sized, near the origin,
    # with smooth saturated textures
    rng = np.random.default_rng(seed + 1)
    p["alpha_logit"] = np.full((n_blocks,), 8.0, np.float32)
    p["T"] = rng.uniform(-0.4, 0.4, (n_blocks, 3)).astype(np.float32)
    p["S"] = np.full((n_blocks, 3), np.log(block_scale), np.float32)
    p["textures"] = (rng.uniform(-2.0, 2.0, (n_blocks, 1, 1, 3))
                     * np.ones((1, txt_size, txt_size, 1))).astype(np.float32)
    params = scene_params_from_numpy(p, device, requires_grad=False)

    azim = np.linspace(-180, 180, n_views, endpoint=False)
    elev = 25.0 + 10.0 * np.sin(np.linspace(0, 2 * np.pi, n_views, endpoint=False))
    R, T = look_at_rotation(dist, elev, azim)
    with torch.no_grad():
        imgs = model.predict(params, Phase.eval_phase(), R.to(device),
                             T.to(device))[0]
        pts = sample_gt_points(model, params, n_points=2000, seed=seed)
    ds = MultiViewDataset(
        imgs.cpu().numpy(), np.broadcast_to(K, (n_views, 4, 4)), R.numpy(),
        T.numpy(), pc_gt=pts.cpu().numpy(), tag=f"synthetic{seed}",
        name="synthetic",
    )
    return ds, model, params


def sample_gt_points(model, params, n_points=2000, seed=0):
    """Surface samples of the GT blocks in world coordinates (P, 3)."""
    eps1, eps2 = model.block_sq_eps(params)
    S = torch.exp(params["S"]) + model.scale_min
    Rm = rotation_6d_to_matrix(params["R_6d"])
    # sample_sq puts the up (sin eta) component at z, the blocks at y:
    # permute the scale into sample_sq's order and the points back
    perm = [0, 2, 1]
    gen = torch.Generator(device=eps1.device).manual_seed(seed)
    pts = sample_sq(eps1, eps2, (S * model.ratio_block_scene)[:, perm],
                    n_points // max(model.n_blocks, 1), generator=gen)
    pts = pts[..., perm] @ Rm + params["T"][:, None]
    return model._world_transform(pts.reshape(-1, 3))


def load_synthetic(split, img_size, tag="", n_views=12, seed=0, gt_n_blocks=3,
                   gt_scale=1.0, gt_dist=3.0, device="cpu", **kwargs):
    kwargs.pop("view_ids", None)
    if kwargs:
        raise ValueError(f"unknown synthetic dataset keys: {sorted(kwargs)}")
    n = {"train": n_views, "val": max(2, n_views // 4),
         "test": max(2, n_views // 3)}[split]
    ds, _, _ = make_synthetic_scene(
        img_size, n_views=n, seed=seed, n_blocks=gt_n_blocks,
        block_scale=gt_scale, dist=gt_dist, device=device,
    )
    return ds
