"""Optimizer factory (PyTorch port of dbw_tpu/train/optimizer.py).

Adam with two parameter groups: ``texture*`` parameters at the texture
learning rate, everything else at the main one. Betas and eps follow the
config, defaulting to optax.scale_by_adam's (0.9, 0.999) and 1e-8.
"""

from __future__ import annotations

import torch

TEXTURE_PARAM_NAMES = ("texture_bkg", "texture_ground", "textures")


def param_groups(params: dict, lr_main, lr_texture):
    main = [p for k, p in params.items() if k not in TEXTURE_PARAM_NAMES]
    tex = [p for k, p in params.items() if k in TEXTURE_PARAM_NAMES]
    return [{"params": main, "lr": lr_main, "name": "main"},
            {"params": tex, "lr": lr_texture, "name": "texture"}]


def create_optimizer(cfg, params: dict) -> torch.optim.Optimizer:
    """cfg: the full config dict (``training.optimizer`` is read); params:
    name -> leaf tensor."""
    kwargs = dict(cfg["training"].get("optimizer") or {})
    name = kwargs.pop("name", "adam")
    if name != "adam":
        raise NotImplementedError(f"optimizer {name!r} is not ported")
    txt = kwargs.pop("texture", None) or {}
    lr_main = float(kwargs.pop("lr", 1e-3))
    lr_texture = float(txt.get("lr", lr_main))
    betas = tuple(kwargs.pop("betas", (0.9, 0.999)))
    eps = float(kwargs.pop("eps", 1e-8))
    return torch.optim.Adam(param_groups(params, lr_main, lr_texture),
                            betas=betas, eps=eps)
