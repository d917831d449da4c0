"""Carry scene parameters between the JAX package and the port.

The port keeps the JAX ``SceneParams`` field names and array layouts, so the
mapping is a dict of named arrays either way: numpy float32 arrays (for
example ``SceneParams._asdict()`` after ``np.asarray``) <-> leaf tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from .models.dbw import PARAM_NAMES


def scene_params_from_numpy(params: dict, device="cpu", requires_grad=True):
    """{name: array} -> {name: float32 leaf tensor} on ``device``."""
    missing = set(PARAM_NAMES) - set(params)
    if missing:
        raise KeyError(f"missing scene params: {sorted(missing)}")
    return {
        k: torch.as_tensor(np.asarray(params[k], np.float32), device=device)
        .clone().requires_grad_(requires_grad)
        for k in PARAM_NAMES
    }


def scene_params_to_numpy(params: dict):
    """{name: tensor} -> {name: float32 numpy array}."""
    return {k: params[k].detach().cpu().numpy().astype(np.float32)
            for k in PARAM_NAMES}
