"""Model registry (PyTorch port of dbw_tpu/models/__init__.py; the
reference has the blocks-world model only).

``create_model`` raises KeyError for a config without ``model.name`` and
for an unknown name, as the JAX package does. ``load_model_from_checkpoint``
lives in ``train/checkpoint.py`` and is re-exported here; it is resolved
on first use, because that module imports this package.
"""

from __future__ import annotations

from ..utils.device import DEFAULT_DEVICE
from .dbw import BlocksWorld


def get_model(name):
    return {"dbw": BlocksWorld}[name]


def create_model(cfg, img_size, device=DEFAULT_DEVICE):
    kwargs = dict(cfg["model"])
    name = kwargs.pop("name")
    return get_model(name)(img_size, device=device, **kwargs)


def __getattr__(name):
    if name == "load_model_from_checkpoint":
        from ..train.checkpoint import load_model_from_checkpoint

        return load_model_from_checkpoint
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
