"""YAML config loading with recursive default-merge: a scene config overlays
the ``default.yml`` in its own directory when one exists (same semantics as
dbw_tpu/utils/config.py, kept here so the port never imports the JAX
package)."""

from pathlib import Path

import yaml


def update_recursive(dict1, dict2):
    for k, v in dict2.items():
        if k not in dict1:
            dict1[k] = dict()
        if isinstance(v, dict):
            update_recursive(dict1[k], v)
        else:
            dict1[k] = v


def load_yaml(path, default_path=None):
    path = Path(path)
    if not path.exists():
        raise FileNotFoundError(path)
    with open(path) as fp:
        cfg_s = yaml.load(fp, Loader=yaml.FullLoader)
    default_path = Path(default_path) if default_path else path.parent / "default.yml"
    cfg = {}
    if default_path.exists():
        with open(default_path) as fp:
            cfg = yaml.load(fp, Loader=yaml.FullLoader)
    update_recursive(cfg, cfg_s)
    return cfg


def dump_yaml(cfg, path):
    with open(path, mode="w") as f:
        return yaml.safe_dump(cfg, f)
