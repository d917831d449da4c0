"""Paths, file listing and deterministic host seeding (a copy of the parts
of dbw_tpu/utils/misc.py that the Trainer and the loaders use).

``use_seed`` saves and restores the host RNG state (python + numpy) around
a block; device draws come from explicitly seeded ``torch.Generator``s, so
only host-side sampling (the viz-sample choice, the GT point subset) needs
it."""

import random
from functools import wraps
from pathlib import Path

import numpy as np


def path_exists(path):
    path = Path(path)
    if not path.exists():
        raise FileNotFoundError(f"{path.absolute()} does not exist")
    return path


def path_mkdir(path):
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    return path


def get_files_from(dir_path, valid_extensions=None, recursive=False, sort=False):
    """The files of ``dir_path`` (absolute), optionally of the given
    extensions, searched recursively, sorted."""
    path = path_exists(dir_path)
    glob = path.glob("**/*") if recursive else path.glob("*")
    files = [f.absolute() for f in glob if f.is_file()]
    if valid_extensions is not None:
        if isinstance(valid_extensions, str):
            valid_extensions = [valid_extensions]
        exts = [e if e.startswith(".") else f".{e}" for e in valid_extensions]
        files = [f for f in files if f.suffix in exts]
    return sorted(files) if sort else files


class use_seed:
    """Context manager / decorator seeding python+numpy RNG and restoring
    the previous state on exit. As a decorator, the seed may also come as
    the ``seed=`` keyword of the call."""

    def __init__(self, seed=None):
        if seed is not None and not (isinstance(seed, int) and seed >= 0):
            raise ValueError(f"use_seed: need an int >= 0, got {seed!r}")
        self.seed = seed

    def __enter__(self):
        if self.seed is not None:
            self.rand_state = random.getstate()
            self.np_state = np.random.get_state()
            random.seed(self.seed)
            np.random.seed(self.seed)
        return self

    def __exit__(self, typ, val, tb):
        if self.seed is not None:
            random.setstate(self.rand_state)
            np.random.set_state(self.np_state)

    def __call__(self, f):
        @wraps(f)
        def wrapper(*args, **kw):
            seed = self.seed if self.seed is not None else kw.pop("seed", None)
            with use_seed(seed):
                return f(*args, **kw)

        return wrapper
