"""Dataset factory (PyTorch port of dbw_tpu/data/__init__.py). Only the
synthetic dataset is ported; DTU, BlendedMVS and Nerfstudio raise."""

from .base import Loader, MultiViewDataset
from .synthetic import load_synthetic


def get_dataset(name):
    if name != "synthetic":
        raise NotImplementedError(f"dataset {name!r} is not ported")
    return load_synthetic


def create_train_val_test_loader(cfg, seed=0, device="cpu"):
    """Three loaders (train shuffled) from cfg['dataset'] and the batch size
    of cfg['training']; synthetic ground truth is rendered on ``device``."""
    dkw = dict(cfg["dataset"])
    load = get_dataset(dkw.pop("name"))
    bs = cfg.get("training", {}).get("batch_size", 4)
    dkw.pop("n_workers", None)
    img_size = dkw.pop("img_size", None)
    tag = dkw.pop("tag", "")
    return [Loader(load(split, img_size, tag, device=device, **dkw),
                   batch_size=bs, shuffle=shuffle, seed=seed)
            for split, shuffle in [("train", True), ("val", False),
                                   ("test", False)]]
