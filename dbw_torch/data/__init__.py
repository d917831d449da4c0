"""Dataset factory (PyTorch port of dbw_tpu/data/__init__.py): synthetic,
DTU, BlendedMVS and nerfstudio captures. An unknown name raises KeyError."""

from ..utils.device import DEFAULT_DEVICE, resolve_device
from .base import Loader, MultiViewDataset
from .bmvs import load_bmvs
from .dtu import load_dtu
from .nerfstudio import load_nerfstudio
from .synthetic import load_synthetic

LOADERS = {"dtu": load_dtu, "bmvs": load_bmvs, "synthetic": load_synthetic,
           "nerfstudio": load_nerfstudio}


def get_dataset(name):
    return LOADERS[name]


def create_train_val_test_loader(cfg, seed=0, device=DEFAULT_DEVICE):
    """Three loaders (train shuffled) from cfg['dataset'] and the batch size
    of cfg['training']; synthetic ground truth is rendered on ``device`` (the
    card unless the CPU is asked for), scans are read on the host."""
    dkw = dict(cfg["dataset"])
    load = get_dataset(dkw.pop("name"))
    device = resolve_device(device)
    bs = cfg.get("training", {}).get("batch_size", 4)
    dkw.pop("n_workers", None)
    img_size = dkw.pop("img_size", None)
    tag = dkw.pop("tag", "")
    return [Loader(load(split, img_size, tag, device=device, **dkw),
                   batch_size=bs, shuffle=shuffle, seed=seed)
            for split, shuffle in [("train", True), ("val", False),
                                   ("test", False)]]
