"""In-memory multi-view dataset and its batch iterator (a copy of
dbw_tpu/data/base.py, kept here so that the port never imports the JAX
package).

A whole scene's views fit in device memory (49 x 300x400x3 f32 is 70 MB),
so a dataset is loaded once into numpy and the loader is a shuffled index
iterator with the reference's epoch semantics (drop_last=False, shuffle for
train only), keyed by (seed, epoch) so that a resumed run replays the batch
order of an uninterrupted one. ``load_image`` reads the DTU and
BlendedMVS views (PIL, bilinear resize).
"""

from __future__ import annotations

import numpy as np
from PIL import Image

IMG_EXTENSIONS = ["jpeg", "jpg", "JPG", "png", "PNG"]


class MultiViewDataset:
    """One calibrated scene: images + per-view cameras + optional GT points.

    Fields:
      imgs: (N, H, W, 3) float32 in [0, 1]
      K: (N, 4, 4) NDC intrinsics (internal convention)
      R: (N, 3, 3), T: (N, 3) world->view (row-vector action)
      pc_gt: (P, 3) float32 GT point cloud (may be a single zero point)
      scale_mat: (4, 4) or None — DTU world normalization matrix
    """

    name = "base"

    def __init__(self, imgs, K, R, T, pc_gt=None, scale_mat=None, tag="",
                 name=None):
        self.imgs = np.ascontiguousarray(imgs, np.float32)
        self.K = np.asarray(K, np.float32)
        self.R = np.asarray(R, np.float32)
        self.T = np.asarray(T, np.float32)
        self.pc_gt = (
            np.zeros((1, 3), np.float32) if pc_gt is None
            else np.asarray(pc_gt, np.float32)
        )
        self.scale_mat = scale_mat
        self.tag = tag
        if name is not None:
            self.name = name

    def __len__(self):
        return len(self.imgs)

    @property
    def img_size(self):
        return tuple(self.imgs.shape[1:3])


class Loader:
    """Shuffled (train) / sequential (val, test) batch iterator over a
    MultiViewDataset; yields dicts of numpy arrays."""

    def __init__(self, dataset: MultiViewDataset, batch_size=4, shuffle=False,
                 seed=0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        # epoch counter of the shuffle stream: the k-th pass always yields the
        # same order for a given seed, whatever the process did before
        self.epoch = 0

    def set_epoch(self, epoch):
        """Fast-forward the shuffle stream (resume support)."""
        self.epoch = int(epoch)

    def __len__(self):
        n = len(self.dataset)
        return (n + self.batch_size - 1) // self.batch_size if n else 0

    def _epoch_order(self):
        """Consume one epoch of the (seed, epoch)-keyed shuffle stream."""
        n = len(self.dataset)
        rng = np.random.default_rng((self.seed, self.epoch))
        self.epoch += 1
        order = rng.permutation(n) if self.shuffle else np.arange(n)
        return order, rng

    def __iter__(self):
        order, rng = self._epoch_order()
        for k in range(len(self)):
            ids = order[k * self.batch_size : (k + 1) * self.batch_size]
            d = self.dataset
            inp = {
                "imgs": d.imgs[ids], "K": d.K[ids], "R": d.R[ids], "T": d.T[ids],
            }
            pc = d.pc_gt
            if len(pc) > int(1e5):
                sel = rng.permutation(len(pc))[: int(1e5)]
                pc = pc[sel]
            yield inp, {"points": pc}

    def iter_indices(self):
        """Per-batch view-index arrays, from the same (seed, epoch) stream as
        ``__iter__``: a run that gathers its batches on the device by these
        indices sees the batch order of a run driven by ``__iter__``."""
        order, _ = self._epoch_order()
        for k in range(len(self)):
            yield order[k * self.batch_size : (k + 1) * self.batch_size]


def load_image(path, img_size):
    """PIL load + bilinear resize to (H, W); returns (H, W, 3) float32."""
    img = Image.open(path).convert("RGB")
    H, W = img_size
    if img.size != (W, H):
        img = img.resize((W, H), Image.BILINEAR)
    return np.asarray(img, np.float32) / 255.0
