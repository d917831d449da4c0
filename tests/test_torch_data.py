"""Data of the port against the JAX package: the synthetic ground truth
(rendered through the decoupled predict), the loader's (seed, epoch)-keyed
batch order, and ``sample_sq`` points (on the surface: JAX's random draw
cannot be replayed)."""

import numpy as np
import pytest

import torch

from dbw_tpu.data.base import Loader as JaxLoader
from dbw_tpu.data.base import MultiViewDataset as JaxDataset
from dbw_tpu.data.synthetic import make_synthetic_scene as jax_make_synthetic_scene
from dbw_torch.data import create_train_val_test_loader
from dbw_torch.data.base import Loader, MultiViewDataset
from dbw_torch.data.synthetic import make_synthetic_scene
from dbw_torch.ops.rotations import rotation_6d_to_matrix
from dbw_torch.ops.superquadric import sample_sq

# GT images: pixel values within 1e-4 except where a silhouette pixel flips
# between two faces at a depth or coverage near-tie (at most 0.2% of pixels)
IMG_ATOL = 1e-4
MAX_FLIPPED = 2e-3


def _surface(local, eps1, eps2):
    """Superquadric inside-outside function F - 1 in float64 (y up), zero on
    the surface; ``implicit_sq`` clamps small bases for its gradients and is
    no exact test near the poles."""
    x, y, z = (local[..., i].double().abs() for i in range(3))
    e1, e2 = eps1.double(), eps2.double()
    return (x ** (2 / e2) + z ** (2 / e2)) ** (e2 / e1) + y ** (2 / e1) - 1


@pytest.fixture(scope="module")
def scenes():
    jds, _, _ = jax_make_synthetic_scene((64, 80), n_views=12, seed=0)
    tds, tmodel, tparams = make_synthetic_scene((64, 80), n_views=12, seed=0)
    return jds, tds, tmodel, tparams


def test_synthetic_images_match_jax(scenes):
    jds, tds, _, _ = scenes
    assert tds.imgs.shape == jds.imgs.shape == (12, 64, 80, 3)
    for k in ("K", "R", "T"):
        np.testing.assert_allclose(getattr(tds, k), getattr(jds, k), atol=1e-6,
                                   err_msg=k)
    d = np.abs(tds.imgs - jds.imgs).max(-1)
    assert (d > IMG_ATOL).mean() <= MAX_FLIPPED, (d > IMG_ATOL).mean()
    # the blocks are in view, and the env shows around them
    assert tds.imgs.std() > 0.05 and np.isfinite(tds.imgs).all()
    assert tds.name == "synthetic" and tds.tag == "synthetic0"


def test_synthetic_gt_points_on_the_blocks(scenes):
    _, tds, model, params = scenes
    assert tds.pc_gt.shape == (2000 // 3 * 3, 3)
    # every point lies on one of the GT blocks' surfaces
    pts = torch.from_numpy(tds.pc_gt)
    eps1, eps2 = model.block_sq_eps(params)
    S = (torch.exp(params["S"]) + model.scale_min) * model.ratio_block_scene
    R = rotation_6d_to_matrix(params["R_6d"])
    local = ((pts[None] - params["T"][:, None]) @ R.transpose(1, 2)) / S[:, None]
    f = _surface(local, eps1, eps2).abs().min(0).values
    assert float(f.max()) < 1e-5


@pytest.mark.parametrize("seed,epoch,shuffle", [(0, 0, True), (3, 5, True),
                                                (227391, 1, True), (1, 2, False)])
def test_loader_order_matches_jax(seed, epoch, shuffle):
    rng = np.random.default_rng(0)
    arrs = (rng.random((13, 2, 3, 3), np.float32), np.zeros((13, 4, 4), np.float32),
            rng.random((13, 3, 3), np.float32), rng.random((13, 3), np.float32))
    jl = JaxLoader(JaxDataset(*arrs), batch_size=4, shuffle=shuffle, seed=seed)
    tl = Loader(MultiViewDataset(*arrs), batch_size=4, shuffle=shuffle, seed=seed)
    for ld in (jl, tl):
        ld.set_epoch(epoch)
    assert len(tl) == len(jl) == 4
    for _ in range(2):
        ji, ti = list(jl.iter_indices()), list(tl.iter_indices())
        assert [len(i) for i in ti] == [4, 4, 4, 1]
        for a, b in zip(ji, ti):
            np.testing.assert_array_equal(a, b)
    for (jb, jp), (tb, tp) in zip(jl, tl):
        for k in jb:
            np.testing.assert_array_equal(jb[k], tb[k])
        np.testing.assert_array_equal(jp["points"], tp["points"])


@pytest.mark.parametrize("eps", [(0.1, 0.1), (1.0, 1.0), (1.9, 0.4)])
def test_sample_sq_points_on_surface(eps):
    e1 = torch.full((2, 1), eps[0])
    e2 = torch.full((2, 1), eps[1])
    scale = torch.tensor([[1.0, 2.0, 0.5], [0.3, 0.3, 0.3]])
    gen = torch.Generator().manual_seed(0)
    pts = sample_sq(e1, e2, scale, 500, generator=gen)
    assert pts.shape == (2, 500, 3)
    again = sample_sq(e1, e2, scale, 500, generator=torch.Generator().manual_seed(0))
    assert torch.equal(pts, again)
    # sample_sq's up axis is z; the surface equation's is y
    local = (pts / scale[:, None])[..., [0, 2, 1]]
    assert float(_surface(local, e1, e2).abs().max()) < 1e-5
    # the angles cover the whole surface: both poles and all four sides
    assert float(local[..., 1].max()) > 0.9 and float(local[..., 1].min()) < -0.9
    assert (local[..., 0] > 0.5).any() and (local[..., 0] < -0.5).any()


def test_create_loaders_for_synthetic():
    cfg = {"dataset": {"name": "synthetic", "img_size": [24, 32], "n_views": 8,
                       "seed": 1, "tag": "t"},
           "training": {"batch_size": 3}}
    train, val, test = create_train_val_test_loader(cfg)
    assert (len(train.dataset), len(val.dataset), len(test.dataset)) == (8, 2, 2)
    assert train.shuffle and not val.shuffle and train.batch_size == 3
    assert train.dataset.img_size == (24, 32)
    with pytest.raises(NotImplementedError):
        create_train_val_test_loader({"dataset": {"name": "dtu"}})
