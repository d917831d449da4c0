"""The frozen plain reference (``benchmark/reference/dbwref``) against the
port on the CPU at a tiny size, where the port runs its plain twins of the
kernels too: the same init from a seed, the same losses and the same
gradients for one step of the decoupled model with the full loss stack,
single and as 2 stacked slots (the batched protocol's layout). The two are
the same arithmetic, so they agree to float32 round-off (1e-6 relative)."""

import numpy as np
import pytest
import torch

from benchmark.reference.dbwref.models.dbw import BlocksWorld as RefBlocksWorld
from benchmark.scan import K_NDC, views
from dbw_torch.models.dbw import BlocksWorld

H, W, B = 16, 20, 2
CFG = dict(
    mesh=dict(n_blocks=2, txt_size=16, S_world=0.5, R_world=[115, 0, 0]),
    renderer=dict(faces_per_pixel=2, cameras=dict(name="perspective"),
                  detach_bary=True, z_clip=0.001),
    rend_optim=dict(coarse_learning=1500, decimate_txt=750, decimate_factor=8,
                    kill_blocks=True, decouple_rendering=True, opacity_noise=True),
    loss=dict(rgb_weight=1, perceptual_weight=0.1, parsimony_weight=0.01,
              tv_weight=0.1, overlap_weight=1),
)
RTOL = 1e-6


def models():
    out = []
    for cls in (BlocksWorld, RefBlocksWorld):
        m = cls((H, W), device="cpu", **CFG)
        m.set_camera(K_NDC)
        out.append(m)
    return out


def step(model, params, imgs, R, T, seed):
    gen = torch.Generator().manual_seed(seed)
    losses = model.forward(params, model.phase_for_epoch(0, training=True), imgs, R, T,
                           generator=gen)
    losses["total"].sum().backward()
    return ({k: v.detach() for k, v in losses.items()},
            {k: p.grad for k, p in params.items()})


@pytest.mark.parametrize("slots", [0, 2])
def test_reference_step_matches_port(slots):
    port, ref = models()
    imgs, R, T = (torch.from_numpy(a) for a in views(3, B, (H, W)))
    seeds = [5, 6][:slots] if slots else [5]

    def params_of(model):
        ps = [model.init_params(seed=s) for s in seeds]
        if not slots:
            return ps[0]
        return {k: torch.stack([p[k].detach() for p in ps]).requires_grad_(True)
                for k in ps[0]}

    if slots:
        R, T = R.repeat(slots, 1, 1), T.repeat(slots, 1)
    lp, gp = step(port, params_of(port), imgs, R, T, 9)
    lr, gr = step(ref, params_of(ref), imgs, R, T, 9)
    for k in lr:
        np.testing.assert_allclose(lp[k].numpy(), lr[k].numpy(), rtol=RTOL, atol=0)
    for k in gr:
        scale = float(gr[k].abs().max()) or 1.0
        assert float((gp[k] - gr[k]).abs().max()) <= RTOL * scale, k


def test_reference_init_matches_port():
    port, ref = models()
    a, b = port.init_params(seed=2**31 + 7), ref.init_params(seed=2**31 + 7)
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k].detach(), b[k].detach()), k
