"""Quantitative image evaluation (PyTorch port of dbw_tpu/eval/quant.py,
reference dbw.py:465-493): hard antialiased renders of the filtered scene
on the test views, scored per view by PSNR, SSIM and LPIPS, with the loss
stack and the block count and opacities.

A ragged last batch is padded to the loader's batch size by repeating its
last view and the pad views are cut before the meters, as the JAX package
does, so every batch renders at one shape."""

from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

from ..losses.basic import mse2psnr
from ..losses.ssim import ssim_loss
from ..losses.vgg import LPIPSLoss
from ..models.dbw import Phase
from .metrics import AverageMeter


def pad_batch(arr, batch_size):
    """Pad the leading axis to batch_size with copies of the last element:
    (padded, n_real)."""
    n = arr.shape[0]
    if n >= batch_size:
        return arr, n
    return np.concatenate([arr, np.repeat(arr[-1:], batch_size - n, axis=0)]), n


@torch.no_grad()
def quantitative_eval(model, params, loader, hard_inference=True, lpips=None):
    """The final scores of one scene: an OrderedDict of n_blocks, L_tot,
    L_rec, PSNR, SSIM, the LPIPS column (under ``LPIPSLoss.label``) and
    alpha0..alpha{N-1}. ``hard_inference=False`` scores the eval phase's
    ``model.predict`` (the training renderer) in place of the hard 4x
    render; a given ``lpips`` is used as it is (the multi-seed protocol
    builds one for all its seeds)."""
    dev = model.device
    opacities = model.get_opacities(params).cpu().numpy()
    n_blocks = model.get_nb_opaque_blocks(params)
    lpips = lpips or LPIPSLoss(
        vgg=model.perceptual_loss.vgg if model.perceptual_loss else None, device=dev)
    lpips_col = lpips.label

    phase = Phase.eval_phase(filter_transparent=True)
    scene, _, _ = model.build_scene(params, phase)
    # the loss terms' inputs depend only on (params, phase): built once
    _, aux = model.build_blocks(params, phase)
    aux["env_raw_maps"] = model.build_env(params, phase)[1]
    gen = torch.Generator(device=dev).manual_seed(0)

    names = ["L_tot", "L_rec", "PSNR", "SSIM", lpips_col]
    meters = {k: AverageMeter() for k in names}
    bs = getattr(loader, "batch_size", None)
    for inp, _ in loader:
        n = len(inp["imgs"])
        imgs, R, T = (torch.from_numpy(pad_batch(np.asarray(inp[k]), bs or n)[0]).to(dev)
                      for k in ("imgs", "R", "T"))
        if hard_inference:
            rec = model.renderer_viz.render(scene, R, T)[..., :3]
        else:
            rec = model.predict(params, phase, R, T)[0]
        mse_v = ((imgs - rec) ** 2).mean(dim=(1, 2, 3))[:n]
        ssim_v = (1.0 - ssim_loss(imgs, rec, padding=False))[:n]
        lpips_v = lpips(imgs, rec, reduce=False)[:n]
        imgs, rec = imgs[:n], rec[:n]
        losses = model.compute_losses(imgs, rec, params, phase, aux, generator=gen)
        meters["L_tot"].update(float(losses["total"]), N=n)
        meters["L_rec"].update(sum(float(losses[k]) for k in ("rgb", "perceptual")
                                   if k in losses), N=n)
        meters["PSNR"].update(float(mse2psnr(mse_v.mean())), N=n)
        meters["SSIM"].update(float(ssim_v.mean()), N=n)
        meters[lpips_col].update(float(lpips_v.mean()), N=n)

    return OrderedDict(
        [("n_blocks", n_blocks)]
        + [(k, meters[k].avg) for k in names]
        + [(f"alpha{k}", float(a)) for k, a in enumerate(opacities)])
