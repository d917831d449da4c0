"""Qualitative evaluation artifacts (PyTorch port of dbw_tpu/eval/quali.py,
reference dbw.py:495-554): texture PNGs, the full and the clean OBJ meshes,
the GT point cloud PLY, per-view renders with edge overlays, flat-lit
synthetic-color renders, a turntable video and per-view circle-trajectory
videos. Renders go through the supersampled hard viz renderers; long
trajectories in chunks of 10 views."""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np
import torch

from ..models.dbw import Phase
from ..render.trajectory import get_circle_traj, render_chunks, save_mesh_as_video, to_u8
from ..utils.image import convert_to_img, save_video
from ..utils.misc import path_mkdir, use_seed
from ..utils.obj_io import save_ply
from .export import export_scene_obj


@torch.no_grad()
def qualitative_eval(model, params, loader, path, NV=240, n_views=10,
                     render_videos=True, n_traj_videos=None):
    """Write the artifacts into ``path``. ``NV``: frames of a trajectory
    video; ``n_views``: test views rendered; ``n_traj_videos``: how many of
    them get trajectory videos (None: all); ``render_videos``: False writes
    no video at all."""
    path = Path(path)
    dev = model.device

    out = path_mkdir(path / "textures")
    sig = lambda k: torch.sigmoid(params[k]).cpu().numpy()
    convert_to_img(sig("texture_bkg")[0]).save(out / "bkg.png")
    convert_to_img(sig("texture_ground")[0]).save(out / "ground.png")
    for k, img in enumerate(sig("textures")):
        convert_to_img(img).save(out / f"block_{str(k).zfill(2)}.png")

    phase = Phase.eval_phase(filter_transparent=True)
    scene, _, _ = model.build_scene(params, phase)
    if render_videos:
        save_mesh_as_video(model.renderer_viz, scene, path / "rotated_mesh.mp4",
                           n_views=60)
    export_scene_obj(model, params, path / "mesh_full.obj", filter_transparent=True)
    export_scene_obj(model, params, path / "mesh.obj", filter_transparent=True,
                     w_bkg=False, reduce_ground=True)

    gt = np.asarray(loader.dataset.pc_gt)
    with use_seed(123):
        sel = np.random.permutation(len(gt))[:3000]
    save_ply(path / "gt.ply", gt[sel])

    syn_blocks, syn_aux = model.build_blocks(params, phase, synthetic=True)
    if int(syn_aux["mask"].sum()) == 0:
        return None
    full_colors = model.get_scene_face_colors(params, filter_transparent=True,
                                              w_env=False)
    syn_colors = model.synthetic_face_colors()
    viz, light = model.renderer_viz, model.renderer_light
    render = lambda R, T: viz.render(scene, R, T)[..., :3]
    render_syn = lambda R, T: light.render_faces_flat(syn_blocks, R, T, syn_colors)[..., :3]
    edged = lambda img, R, T: viz.draw_edges(img, syn_blocks, R, T, full_colors)
    edged_syn = lambda img, R, T: light.draw_edges(img, syn_blocks, R, T,
                                                   (0.3, 0.3, 0.3), linewidth=0.7)
    save = lambda img, name: convert_to_img(img[0].cpu().numpy()).save(path / name)

    R_traj = get_circle_traj(N_views=NV)[0].to(dev)
    n_traj = n_views if n_traj_videos is None else n_traj_videos
    count = 0
    n_zeros = int(math.log10(max(n_views - 1, 1))) + 1
    for inp, _ in loader:
        if count >= n_views:
            break
        for k in range(min(len(inp["imgs"]), n_views - count)):
            i = str(count + k).zfill(n_zeros)
            img = torch.from_numpy(np.asarray(inp["imgs"][k:k + 1])).to(dev)
            R = torch.from_numpy(np.asarray(inp["R"][k:k + 1])).to(dev)
            T = torch.from_numpy(np.asarray(inp["T"][k:k + 1])).to(dev)
            save(img, f"{i}_inp.png")
            rec = render(R, T)
            save(rec, f"{i}_rec.png")
            save(edged(rec, R, T), f"{i}_rec_col.png")
            save(edged(img, R, T), f"{i}_rec_col_inp.png")
            rec_syn = render_syn(R, T)
            save(rec_syn, f"{i}_rec_syn_nobkg.png")
            save(edged_syn(rec_syn, R, T), f"{i}_rec_syn_nobkg_edged.png")
            if render_videos and count + k < n_traj:
                R_v = torch.einsum("ij,njk->nik", R[0], R_traj)
                T_v = T[0].expand(NV, 3)
                save_video(render_chunks(lambda r, t: to_u8(render(r, t)), R_v, T_v),
                           path / f"{i}_rec_traj.mp4")
                save_video(render_chunks(lambda r, t: to_u8(render_syn(r, t)), R_v, T_v),
                           path / f"{i}_rec_traj_syn.mp4")
        count += min(len(inp["imgs"]), n_views - count)
    return None
