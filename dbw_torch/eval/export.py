"""Host-side scene export (PyTorch port of dbw_tpu/eval/export.py): real
transparency filtering (dynamic shapes are fine off the device) and OBJ
writing with the sub-meshes' texture maps packed into one image, stacked
vertically, with their uvs remapped."""

from __future__ import annotations

import numpy as np
import torch

from ..models.dbw import Phase
from ..utils.obj_io import save_obj


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@torch.no_grad()
def export_blocks_mesh(model, params, filter_transparent=True):
    """The filtered blocks in world coordinates as numpy (verts (V, 3),
    faces (F, 3) int32), no texture."""
    phase = Phase.eval_phase(filter_transparent=filter_transparent)
    scene, aux = model.build_blocks(params, phase)
    verts = _np(scene.verts).reshape(model.n_blocks, -1, 3)
    V = verts.shape[1]
    bf = _np(model.statics.block_faces).astype(np.int32)
    keep = np.where(_np(aux["mask"]))[0]
    if not len(keep):
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)
    return (np.concatenate([verts[b] for b in keep]),
            np.concatenate([bf + i * V for i in range(len(keep))]))


@torch.no_grad()
def export_scene_obj(model, params, path, filter_transparent=True, w_bkg=True,
                     reduce_ground=False):
    """The textured scene -> OBJ + MTL + packed PNG atlas: the dome (with
    ``w_bkg``), the ground (3 units wide with ``reduce_ground``) and the
    filtered blocks."""
    phase = Phase.eval_phase(filter_transparent=filter_transparent)
    sub_meshes = []  # (verts, faces, uv_verts, uv_faces, map image)
    if w_bkg:
        bkg, _ = model.build_bkg(params, phase)
        sub_meshes.append(_submesh_single(bkg))
    ground, _ = model.build_ground(params, phase, reduced=reduce_ground)
    sub_meshes.append(_submesh_single(ground))

    blocks, aux = model.build_blocks(params, phase)
    verts = _np(blocks.verts).reshape(model.n_blocks, -1, 3)
    maps = _np(blocks.atlas.maps)
    st = model.statics
    bf, buf, buv = _np(st.block_faces), _np(st.block_uv_faces), _np(st.block_uv_verts)
    for b in np.where(_np(aux["mask"]))[0]:
        sub_meshes.append((verts[b], bf, buv, buf, maps[b]))
    _write_packed_obj(path, sub_meshes)


def _submesh_single(scene):
    return (_np(scene.verts), _np(scene.faces), _np(scene.uv_verts),
            _np(scene.uv_faces), _np(scene.atlas.maps)[0])


def _write_packed_obj(path, sub_meshes):
    """Stack the sub-meshes' maps vertically into one atlas; remap uvs."""
    heights = [m[4].shape[0] for m in sub_meshes]
    width = max(m[4].shape[1] for m in sub_meshes)
    total_h = sum(heights)
    atlas = np.zeros((total_h, width, 3), np.float32)
    v_off = vt_off = y_off = 0
    all_v, all_f, all_uv, all_uvf = [], [], [], []
    for verts, faces, uv_verts, uv_faces, tex in sub_meshes:
        h, w = tex.shape[:2]
        atlas[y_off:y_off + h, :w] = tex
        # uv v == 1 is row 0 of the sub-map; remap into the packed atlas
        u = uv_verts[:, 0] * (w - 1) / max(width - 1, 1)
        row_in_map = (1.0 - uv_verts[:, 1]) * (h - 1)
        v = 1.0 - (y_off + row_in_map) / max(total_h - 1, 1)
        all_v.append(verts)
        all_f.append(faces + v_off)
        all_uv.append(np.stack([u, v], axis=-1))
        all_uvf.append(uv_faces + vt_off)
        v_off += len(verts)
        vt_off += len(uv_verts)
        y_off += h
    save_obj(path, np.concatenate(all_v), np.concatenate(all_f),
             verts_uvs=np.concatenate(all_uv), faces_uvs=np.concatenate(all_uvf),
             texture_map=atlas)
