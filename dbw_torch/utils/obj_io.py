"""OBJ (+ MTL + PNG texture) and PLY point-cloud writers (a copy of the
writers of dbw_tpu/utils/obj_io.py). Host-side numpy."""

from __future__ import annotations

from pathlib import Path

import numpy as np
from PIL import Image


def save_obj(path, verts, faces, verts_uvs=None, faces_uvs=None, texture_map=None):
    """OBJ writer, 6 decimals, with an optional texture (v/vt/f v/vt +
    .mtl + .png)."""
    path = Path(path)
    verts = np.asarray(verts)
    faces = np.asarray(faces)
    save_texture = all(t is not None for t in (verts_uvs, faces_uvs, texture_map))
    fmt = "%.6f"

    lines = []
    if save_texture:
        lines.append(f"\nmtllib {path.stem}.mtl\nusemtl mesh\n")
    for v in verts:
        lines.append("v " + " ".join(fmt % x for x in v))
    if save_texture:
        for uv in np.asarray(verts_uvs):
            lines.append("vt " + " ".join(fmt % x for x in uv))
        fuv = np.asarray(faces_uvs)
        for i, f in enumerate(faces):
            lines.append("f " + " ".join(f"{f[j] + 1}/{fuv[i, j] + 1}" for j in range(3)))
    else:
        for f in faces:
            lines.append("f " + " ".join(str(x + 1) for x in f))
    path.write_text("\n".join(lines) + "\n")

    if save_texture:
        tex = np.asarray(texture_map)
        Image.fromarray((np.clip(tex, 0, 1) * 255).astype(np.uint8)).save(
            path.with_suffix(".png"))
        path.with_suffix(".mtl").write_text(f"newmtl mesh\nmap_Kd {path.stem}.png\n")


def save_ply(path, points):
    """Binary little-endian PLY point cloud."""
    points = np.asarray(points, np.float32)
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {len(points)}"]
    header += [f"property float {ax}" for ax in "xyz"] + ["end_header"]
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        f.write(points.astype("<f4").tobytes())
