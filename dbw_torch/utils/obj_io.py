"""OBJ (+ MTL + PNG texture) writer, PLY point-cloud writer and reader (a
copy of dbw_tpu/utils/obj_io.py's). Host-side numpy."""

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


def load_obj(path):
    """Minimal OBJ reader: verts (V, 3) float32 and triangle faces (F, 3)
    int32 (vt/vn ignored, polygons fan-triangulated)."""
    verts, faces = [], []
    for line in Path(path).read_text().splitlines():
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "v":
            verts.append([float(x) for x in parts[1:4]])
        elif parts[0] == "f":
            idx = [int(p.split("/")[0]) - 1 for p in parts[1:]]
            for k in range(1, len(idx) - 1):
                faces.append([idx[0], idx[k], idx[k + 1]])
    return np.asarray(verts, np.float32), np.asarray(faces, np.int32)


def save_ply(path, points, colors=None):
    """Binary little-endian PLY point cloud, with uchar colors (from [0, 1])
    when given."""
    points = np.asarray(points, np.float32)
    n = len(points)
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
    header += [f"property float {ax}" for ax in "xyz"]
    if colors is not None:
        header += [f"property uchar {c}" for c in ("red", "green", "blue")]
    header += ["end_header"]
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        if colors is None:
            f.write(points.astype("<f4").tobytes())
        else:
            cols = (np.clip(np.asarray(colors), 0, 1) * 255).astype(np.uint8)
            rec = np.zeros(n, dtype=[("xyz", "<f4", 3), ("rgb", "u1", 3)])
            rec["xyz"], rec["rgb"] = points, cols
            f.write(rec.tobytes())


_PLY_TYPES = {
    "float": "<f4", "float32": "<f4", "double": "<f8", "float64": "<f8",
    "uchar": "u1", "uint8": "u1", "char": "i1", "int8": "i1",
    "short": "<i2", "ushort": "<u2", "int": "<i4", "int32": "<i4",
    "uint": "<u4", "uint32": "<u4",
}


def load_ply(path):
    """PLY vertex reader (ascii and binary little-endian): (P, 3) float32
    positions."""
    with open(path, "rb") as f:
        header = []
        while True:
            line = f.readline().decode("ascii", errors="replace").strip()
            header.append(line)
            if line == "end_header":
                break
        fmt = next(ln.split()[1] for ln in header if ln.startswith("format"))
        n_verts = 0
        props = []  # (name, type) of the vertex element
        in_vertex = False
        for line in header:
            parts = line.split()
            if parts[:2] == ["element", "vertex"]:
                n_verts = int(parts[2])
                in_vertex = True
            elif parts[0] == "element" and parts[1] != "vertex":
                in_vertex = False
            elif parts[0] == "property" and in_vertex:
                props.append((parts[2], parts[1]))
        if fmt == "ascii":
            data = np.loadtxt(f, max_rows=n_verts, dtype=np.float64)
            names = [p[0] for p in props]
            ix = [names.index(a) for a in "xyz"]
            return data[:, ix].astype(np.float32)
        dt = np.dtype([(name, _PLY_TYPES[t]) for name, t in props])
        data = np.frombuffer(f.read(dt.itemsize * n_verts), dtype=dt, count=n_verts)
        return np.stack([data["x"], data["y"], data["z"]], axis=-1).astype(np.float32)
