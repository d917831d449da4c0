"""The official DTU Chamfer protocol (a copy of dbw_tpu/eval/dtu_eval.py,
reference src/utils/dtu_eval.py, itself from jzhangbs/DTUeval-python).

The numerics are the protocol's: triangle-grid surface sampling at 0.2 mm,
a seeded shuffle, greedy radius-0.2 downsampling in float32, ObsMask and
bounding-box masking, accuracy (data to GT) and completeness (GT to data)
with the MAX_DIST = 20 outlier cut, and the ground-plane filter of the GT.
Host-side numpy and scipy; the downsampling and the 1-NN queries go through
the port's neighbour library (``dbw_torch.native``), which has no fallback.
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np

from ..native import NativeKDTree, greedy_radius_mask
from ..utils.logger import print_log
from ..utils.obj_io import load_ply, save_ply

MAX_DIST = 20
PATCH = 60
DOWNSAMPLE_DENSITY = 0.2


def sample_single_tri(n1, n2, v1, v2, tri_vert):
    """Regular barycentric-grid samples of one triangle (reference
    dtu_eval.py:21-30)."""
    c = np.mgrid[: int(n1) + 1, : int(n2) + 1].astype(np.float64)
    c += 0.5
    c[0] /= max(n1, 1e-7)
    c[1] /= max(n2, 1e-7)
    c = np.transpose(c, (1, 2, 0))
    k = c[c.sum(axis=-1) < 1]
    return v1 * k[:, :1] + v2 * k[:, 1:] + tri_vert


def sample_mesh_surface(vertices, triangles, density=DOWNSAMPLE_DENSITY):
    """The vertices and each triangle's grid samples at the target density,
    vectorized (a flat repeat/cumsum layout) with the sample set and order
    of the reference's per-triangle loop: triangles in order, each grid
    row-major over (i, j)."""
    vertices = np.asarray(vertices, np.float64)
    tri_vert = vertices[triangles]
    v1 = tri_vert[:, 1] - tri_vert[:, 0]
    v2 = tri_vert[:, 2] - tri_vert[:, 0]
    l1 = np.linalg.norm(v1, axis=-1)
    l2 = np.linalg.norm(v2, axis=-1)
    area2 = np.linalg.norm(np.cross(v1, v2), axis=-1)
    nz = area2 > 0
    v0 = tri_vert[nz, 0]
    v1, v2, l1, l2, area2 = v1[nz], v2[nz], l1[nz], l2[nz], area2[nz]
    thr = density * np.sqrt(l1 * l2 / area2)
    n1 = np.floor(l1 / thr)
    n2 = np.floor(l2 / thr)
    counts = (n1.astype(np.int64) + 1) * (n2.astype(np.int64) + 1)
    offsets = np.concatenate([[0], np.cumsum(counts)])
    total = int(offsets[-1])
    if total == 0:
        return np.concatenate([vertices, np.zeros((0, 3))], axis=0)
    tri_id = np.repeat(np.arange(len(counts)), counts)
    r = np.arange(total) - offsets[tri_id]
    w2 = n2[tri_id].astype(np.int64) + 1
    i = r // w2
    j = r - i * w2
    u = (i + 0.5) / np.maximum(n1[tri_id], 1e-7)
    v = (j + 0.5) / np.maximum(n2[tri_id], 1e-7)
    keep = u + v < 1
    t = tri_id[keep]
    pts = v1[t] * u[keep, None] + v2[t] * v[keep, None] + v0[t]
    return np.concatenate([vertices, pts], axis=0)


def greedy_radius_downsample(points, radius=DOWNSAMPLE_DENSITY):
    """Greedy keep-first downsampling over radius neighbourhoods (the
    reference's mask loop, dtu_eval.py:87-95), in float32 as the JAX
    package runs it. Returns (kept points, mask)."""
    points = np.ascontiguousarray(points, np.float32)
    mask = greedy_radius_mask(points, radius)
    return points[mask], mask


def nn_distances(ref_points, queries):
    """1-NN Euclidean distances (float64) from each query to ref_points."""
    dist, _ = NativeKDTree(ref_points).query(queries)
    return dist.astype(np.float64)


def evaluate_mesh(verts, faces, scan_id, dataset_dir, eval_dir, suffix="",
                  save_viz=True, shuffle_seed=0, timings=None):
    """Write dtu_scores{suffix}.tsv (acc, comp, avg) for a predicted mesh in
    DTU world coordinates (millimetres); returns the three scores. With a
    ``timings`` dict, the host seconds of the protocol's parts go into it:
    ``sample``, ``downsample``, ``d2s`` and ``s2d`` (the two KD-tree passes,
    build and queries)."""
    timings = {} if timings is None else timings
    t0 = time.perf_counter()
    dataset_dir = Path(dataset_dir)
    eval_dir = Path(eval_dir)
    verts = np.asarray(verts, np.float64)
    faces = np.asarray(faces)
    # drop unreferenced vertices (reference: remove_unreferenced_vertices)
    used = np.zeros(len(verts), bool)
    used[faces.reshape(-1)] = True
    remap = -np.ones(len(verts), np.int64)
    remap[used] = np.arange(used.sum())
    verts = verts[used]
    faces = remap[faces]

    data_pcd = sample_mesh_surface(verts, faces)
    # seeded shuffle: the greedy downsample depends on the order
    rng = np.random.default_rng(shuffle_seed)
    rng.shuffle(data_pcd, axis=0)
    t1 = time.perf_counter()
    data_down, _ = greedy_radius_downsample(data_pcd)
    t2 = time.perf_counter()
    timings.update(sample=t1 - t0, downsample=t2 - t1)

    from scipy.io import loadmat

    obs = loadmat(dataset_dir / "ObsMask" / f"ObsMask{scan_id}_10.mat")
    ObsMask, BB, Res = obs["ObsMask"], obs["BB"].astype(np.float32), obs["Res"]

    inbound = (
        (data_down >= BB[:1] - PATCH) & (data_down < BB[1:] + PATCH * 2)
    ).sum(axis=-1) == 3
    data_in = data_down[inbound]
    data_grid = np.around((data_in - BB[:1]) / Res).astype(np.int32)
    grid_inbound = (
        (data_grid >= 0) & (data_grid < np.expand_dims(ObsMask.shape, 0))
    ).sum(axis=-1) == 3
    data_grid_in = data_grid[grid_inbound]
    in_obs = ObsMask[
        data_grid_in[:, 0], data_grid_in[:, 1], data_grid_in[:, 2]
    ].astype(bool)
    data_in_obs = data_in[grid_inbound][in_obs]

    stl = load_ply(
        dataset_dir / "Points" / "stl" / f"stl{scan_id:03}_total.ply"
    ).astype(np.float64)

    t3 = time.perf_counter()
    dist_d2s = nn_distances(stl, data_in_obs)[:, None]
    mean_d2s = dist_d2s[dist_d2s < MAX_DIST].mean()
    t4 = time.perf_counter()

    ground_plane = loadmat(dataset_dir / "ObsMask" / f"Plane{scan_id}.mat")["P"]
    stl_hom = np.concatenate([stl, np.ones_like(stl[:, :1])], -1)
    above = (ground_plane.reshape((1, 4)) * stl_hom).sum(-1) > 0
    stl_above = stl[above]

    t5 = time.perf_counter()
    dist_s2d = nn_distances(data_in, stl_above)[:, None]
    mean_s2d = dist_s2d[dist_s2d < MAX_DIST].mean()
    timings.update(d2s=t4 - t3, s2d=time.perf_counter() - t5)

    if save_viz:
        vis_dist = 1
        R = np.array([[1, 0, 0]], np.float64)
        G = np.array([[0, 1, 0]], np.float64)
        B = np.array([[0, 0, 1]], np.float64)
        W = np.array([[1, 1, 1]], np.float64)
        data_color = np.tile(B, (data_down.shape[0], 1))
        data_alpha = dist_d2s.clip(max=vis_dist) / vis_dist
        sel = np.where(inbound)[0][grid_inbound][in_obs]
        data_color[sel] = R * data_alpha + W * (1 - data_alpha)
        data_color[sel[dist_d2s[:, 0] >= MAX_DIST]] = G
        save_ply(eval_dir / f"vis_{scan_id:03}_d2s{suffix}.ply", data_down, data_color)
        stl_color = np.tile(B, (stl.shape[0], 1))
        stl_alpha = dist_s2d.clip(max=vis_dist) / vis_dist
        stl_color[np.where(above)[0]] = R * stl_alpha + W * (1 - stl_alpha)
        stl_color[np.where(above)[0][dist_s2d[:, 0] >= MAX_DIST]] = G
        save_ply(eval_dir / f"vis_{scan_id:03}_s2d{suffix}.ply", stl, stl_color)

    avg = (mean_d2s + mean_s2d) / 2
    with open(eval_dir / f"dtu_scores{suffix}.tsv", "w") as f:
        f.write("acc\tcomp\tavg\n")
        f.write(f"{mean_d2s}\t{mean_s2d}\t{avg}")
    print_log(
        "dtu_scores{}: acc={:.5f}, comp={:.5f}, avg={:.5f}".format(
            suffix, mean_d2s, mean_s2d, avg
        )
    )
    return {"acc": mean_d2s, "comp": mean_s2d, "avg": avg}
