"""Baseline (EMS / MBF) preprocessing + evaluation CLIs on DTU (PyTorch
port of dbw_tpu/eval/baselines.py).

Reimplements the reference's three standalone pipelines:
- dtu_3d_process.py: standardize DTU GT clouds for the external EMS/MBF
  fitters (5k pts @ scale 10/max for EMS, 200k pts @ scale 5/max for MBF,
  optional RANSAC ground-plane removal),
- ems_eval.py: reload fitted superquadric params -> rebuild meshes ->
  chamfer-L1 + official DTU eval,
- mbf_eval.py: reload fitted boxes (UH.json) -> convex hulls -> same eval.

Host-side numpy/scipy; the chamfer distance and the ground plane's RANSAC
run in torch on ``device``, the card unless the CPU is asked for (``--cpu``).

Usage:
  python -m dbw_torch.eval.baselines process -n ems -t TAG [-f] [--cpu]
  python -m dbw_torch.eval.baselines ems -t TAG [--cpu]
  python -m dbw_torch.eval.baselines mbf -t TAG [--cpu]
"""

from __future__ import annotations

import argparse
import json
import shutil
from collections import OrderedDict
from pathlib import Path

import numpy as np

from ..data.dtu import EVAL_SCAN_IDS, load_dtu
from ..losses.chamfer import chamfer_distance
from ..utils.logger import create_logger, print_log
from ..utils.misc import path_exists, path_mkdir, use_seed
from ..utils.obj_io import save_ply
from ..utils.device import DEFAULT_DEVICE, resolve_device
from ..utils.path import DATASETS_PATH, RUNS_PATH
from .dtu_eval import evaluate_mesh
from .metrics import CHAMFER_FACTOR, sample_points_from_mesh

N_POINTS_EMS_FIT = 5000
N_POINTS_MBF_FIT = 200000
N_POINTS_EVAL = int(5e5)

EMS_PATH = RUNS_PATH.parent / "external" / "ems"
MBF_PATH = RUNS_PATH.parent / "external" / "mbf"


def _euler_zyx_to_matrix(angles):
    """scipy-equivalent intrinsic ZYX euler -> rotation matrices."""
    from scipy.spatial.transform import Rotation

    return Rotation.from_euler("ZYX", angles).as_matrix().astype(np.float32)


def _sq_mesh_verts_faces(eps1, eps2, scale):
    """Superquadric level-1 icosphere meshes (host equivalent of the
    reference's create_sq_meshes, superquadric.py:41-47)."""
    import torch

    from ..ops.icosphere import icosphere
    from ..ops.superquadric import parametric_sq

    v, f = icosphere(level=1)
    eta = np.arcsin(np.clip(v[:, 1], -1, 1))
    omega = np.arctan2(v[:, 0], v[:, 2])
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    verts = parametric_sq(t(eta)[None], t(omega)[None], t(eps1).reshape(-1, 1),
                          t(eps2).reshape(-1, 1)).numpy()
    return verts * np.asarray(scale)[:, None, :], f


def _join_as_scene(verts_batch, faces_batch):
    all_v, all_f, off = [], [], 0
    for v, f in zip(verts_batch, faces_batch):
        all_v.append(v)
        all_f.append(np.asarray(f) + off)
        off += len(v)
    return np.concatenate(all_v), np.concatenate(all_f)


class DTU3DPreprocess:
    """Standardize DTU GT clouds for the external fitters (reference
    dtu_3d_process.py:20-66)."""

    def __init__(self, run_dir, model_name, filter_ground=False, device=DEFAULT_DEVICE):
        self.run_dir = path_mkdir(run_dir)
        self.model_name = model_name
        self.filter_ground = filter_ground
        self.device = resolve_device(device)

    @use_seed()
    def run(self):
        for tag in EVAL_SCAN_IDS:
            print_log(f"Preprocessing GT point cloud for {tag}...")
            ds = load_dtu("train", (300, 400), tag)
            pc = ds.pc_gt[np.random.permutation(len(ds.pc_gt))]
            scale_mat = np.asarray(ds.scale_mat)
            if self.filter_ground:
                from .ransac import remove_ground_plane

                pc, _ = remove_ground_plane(pc, axis=2, device=self.device)
            pc = pc @ scale_mat[:3, :3].T + scale_mat[:3, 3]
            mean = pc.mean(0)
            pc = pc - mean
            if self.model_name == "ems":
                n_points, scale = N_POINTS_EMS_FIT, 10.0 / pc.max()
            elif self.model_name == "mbf":
                n_points, scale = N_POINTS_MBF_FIT, 5.0 / pc.max()
            else:
                raise NotImplementedError(self.model_name)
            pc = pc * scale
            np.save(
                self.run_dir / f"{tag}_scale.npy",
                np.concatenate([mean, [scale]]).astype(np.float32),
            )
            save_ply(self.run_dir / f"{tag}.ply", pc[:n_points])
        print_log("DTU3DPreprocess over")


class EMSEvaluator:
    """Evaluate EMS superquadric fits (reference ems_eval.py:25-75)."""

    def __init__(self, run_dir, ems_tag=None, device=DEFAULT_DEVICE):
        self.device = resolve_device(device)
        self.run_dir = path_mkdir(run_dir)
        ems_dir = path_exists(EMS_PATH / "dtu" / (ems_tag or Path(run_dir).name))
        shutil.copytree(str(ems_dir), str(self.run_dir), dirs_exist_ok=True)

    @use_seed()
    def run(self):
        for tag in EVAL_SCAN_IDS:
            print_log(f"Evaluate EMS for {tag}...")
            ds = load_dtu("train", (300, 400), tag)
            gt = ds.pc_gt[np.random.permutation(len(ds.pc_gt))][:N_POINTS_EVAL]
            scale_arr = np.load(self.run_dir / f"{tag}_scale.npy")
            mean, scale_ems = scale_arr[:3], scale_arr[3]
            params = np.load(self.run_dir / f"{tag}_spq.npy").astype(np.float32)
            eps1, eps2 = params[:, 0], params[:, 1]
            S, T = params[:, 2:5], params[:, 8:11]
            R = _euler_zyx_to_matrix(params[:, 5:8])
            verts, faces = _sq_mesh_verts_faces(eps1, eps2, S)
            # column-convention rotate + translate, back to original space
            verts = np.einsum("nij,nvj->nvi", R, verts) + T[:, None]
            verts = verts / scale_ems + mean
            scene_v, scene_f = _join_as_scene(verts, [faces] * len(verts))
            _eval_scene(self.run_dir, tag, scene_v, scene_f, ds, gt, len(verts),
                        self.device)
        print_log("EMSEvaluator over")


class MBFEvaluator:
    """Evaluate MBF box fits (reference mbf_eval.py:24-74)."""

    def __init__(self, run_dir, mbf_tag=None, device=DEFAULT_DEVICE):
        self.device = resolve_device(device)
        self.run_dir = path_mkdir(run_dir)
        mbf_dir = path_exists(MBF_PATH / "dtu" / (mbf_tag or Path(run_dir).name))
        shutil.copytree(str(mbf_dir), str(self.run_dir), dirs_exist_ok=True)

    @use_seed()
    def run(self):
        from scipy.spatial import ConvexHull

        for tag in EVAL_SCAN_IDS:
            print_log(f"Evaluate MBF for {tag}...")
            ds = load_dtu("train", (300, 400), tag)
            gt = ds.pc_gt[np.random.permutation(len(ds.pc_gt))][:N_POINTS_EVAL]
            scale_arr = np.load(self.run_dir / f"{tag}_scale.npy")
            mean, scale_mbf = scale_arr[:3], scale_arr[3]
            with open(self.run_dir / tag / "UH.json") as f:
                metrics = json.load(f)
            verts = np.asarray(metrics["bbox"], np.float32)
            verts = verts / scale_mbf + mean
            faces = [ConvexHull(v).simplices for v in verts]
            scene_v, scene_f = _join_as_scene(verts, faces)
            _eval_scene(self.run_dir, tag, scene_v, scene_f, ds, gt, len(verts),
                        self.device)
        print_log("MBFEvaluator over")


def _eval_scene(run_dir, tag, scene_v, scene_f, ds, gt, n_blocks, device):
    import torch

    points = sample_points_from_mesh(scene_v, scene_f, N_POINTS_EVAL)
    inv = np.linalg.inv(np.asarray(ds.scale_mat))
    points = points @ inv[:3, :3].T + inv[:3, 3]  # VolSDF standardization
    as_t = lambda a: torch.as_tensor(np.asarray(a, np.float32)[None], device=device)
    (acc, comp), _ = chamfer_distance(
        as_t(points), as_t(gt), return_L1=True, direction_reduction="none"
    )
    acc = CHAMFER_FACTOR * float(acc)
    comp = CHAMFER_FACTOR * float(comp)
    scores = OrderedDict(
        [("n_blocks", n_blocks), ("chL1_acc", acc), ("chL1_comp", comp)]
    )
    print_log(
        f"{tag}_scores: "
        + ", ".join("{}={:.5f}".format(k, v) for k, v in scores.items())
    )
    with open(run_dir / f"{tag}_scores.tsv", "w") as f:
        f.write("\t".join(scores.keys()) + "\n")
        f.write("\t".join(map("{:.5f}".format, scores.values())) + "\n")
    evaluate_mesh(
        scene_v, scene_f, int(tag.replace("scan", "")), DATASETS_PATH / "DTU",
        run_dir, suffix=f"_{tag}", save_viz=False,
    )


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("mode", choices=["process", "ems", "mbf"])
    p.add_argument("-t", "--tag", required=True)
    p.add_argument("-n", "--name", default=None, help="baseline name (process)")
    p.add_argument("-e", "--ext_tag", default=None)
    p.add_argument("-f", "--filter_ground", action="store_true")
    p.add_argument("-s", "--seed", type=int, default=1234)
    p.add_argument("--cpu", action="store_true", help="run on the CPU, not the card")
    args = p.parse_args()
    device = "cpu" if args.cpu else DEFAULT_DEVICE
    if args.mode == "process":
        assert args.name in ("ems", "mbf")
        base = EMS_PATH if args.name == "ems" else MBF_PATH
        run_dir = path_mkdir(base / "dtu" / args.tag)
        create_logger(run_dir, name="3d_process")
        DTU3DPreprocess(run_dir, args.name, args.filter_ground,
                        device=device).run(seed=args.seed)
    elif args.mode == "ems":
        run_dir = path_mkdir(RUNS_PATH / "ems" / args.tag)
        create_logger(run_dir, name="ems_eval")
        EMSEvaluator(run_dir, args.ext_tag or args.tag, device=device).run(seed=args.seed)
    else:
        run_dir = path_mkdir(RUNS_PATH / "mbf" / args.tag)
        create_logger(run_dir, name="mbf_eval")
        MBFEvaluator(run_dir, args.ext_tag or args.tag, device=device).run(seed=args.seed)


if __name__ == "__main__":
    main()
