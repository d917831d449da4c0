"""Metric meters and their TSV logs, and the mesh evaluators (PyTorch port
of dbw_tpu/eval/metrics.py, reference src/utils/metrics.py).

The log is ``iteration, epoch, batch`` followed by the metric names, one
tab-separated row per ``log``. ``read_log`` needs no pandas: it returns
{column: (rows,) float64 array}.

``sample_points_from_mesh`` is the JAX package's numpy function, copied, so
that both draw the same samples from the same generator; ``MeshEvaluator``
draws from its generator in the JAX evaluator's order (the predicted
samples, the GT subset, the normalized mesh's samples) and runs the chamfer
distance and the gradient ICP on its device."""

from __future__ import annotations

import csv
from collections import OrderedDict, defaultdict
from pathlib import Path

import numpy as np
import torch

from ..losses.chamfer import chamfer_distance
from ..utils.device import DEFAULT_DEVICE, resolve_device

EPS = 1e-7
CHAMFER_FACTOR = 10  # the reporting factor of OccNet and DVR


def _scalar(v):
    if hasattr(v, "item"):
        return float(v.item())
    return float(v)


class AverageMeter:
    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.avg = 0.0
        self.count = 0

    def update(self, val, N=1):
        val = _scalar(val)
        self.val = val
        self.sum += val * N
        self.count += N
        self.avg = self.sum / self.count if self.count else 0.0


class Metrics:
    """Named meters with a TSV append-log."""

    def __init__(self, *names, log_file=None, append=False, truncate_iter=None):
        self.names = list(names)
        self.meters = defaultdict(AverageMeter)
        self.log_file = None if log_file is None else Path(log_file)
        if self.log_file is None:
            return
        if not self.log_file.exists() or not append:
            with open(self.log_file, "w") as f:
                f.write("iteration\tepoch\tbatch\t" + "\t".join(self.names) + "\n")
        elif truncate_iter is not None:
            # resume: the interrupted run logged rows past its last
            # checkpoint, which the replay logs again
            self._truncate(truncate_iter)

    def _truncate(self, max_iter):
        lines = self.log_file.read_text().splitlines(keepends=True)
        keep = lines[:1]
        for ln in lines[1:]:
            try:
                if int(ln.split("\t", 1)[0]) > max_iter:
                    continue
            except ValueError:
                pass
            keep.append(ln)
        if len(keep) != len(lines):
            self.log_file.write_text("".join(keep))

    def __getitem__(self, name):
        return self.meters[name]

    def __repr__(self):
        return ", ".join(f"{n}={self[n].avg:.4f}" for n in self.names)

    @property
    def values(self):
        return [self[n].avg for n in self.names]

    def update(self, values: dict, N=1):
        """Add {name: value} to the meters, each value weighing N."""
        for name, val in values.items():
            if name not in self.names:
                raise KeyError(f"{name} not in current metrics")
            self[name].update(val, N=N)

    def log(self, it, epoch, batch):
        if self.log_file is not None:
            with open(self.log_file, "a") as f:
                f.write(f"{it}\t{epoch}\t{batch}\t"
                        + "\t".join(f"{v:.6f}" for v in self.values) + "\n")

    def reset(self):
        for n in self.names:
            self[n].reset()

    def log_and_reset(self, it=None, epoch=None, batch=None):
        self.log(it, epoch, batch)
        self.reset()

    def read_log(self):
        """The log as {column: (rows,) float64 array} ({} without a log);
        an empty field reads as NaN."""
        if self.log_file is None or not self.log_file.exists():
            return {}
        with open(self.log_file, newline="") as f:
            rows = list(csv.reader(f, delimiter="\t"))
        if not rows:
            return {}
        header, body = rows[0], rows[1:]
        num = lambda s: float(s) if s not in ("", "None") else np.nan
        return {h: np.array([num(r[i]) if i < len(r) else np.nan for r in body],
                            np.float64)
                for i, h in enumerate(header)}

    def get_named_values(self, filter_fn=None):
        pairs = list(zip(self.names, self.values))
        if filter_fn is not None:
            pairs = [p for p in pairs if filter_fn(p[0])]
        return pairs


def sample_points_from_mesh(verts, faces, n_points, rng=None, return_normals=False):
    """Area-weighted surface samples (n_points, 3) float32 (and their unit
    face normals), numpy only."""
    rng = rng or np.random.default_rng(0)
    verts = np.asarray(verts, np.float64)
    faces = np.asarray(faces)
    v0, v1, v2 = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    cross = np.cross(v1 - v0, v2 - v0)
    areas = 0.5 * np.linalg.norm(cross, axis=1)
    if areas.sum() <= 0:
        probs = np.full(len(faces), 1.0 / len(faces))
    else:
        probs = areas / areas.sum()
    idx = rng.choice(len(faces), size=n_points, p=probs)
    u = rng.random(n_points)
    v = rng.random(n_points)
    flip = u + v > 1
    u[flip], v[flip] = 1 - u[flip], 1 - v[flip]
    pts = v0[idx] + u[:, None] * (v1[idx] - v0[idx]) + v[:, None] * (v2[idx] - v0[idx])
    if return_normals:
        n = cross[idx]
        n = n / np.linalg.norm(n, axis=1, keepdims=True).clip(1e-12)
        return pts.astype(np.float32), n.astype(np.float32)
    return pts.astype(np.float32)


class MeshEvaluator:
    """Chamfer-L1 and normal consistency between a predicted mesh and GT
    points, also after a gradient-ICP alignment, on ``device`` (the card
    unless the CPU is asked for). ``N`` samples a side, ``n_iter`` ICP
    steps: 100,000 and 100, or 50,000 and 30 with ``fast_cpu``."""

    default_names = ["chamfer-L1", "chamfer-L1-ICP", "normal-cos", "normal-cos-ICP"]

    def __init__(self, names=None, log_file=None, run_icp=True,
                 estimate_scale=True, anisotropic_scale=True, fast_cpu=False,
                 append=False, device=DEFAULT_DEVICE):
        self.names = names if names is not None else self.default_names
        self.metrics = Metrics(*self.names, log_file=log_file, append=append)
        self.run_icp = run_icp
        self.estimate_scale = estimate_scale
        self.ani_scale = anisotropic_scale
        self.fast_cpu = fast_cpu
        self.device = resolve_device(device)
        self.N = 50000 if fast_cpu else 100000
        self.n_iter = 30 if fast_cpu else 100

    def _t(self, a):
        return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

    def evaluate(self, verts, faces, pc_gt, norm_gt=None, rng=None):
        """{name: score} for a mesh (numpy verts, faces) and GT points (and
        normals)."""
        from .icp import gradient_icp

        rng = rng or np.random.default_rng(0)
        pc_pred, norm_pred = sample_points_from_mesh(
            verts, faces, self.N, rng, return_normals=True)
        pc_gt = np.asarray(pc_gt, np.float32)
        if self.N < len(pc_gt):  # the GT subset, with its normals
            sel = rng.permutation(len(pc_gt))[: self.N]
            pc_gt = pc_gt[sel]
            if norm_gt is not None:
                norm_gt = norm_gt[sel]

        rounds = [(pc_pred, norm_pred, "")]
        if self.run_icp:
            # the prediction normalized into the unit cube for the ICP
            center = 0.5 * (verts.max(0) + verts.min(0))
            scale = np.abs(verts - center).max() * 2
            verts_n = (verts - center) / max(scale, EPS)
            pc2, norm2 = sample_points_from_mesh(
                verts_n, faces, self.N, rng, return_normals=True)
            pc_icp, (R_icp, _, s_icp) = gradient_icp(
                self._t(pc2)[None], self._t(pc_gt)[None], self.estimate_scale,
                self.ani_scale, lr=0.01, n_iter=self.n_iter)
            # normals move by the inverse transpose of diag(s) R (row
            # vectors): n' = normalize((n / s) @ R)
            R0 = R_icp[0].cpu().numpy()
            s0 = s_icp[0].cpu().numpy().reshape(1, -1)
            norm_icp = (norm2 / np.maximum(s0, EPS)) @ R0
            norm_icp = norm_icp / np.maximum(
                np.linalg.norm(norm_icp, axis=-1, keepdims=True), EPS)
            rounds.append((pc_icp[0].cpu().numpy(), norm_icp, "-ICP"))

        results = []
        gt = self._t(pc_gt)[None]
        for pc, norm, tag in rounds:
            if norm_gt is not None:
                cham, normal = chamfer_distance(
                    gt, self._t(pc)[None], x_normals=self._t(norm_gt)[None],
                    y_normals=self._t(norm)[None], return_L1=True,
                    direction_reduction="mean")
                results.append((f"chamfer-L1{tag}", float(cham) * CHAMFER_FACTOR))
                results.append((f"normal-cos{tag}", 1.0 - float(normal)))
            else:
                cham, _ = chamfer_distance(gt, self._t(pc)[None], return_L1=True,
                                           direction_reduction="mean")
                results.append((f"chamfer-L1{tag}", float(cham) * CHAMFER_FACTOR))
        return OrderedDict([r for r in results if r[0] in self.names])

    def update(self, verts, faces, labels):
        self.metrics.update(self.evaluate(verts, faces, labels["points"],
                                          labels.get("normals")))

    def compute(self):
        return self.metrics.values

    def __repr__(self):
        return repr(self.metrics)


class ProxyEvaluator:
    """Mask IoU of predicted and GT masks (numpy)."""

    default_names = ["mask_iou"]

    def __init__(self, names=None, log_file=None, append=False):
        self.names = names if names is not None else self.default_names
        self.metrics = Metrics(*self.names, log_file=log_file, append=append)

    def evaluate(self, mask_pred, mask_gt):
        inter = (mask_pred * mask_gt).sum()
        union = np.clip(mask_pred + mask_gt, 0, 1).sum()
        return OrderedDict([("mask_iou", float(inter / max(union, EPS)))])

    def update(self, mask_pred, mask_gt):
        for k in range(len(mask_pred)):
            self.metrics.update(self.evaluate(mask_pred[k], mask_gt[k]))

    def compute(self):
        return self.metrics.values
