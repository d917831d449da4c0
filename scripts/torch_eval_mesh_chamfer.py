#!/usr/bin/env python3
"""Mesh scores of a finished run with the PyTorch port (the twin of
scripts/eval_mesh_chamfer.py).

    python3 scripts/torch_eval_mesh_chamfer.py --run runs/synthetic/<tag>
        [--ckpt model.pkl] [--fast-cpu] [--gt-ply points.ply] [--cpu]

Rebuilds the model from the run directory's dumped config yml and its
checkpoint, exports the filtered block mesh and scores it against the
dataset's GT points (or the points of ``--gt-ply``) with the port's
MeshEvaluator: chamfer-L1 (x10) and, with GT normals, normal consistency,
before and after gradient ICP. ``--fast-cpu`` takes the evaluator's small
setting (50,000 samples, 30 ICP steps). Writes ``mesh_scores.tsv`` beside
the checkpoint (``--ckpt seed11/model.pkl`` of a protocol run writes
``seed11/mesh_scores.tsv``) and prints the scores. Runs on the card unless
``--cpu``.
"""

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main():
    from dbw_torch.eval.mesh_scores import score_run_mesh
    from dbw_torch.eval.metrics import MeshEvaluator
    from dbw_torch.utils.obj_io import load_ply

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--run", required=True, help="run dir with a checkpoint and a "
                   "dumped config yml")
    p.add_argument("--ckpt", default="model.pkl")
    p.add_argument("--fast-cpu", action="store_true")
    p.add_argument("--gt-ply", default=None, help="score against these points "
                   "instead of the dataset's")
    p.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = p.parse_args()
    gt = load_ply(args.gt_ply) if args.gt_ply else None
    t0 = time.perf_counter()
    ev = MeshEvaluator(fast_cpu=args.fast_cpu, device="cpu" if args.cpu else "cuda")
    scores = score_run_mesh(args.run, ev, args.ckpt, gt_points=gt)
    print("mesh_scores:", ", ".join(f"{k}={v:.5f}" for k, v in scores.items()),
          f"({time.perf_counter() - t0:.1f} s)")


if __name__ == "__main__":
    main()
