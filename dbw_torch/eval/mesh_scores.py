"""The mesh scores of a finished run (PyTorch port of
scripts/eval_mesh_chamfer.py): the run's filtered block mesh against its
dataset's GT points through ``MeshEvaluator`` (chamfer-L1 and normal
consistency, also after gradient ICP), written as ``mesh_scores.tsv`` in
the JAX script's format."""

from __future__ import annotations

from pathlib import Path

import numpy as np



def write_mesh_scores(path, scores):
    with open(path, "w") as f:
        f.write("\t".join(scores.keys()) + "\n")
        f.write("\t".join(f"{v:.6f}" for v in scores.values()) + "\n")


def score_run_mesh(run_dir, evaluator, ckpt="model.pkl", gt_points=None):
    """Rebuild the model of ``run_dir`` from its dumped config yml and
    ``ckpt`` (relative to ``run_dir``) on the device of ``evaluator`` (a
    ``MeshEvaluator``), export its filtered block mesh and score it against
    the dataset's GT points (or ``gt_points``); writes ``mesh_scores.tsv``
    beside the checkpoint (a protocol's ``seed{s}/model.pkl`` gets
    ``seed{s}/mesh_scores.tsv``) and returns the scores."""
    from ..data import get_dataset
    from ..train.checkpoint import load_model_from_checkpoint
    from ..utils.config import load_yaml
    from .export import export_blocks_mesh

    device = evaluator.device
    run_dir = Path(run_dir)
    ymls = sorted(run_dir.glob("*.yml"))
    if not ymls:
        raise FileNotFoundError(f"no dumped config yml in {run_dir}")
    dkw = dict(load_yaml(ymls[0])["dataset"])
    dkw.pop("n_workers", None)
    load = get_dataset(dkw.pop("name"))
    dataset = load("train", dkw.pop("img_size", None), dkw.pop("tag", ""),
                   device=device, **dkw)
    pc_gt = np.asarray(dataset.pc_gt if gt_points is None else gt_points, np.float32)
    if pc_gt.size <= 3:
        raise ValueError(f"dataset {dataset.tag} has no GT point cloud")
    model, params, _ = load_model_from_checkpoint(run_dir / ckpt, dataset.img_size,
                                                  device=device)
    verts, faces = export_blocks_mesh(model, params, filter_transparent=True)
    scores = evaluator.evaluate(verts, faces, pc_gt)
    write_mesh_scores((run_dir / ckpt).parent / "mesh_scores.tsv", scores)
    return scores
