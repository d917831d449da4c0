"""The final evaluation of one run (PyTorch port of dbw_tpu/eval/full.py,
reference trainer.py:241-272): ``final_scores.tsv`` (quantitative image
metrics), ``quali_eval/`` (textures, OBJ meshes, renders, videos, an HTML
gallery) and, for a DTU scan, the official Chamfer protocol's
``dtu_scores.tsv``."""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ..utils.html import gallery_from_run_dir
from ..utils.logger import print_log
from ..utils.misc import path_mkdir
from ..utils.path import DATASETS_PATH


def write_scores_tsv(path, scores):
    with open(path, "w") as f:
        f.write("\t".join(scores.keys()) + "\n")
        f.write("\t".join(map("{:.5f}".format, scores.values())) + "\n")


def evaluate_run(model, params, test_loader, dataset, run_dir, quali=True,
                 lpips=None, label="", quali_kwargs=None,
                 dtu_dir=DATASETS_PATH / "DTU"):
    """Write the final evaluation artifacts of one scene; returns the final
    scores. ``quali=False`` writes the scores only (and for DTU the
    protocol's), without ``quali_eval/`` and its gallery (the multi-seed
    protocol's unselected seeds); ``lpips`` goes to ``quantitative_eval``;
    ``label`` prefixes the log line; ``quali_kwargs`` go to
    ``qualitative_eval`` (NV, n_views, render_videos, n_traj_videos). For a
    DTU dataset the filtered block mesh, in the scan's millimetres (its
    scale matrix applied), is scored by the official protocol against
    ``dtu_dir``'s ObsMask and STL points."""
    from . import dtu_eval
    from .export import export_blocks_mesh
    from .quali import qualitative_eval
    from .quant import quantitative_eval

    run_dir = path_mkdir(run_dir)
    if quali:
        qualitative_eval(model, params, test_loader,
                         path_mkdir(run_dir / "quali_eval"), **(quali_kwargs or {}))
    scores = quantitative_eval(model, params, test_loader, lpips=lpips)
    print_log((f"[{label}] " if label else "") + "final_scores: "
              + ", ".join("{}={:.5f}".format(k, v) for k, v in scores.items()))
    write_scores_tsv(run_dir / "final_scores.tsv", scores)

    if dataset.name == "dtu":
        scan_id = int(dataset.tag.replace("scan", ""))
        scale = np.asarray(dataset.scale_mat)
        verts, faces = export_blocks_mesh(model, params, filter_transparent=True)
        verts = verts @ scale[:3, :3].T + scale[:3, 3]
        dtu_eval.evaluate_mesh(verts, faces, scan_id, Path(dtu_dir), run_dir,
                               save_viz=False)

    if quali:
        gallery_from_run_dir(run_dir / "quali_eval")
    return scores
