"""The final evaluation of one run (PyTorch port of dbw_tpu/eval/full.py,
reference trainer.py:241-272): ``final_scores.tsv`` (quantitative image
metrics) and ``quali_eval/`` (textures, OBJ meshes, renders, videos, an
HTML gallery). The DTU branch (the official Chamfer protocol and
``dtu_scores.tsv``) is not ported yet."""

from __future__ import annotations

from ..utils.html import gallery_from_run_dir
from ..utils.logger import print_log
from ..utils.misc import path_mkdir


def write_scores_tsv(path, scores):
    with open(path, "w") as f:
        f.write("\t".join(scores.keys()) + "\n")
        f.write("\t".join(map("{:.5f}".format, scores.values())) + "\n")


def evaluate_run(model, params, test_loader, dataset, run_dir, quali_kwargs=None):
    """Write the final evaluation artifacts of one scene; returns the final
    scores. ``quali_kwargs`` go to ``qualitative_eval`` (NV, n_views,
    render_videos, n_traj_videos)."""
    from .quali import qualitative_eval
    from .quant import quantitative_eval

    if dataset.name == "dtu":
        raise NotImplementedError(
            "the DTU evaluation protocol is not ported yet (ROADMAP.md queue "
            "1, the DTU/BMVS loaders with eval/dtu_eval.py)")
    run_dir = path_mkdir(run_dir)
    qualitative_eval(model, params, test_loader, path_mkdir(run_dir / "quali_eval"),
                     **(quali_kwargs or {}))
    scores = quantitative_eval(model, params, test_loader)
    print_log("final_scores: "
              + ", ".join("{}={:.5f}".format(k, v) for k, v in scores.items()))
    write_scores_tsv(run_dir / "final_scores.tsv", scores)
    gallery_from_run_dir(run_dir / "quali_eval")
    return scores
