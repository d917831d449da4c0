#!/usr/bin/env python3
"""The multi-scene trainer with the PyTorch port (the twin of
scripts/multi_scene_pipeline.py): N scenes of one model config trained
together on one card, each into its own run directory.

    python3 scripts/torch_multi_scene_pipeline.py -t TAG \\
        -c dtu/scan24.yml dtu/scan37.yml [-d dtu/default.yml] \\
        [--n-seeds 1] [--resume] [--no-quali] [--cpu]

Each scene's run directory ``runs/<dataset>/<TAG>/<config stem>`` gets the
single-scene Trainer's outputs: the metric TSVs, its best seed's
``model.pkl`` and the final evaluation; the stacked
``multi_scene_model.pkl`` is in the first one (``--resume`` continues from
it). Runs on the card unless ``--cpu``.
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main():
    from dbw_torch.train.multi_scene import MultiSceneTrainer
    from dbw_torch.utils.config import dump_yaml, load_yaml
    from dbw_torch.utils.device import resolve_device
    from dbw_torch.utils.logger import create_logger, print_log
    from dbw_torch.utils.misc import path_mkdir
    from dbw_torch.utils.path import CONFIGS_PATH, RUNS_PATH

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("-t", "--tag", required=True)
    p.add_argument("-c", "--configs", required=True, nargs="+",
                   help="one config per scene (one model and training config; "
                   "the dataset and training.seed may differ)")
    p.add_argument("-d", "--default", default=None)
    p.add_argument("--n-seeds", type=int, default=1,
                   help="seeds per scene (the best selected per scene)")
    p.add_argument("--n-data", type=int, default=None,
                   help="data-axis width; above 1 needs several cards and raises")
    p.add_argument("--resume", action="store_true",
                   help="continue from the first run dir's multi_scene_model.pkl")
    p.add_argument("--no-quali", action="store_true",
                   help="skip the per-scene qualitative artifacts")
    p.add_argument("--cpu", action="store_true", help="run on the CPU (default: the card)")
    args = p.parse_args()
    device = resolve_device("cpu" if args.cpu else "cuda")

    default_path = CONFIGS_PATH / args.default if args.default else None
    cfgs, run_dirs = [], []
    for c in args.configs:
        cfg = load_yaml(CONFIGS_PATH / c, default_path)
        run_dir = path_mkdir(RUNS_PATH / cfg["dataset"]["name"] / args.tag / Path(c).stem)
        dump_yaml(cfg, run_dir / Path(c).name)
        cfgs.append(cfg)
        run_dirs.append(run_dir)
    create_logger(run_dirs[0].parent)
    print_log(f"torch_multi_scene_pipeline: {len(cfgs)} scenes -> "
              f"{[str(d) for d in run_dirs]}, device={device}")
    trainer = MultiSceneTrainer(cfgs, run_dirs, n_seeds=args.n_seeds, n_data=args.n_data,
                                resume=args.resume, device=device)
    trainer.run()
    trainer.evaluate(quali=not args.no_quali)


if __name__ == "__main__":
    main()
