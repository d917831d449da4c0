#!/usr/bin/env python3
"""The multi-scene trainer with the PyTorch port (the twin of
scripts/multi_scene_pipeline.py): N scenes of one model config trained
together on one card or on several, each into its own run directory.

    python3 scripts/torch_multi_scene_pipeline.py -t TAG \\
        -c dtu/scan24.yml dtu/scan37.yml [-d dtu/default.yml] \\
        [--n-seeds 1] [--resume] [--no-quali] [--cpu]
    torchrun --nproc-per-node 4 scripts/torch_multi_scene_pipeline.py -t TAG \\
        -c dtu/scan24.yml dtu/scan37.yml [--n-data 2]

Under torchrun, when the scenes divide the ranks, they form the JAX
package's (scene, seed, data) mesh, one rank per card; rank 0 writes the
run directories.

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
    from dbw_torch.parallel.mesh import close_distributed, init_distributed, world
    from dbw_torch.train.multi_scene import MultiSceneTrainer
    from dbw_torch.utils.config import dump_yaml, load_yaml
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
                   help="data-axis width: ranks of a scene that split each batch's views")
    p.add_argument("--resume", action="store_true",
                   help="continue from the first run dir's multi_scene_model.pkl")
    p.add_argument("--no-quali", action="store_true",
                   help="skip the per-scene qualitative artifacts")
    p.add_argument("--cpu", action="store_true", help="run on the CPU (default: the card)")
    args = p.parse_args()
    device = init_distributed("cpu" if args.cpu else "cuda")
    rank = world()[0]
    try:
        default_path = CONFIGS_PATH / args.default if args.default else None
        cfgs, run_dirs = [], []
        for c in args.configs:
            cfg = load_yaml(CONFIGS_PATH / c, default_path)
            run_dir = RUNS_PATH / cfg["dataset"]["name"] / args.tag / Path(c).stem
            if rank == 0:
                dump_yaml(cfg, path_mkdir(run_dir) / Path(c).name)
            cfgs.append(cfg)
            run_dirs.append(run_dir)
        if rank == 0:
            create_logger(run_dirs[0].parent)
            print_log(f"torch_multi_scene_pipeline: {len(cfgs)} scenes -> "
                      f"{[str(d) for d in run_dirs]}, device={device}")
        trainer = MultiSceneTrainer(cfgs, run_dirs, n_seeds=args.n_seeds, n_data=args.n_data,
                                    resume=args.resume, device=device)
        trainer.run()
        trainer.evaluate(quali=not args.no_quali)
    finally:
        close_distributed()


if __name__ == "__main__":
    main()
