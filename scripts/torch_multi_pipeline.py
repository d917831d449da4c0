#!/usr/bin/env python3
"""The multi-seed protocol with the PyTorch port (the twin of
scripts/multi_pipeline.py): several seeds of one scene trained together on
one card or on several, the seed of the lowest train loss selected and
evaluated.

    python3 scripts/torch_multi_pipeline.py -t TAG -c synthetic/dtu_shaped.yml \\
        --seeds 11 22 33 44 55 [--n-traj-videos 5] [--per-seed-full] [--resume]
        [--out DIR] [--resume-from DIR] [--cpu]
    torchrun --nproc-per-node 4 scripts/torch_multi_pipeline.py -t TAG \\
        -c synthetic/dtu_shaped.yml --seeds 11 22 33 44 55 [--n-data N] [--n-spatial N]

Under torchrun the ranks form the JAX package's device mesh, one rank per
card (``dbw_torch/parallel/mesh.py``; NCCL, or gloo when ranks share a
card, and gloo with ``--cpu``): ``--n-data`` splits each batch's views and
``--n-spatial`` each view's rows over the ranks of a seed; without them
the seeds spread over the ranks first. Rank 0 writes the run directory.

The run directory ``runs/<dataset>/<TAG>`` is the JAX protocol's: per seed
``seed{s}/model.pkl``, ``seed{s}/val_metrics.tsv`` and
``seed{s}/final_scores.tsv`` (``--per-seed-full``: each seed's full
evaluation), and ``train_metrics.tsv``, ``seed_selection.tsv``, the best
seed's ``model.pkl``, ``final_scores.tsv`` and ``quali_eval/``.
``--resume`` continues from the run directory's ``multi_model.pkl``.

A run that spans several sessions of a machine that keeps no disk:
``--out`` copies the small outputs (the TSVs, the log) and
``multi_model.pkl`` into DIR every 60 s and at the end, so a run cut by a
time limit leaves its losses and its last checkpoint there
(``multi_model.pkl`` is left out when it is larger than OUT_MAX_MIB, which
holds two flagship seeds: a seed's parameters and Adam moments are 28.3 MB,
and DIR is meant to stay small enough to carry off the machine);
``--resume-from DIR`` copies such a directory into the run directory and
resumes from it.
Each seed's mesh: ``scripts/torch_eval_mesh_chamfer.py --run RUN --ckpt
seed{s}/model.pkl``. Runs on the card unless ``--cpu``.
"""

import argparse
import random
import shutil
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

SMALL = ("train_metrics.tsv", "training.log", "seed_selection.tsv",
         "final_scores.tsv", "mesh_scores.tsv", "val_metrics.tsv")
CKPT = "multi_model.pkl"
OUT_MAX_MIB = 56


def copy_out(run_dir, out, max_bytes):
    """The run's small files (its own and its seeds') and, within
    ``max_bytes``, its protocol checkpoint, into ``out`` (each file through a
    temporary name, so a cut copy leaves the previous one)."""
    files = [f for f in run_dir.rglob("*") if f.is_file() and (
        f.name in SMALL or f.suffix == ".yml"
        or (f.name == CKPT and f.stat().st_size <= max_bytes))]
    for f in files:
        dst = out / f.relative_to(run_dir)
        dst.parent.mkdir(parents=True, exist_ok=True)
        tmp = dst.with_name(dst.name + ".tmp")
        shutil.copy(f, tmp)
        tmp.replace(dst)


def main():
    from dbw_torch.parallel.mesh import close_distributed, init_distributed

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("-t", "--tag", required=True)
    p.add_argument("-c", "--config", required=True)
    p.add_argument("-d", "--default", default=None)
    p.add_argument("--n-seeds", type=int, default=5)
    p.add_argument("--seeds", type=int, nargs="*", default=None)
    p.add_argument("--n-data", type=int, default=None,
                   help="data-axis width: ranks that split each batch's views")
    p.add_argument("--n-spatial", type=int, default=None,
                   help="pixel-band axis width: ranks that split each view's rows")
    p.add_argument("--resume", action="store_true",
                   help="continue from the run dir's multi_model.pkl")
    p.add_argument("--per-seed-full", action="store_true",
                   help="the full evaluation for every seed, not just the best")
    p.add_argument("--n-traj-videos", type=int, default=None,
                   help="trajectory videos of the first N eval views only")
    p.add_argument("--out", default=None, help="copy the small outputs and the "
                   "protocol checkpoint here every 60 s and at the end")
    p.add_argument("--resume-from", default=None, help="copy a directory written "
                   "by --out into the run dir and resume from it")
    p.add_argument("--cpu", action="store_true", help="run on the CPU (default: the card)")
    args = p.parse_args()
    device = init_distributed("cpu" if args.cpu else "cuda")
    try:
        run(args, device)
    finally:
        close_distributed()


def run(args, device):
    import torch.distributed as dist

    from dbw_torch.parallel.mesh import world
    from dbw_torch.train.multi_seed import MultiSeedTrainer
    from dbw_torch.utils.config import dump_yaml, load_yaml
    from dbw_torch.utils.logger import create_logger, print_log
    from dbw_torch.utils.misc import path_mkdir
    from dbw_torch.utils.path import CONFIGS_PATH, RUNS_PATH

    rank, world_size = world()
    default_path = CONFIGS_PATH / args.default if args.default else None
    cfg = load_yaml(CONFIGS_PATH / args.config, default_path)
    seeds = [args.seeds or [random.randint(1, 1_000_000) for _ in range(args.n_seeds)]]
    if world_size > 1:
        dist.broadcast_object_list(seeds, src=0)  # one draw for every rank
    seeds = seeds[0]
    run_dir = RUNS_PATH / cfg["dataset"]["name"] / args.tag
    resume = args.resume or bool(args.resume_from)
    if rank == 0:
        path_mkdir(run_dir)
        if args.resume_from:
            shutil.copytree(args.resume_from, run_dir, dirs_exist_ok=True)
        create_logger(run_dir)
        dump_yaml(cfg, run_dir / Path(args.config).name)
        print_log(f"torch_multi_pipeline: seeds={seeds}, run_dir={run_dir}, device={device}, "
                  f"ranks={world_size}")
    if world_size > 1:
        dist.barrier()  # the run directory in place before any rank reads it

    out = path_mkdir(ROOT / args.out) if args.out and rank == 0 else None
    stop = threading.Event()
    max_bytes = OUT_MAX_MIB * 2**20

    def copier():
        while not stop.wait(60.0):
            copy_out(run_dir, out, max_bytes)

    th = threading.Thread(target=copier, daemon=True)
    if out is not None:
        th.start()
    t0 = time.perf_counter()
    try:
        trainer = MultiSeedTrainer(cfg, run_dir, seeds, resume=resume, n_data=args.n_data,
                                   n_spatial=args.n_spatial, device=device)
        t_built = time.perf_counter()
        trainer.run()
        t_run = time.perf_counter()
        qk = None if args.n_traj_videos is None else dict(n_traj_videos=args.n_traj_videos)
        trainer.evaluate(per_seed_full=args.per_seed_full, quali_kwargs=qk)
        t_eval = time.perf_counter()
        steps = ((trainer.n_epoches - trainer.epoch_start + 1) * trainer.n_batches
                 - trainer.batch_start + 1)
        S = len(trainer.seeds)
        if rank == 0:
            print_log(f"torch_multi_pipeline: built in {t_built - t0:.1f} s; {steps} steps "
                      f"of {S} seeds in {t_run - t_built:.1f} s "
                      f"({S * steps / (t_run - t_built):.3f} seed-steps/s, interval work "
                      f"included); final eval {t_eval - t_run:.1f} s")
    finally:
        stop.set()
        if out is not None:
            th.join()
            copy_out(run_dir, out, max_bytes)


if __name__ == "__main__":
    main()
