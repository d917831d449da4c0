#!/usr/bin/env python3
"""Run the port's Trainer on one config on the card and hold its losses
and scores beside the reference run's.

    python3 scripts/torch_trainer_run.py [-c synthetic/dtu_shaped.yml]
        [--n-epoches N] [--tag TAG] [--ref runs/synthetic/dtu_shaped_r5]
        [--out runs/trainer_run_out] [--vgg-f32] [--cpu]

The run directory is ``runs/<dataset>/<tag>``. Every 60 s, and at the end,
the small outputs (the metric TSVs, ``training.log``, ``final_scores.tsv``,
``mesh_scores.tsv``) and ``model.pkl`` are copied into ``--out``, so that a
run cut by a time limit leaves its losses and its last checkpoint there (a
run with ``training.resume`` set to that checkpoint replays the
uninterrupted run bitwise). At the end the run's mesh is scored with the
port's ``MeshEvaluator`` at its full size (100,000 points, 100 ICP steps),
and the script prints the card, the run's
wall-clock (the training loop, the final eval and the mesh scoring apart),
``loss_total`` at every iteration both runs logged, and both runs' final
scores and mesh scores. ``--vgg-f32`` runs the VGG16 features in float32
instead of the card's bfloat16 default (the A/B of the features' dtype).
"""

from __future__ import annotations

import argparse
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

SMALL = ("train_metrics.tsv", "val_metrics.tsv", "training.log", "final_scores.tsv",
         "mesh_scores.tsv", "model.pkl")


def copy_small(run_dir, out):
    for name in SMALL:
        if (run_dir / name).exists():
            shutil.copy(run_dir / name, out / name)


def read_tsv(path):
    from dbw_torch.eval.metrics import Metrics

    return Metrics(log_file=path, append=True).read_log()


def main():
    from dbw_torch.eval.mesh_scores import score_run_mesh
    from dbw_torch.eval.metrics import MeshEvaluator
    from dbw_torch.train.trainer import Trainer
    from dbw_torch.utils.config import dump_yaml, load_yaml
    from dbw_torch.utils.logger import create_logger
    from dbw_torch.utils.path import CONFIGS_PATH, RUNS_PATH

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-c", "--config", default="synthetic/dtu_shaped.yml")
    ap.add_argument("--n-epoches", type=int, default=None)
    ap.add_argument("--tag", default="dtu_shaped_torch")
    ap.add_argument("--ref", default="runs/synthetic/dtu_shaped_r5")
    ap.add_argument("--out", default="runs/trainer_run_out")
    ap.add_argument("--vgg-f32", action="store_true",
                    help="float32 VGG16 features (default: bfloat16 on the card)")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (a rehearsal)")
    args = ap.parse_args()
    if not args.cpu:
        if not torch.cuda.is_available():
            print("torch_trainer_run: no CUDA device", file=sys.stderr)
            return 2
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True,
                              text=True, check=True).stdout.strip()
        print(card, flush=True)
    if args.vgg_f32:
        from dbw_torch.losses import vgg

        vgg.default_dtype = lambda device: torch.float32
    cfg = load_yaml(CONFIGS_PATH / args.config)
    if args.n_epoches is not None:
        cfg["training"]["n_epoches"] = args.n_epoches
    run_dir = RUNS_PATH / cfg["dataset"]["name"] / args.tag
    if run_dir.exists():
        shutil.rmtree(run_dir)
    run_dir.mkdir(parents=True)
    out = ROOT / args.out
    out.mkdir(parents=True, exist_ok=True)
    create_logger(run_dir)
    dump_yaml(cfg, run_dir / Path(args.config).name)
    dump_yaml(cfg, out / Path(args.config).name)

    stop = threading.Event()

    def copier():
        while not stop.wait(60.0):
            copy_small(run_dir, out)

    th = threading.Thread(target=copier, daemon=True)
    th.start()
    seed = cfg["training"].get("seed", 4321)
    t0 = time.perf_counter()
    tr = Trainer(cfg, run_dir, device="cpu" if args.cpu else "cuda", seed=seed)
    t_built = time.perf_counter()
    t_loop = []
    plots = tr.save_metric_plots
    tr.save_metric_plots = lambda: (t_loop.append(time.perf_counter()), plots())[1]
    t_eval = []
    evaluate = tr.evaluate
    tr.evaluate = lambda: (t_eval.append(time.perf_counter()), evaluate())[1]
    try:
        tr.run(seed=seed)
    finally:
        stop.set()
        th.join()
        copy_small(run_dir, out)
    t_end = time.perf_counter()
    steps = tr.n_epoches * tr.n_batches
    print(f"{args.config}, n_epoches {tr.n_epoches}: {steps} steps; built in "
          f"{t_built - t0:.1f} s, training loop {t_loop[0] - t_built:.1f} s "
          f"({steps / (t_loop[0] - t_built):.3f} steps/s, interval work included), "
          f"plots and videos {t_eval[0] - t_loop[0]:.1f} s, final eval "
          f"{t_end - t_eval[0]:.1f} s, total {t_end - t0:.1f} s", flush=True)
    t_mesh = time.perf_counter()
    score_run_mesh(run_dir, MeshEvaluator(device="cpu" if args.cpu else "cuda"))
    print(f"mesh scores (MeshEvaluator, 100,000 points, 100 ICP steps) in "
          f"{time.perf_counter() - t_mesh:.1f} s", flush=True)
    copy_small(run_dir, out)

    if not args.cpu:
        print(card, flush=True)
        (out / "card.txt").write_text(card + "\n")
    mine = read_tsv(run_dir / "train_metrics.tsv")
    ref = read_tsv(ROOT / args.ref / "train_metrics.tsv")
    common = sorted(set(mine["iteration"].astype(int)) & set(ref["iteration"].astype(int)))
    print("iteration\tloss_total (port)\tloss_total (ref)", flush=True)
    for it in common:
        a = mine["loss_total"][mine["iteration"] == it][0]
        b = ref["loss_total"][ref["iteration"] == it][0]
        print(f"{it}\t{a:.6f}\t{b:.6f}")
    for scores in ("final_scores.tsv", "mesh_scores.tsv"):
        for name, d in (("port", run_dir), ("ref", ROOT / args.ref)):
            p = d / scores
            if p.exists():
                print(f"{scores} ({name}):\n{p.read_text().strip()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
