#!/usr/bin/env python3
"""Score one run's checkpoint with the JAX package's mesh scorer and with
the port's, on the same GT points (a comparison, like the tests: it runs
the JAX package on the CPU, in subprocesses).

    python3 scripts/torch_mesh_crosscheck.py --run DIR [--out DIR]

DIR holds a ``model.pkl`` and the run's dumped config yml (a synthetic
dataset). The script scores copies of it in a temporary directory:
1. the JAX package's unmodified ``scripts/eval_mesh_chamfer.py --fast-cpu``
   on the CPU (JAX_PLATFORMS=cpu), against the JAX dataset's GT points;
2. the JAX dataset's GT points written to ``jax_gt.ply`` (the JAX package's
   ``sample_gt_points`` draws from ``jax.random``, which the port cannot
   replay, so the port's dataset holds other points of the same surfaces);
3. the port's ``scripts/torch_eval_mesh_chamfer.py`` in ``--fast-cpu`` mode
   against those JAX points, on the card and on the CPU, and against the
   port dataset's own GT points on the card; then at its full size
   (100,000 points, 100 ICP steps) on the card against both GT sets.
It prints the card, each scorer's scores and seconds, and the relative
gap of each port score to the JAX scorer's on the same GT; each
``mesh_scores.tsv`` and ``jax_gt.ply`` are kept in ``--out``.
"""

import argparse
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
JAX_GT = """
import sys
import numpy as np
sys.path.insert(0, {root!r})
from dbw_tpu.data.synthetic import make_synthetic_scene
from dbw_tpu.utils.config import load_yaml
from dbw_tpu.utils.obj_io import save_ply
d = load_yaml({yml!r})["dataset"]
ds, _, _ = make_synthetic_scene((8, 8), n_views=1, seed=d.get("seed", 0),
                                n_blocks=d.get("gt_n_blocks", 3),
                                block_scale=d.get("gt_scale", 1.0),
                                dist=d.get("gt_dist", 3.0))
save_ply({out!r}, np.asarray(ds.pc_gt))
print("JAX GT points:", len(ds.pc_gt))
"""


def run(cmd, env=None):
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True)
    dt = time.perf_counter() - t0
    if proc.returncode != 0:
        sys.exit(f"{cmd[:3]} failed ({proc.returncode}):\n{proc.stdout[-3000:]}\n"
                 f"{proc.stderr[-3000:]}")
    return proc.stdout, dt


def read_scores(run_dir):
    head, vals = (run_dir / "mesh_scores.tsv").read_text().splitlines()[:2]
    return dict(zip(head.split("\t"), map(float, vals.split("\t"))))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--run", required=True)
    ap.add_argument("--out", default="chiprun_out/mesh_crosscheck")
    args = ap.parse_args()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    src, out = ROOT / args.run, ROOT / args.out
    out.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory() as tmp:
        crosscheck(src, Path(tmp), out)


def crosscheck(src, work, out):
    dirs = {}
    for name in ("jax", "port_jaxgt", "port_cpu_jaxgt", "port_portgt", "port_full_jaxgt",
                 "port_full_portgt"):
        dirs[name] = work / name
        dirs[name].mkdir(parents=True)
        for f in ("model.pkl", *[p.name for p in src.glob("*.yml")]):
            shutil.copy(src / f, dirs[name] / f)
    yml = sorted(dirs["jax"].glob("*.yml"))[0]
    cpu_env = dict(os.environ, JAX_PLATFORMS="cpu", CUDA_VISIBLE_DEVICES="")

    results = {}
    _, dt = run([sys.executable, "scripts/eval_mesh_chamfer.py", "--run",
                 str(dirs["jax"]), "--fast-cpu"], env=cpu_env)
    results["jax"] = (read_scores(dirs["jax"]), dt, "JAX scorer --fast-cpu, CPU, JAX GT")
    gt = out / "jax_gt.ply"
    txt, _ = run([sys.executable, "-c", JAX_GT.format(root=str(ROOT), yml=str(yml),
                                                     out=str(gt))], env=cpu_env)
    print(txt.strip(), flush=True)
    twin = [sys.executable, "scripts/torch_eval_mesh_chamfer.py", "--run"]
    for name, extra, label in (
            ("port_jaxgt", ["--fast-cpu", "--gt-ply", str(gt)],
             "port scorer --fast-cpu, card, JAX GT"),
            ("port_cpu_jaxgt", ["--fast-cpu", "--gt-ply", str(gt), "--cpu"],
             "port scorer --fast-cpu, CPU, JAX GT"),
            ("port_portgt", ["--fast-cpu"], "port scorer --fast-cpu, card, port GT"),
            ("port_full_jaxgt", ["--gt-ply", str(gt)],
             "port scorer full size, card, JAX GT"),
            ("port_full_portgt", [], "port scorer full size, card, port GT")):
        _, dt = run(twin + [str(dirs[name])] + extra)
        results[name] = (read_scores(dirs[name]), dt, label)

    for name, d in dirs.items():
        shutil.copy(d / "mesh_scores.tsv", out / f"{name}_mesh_scores.tsv")
    ref = results["jax"][0]
    for name, (scores, dt, label) in results.items():
        gaps = ", ".join(f"{k} {abs(v - ref[k]) / abs(ref[k]):.3g}" for k, v in scores.items()
                         if k in ref)
        print(f"{label}: " + ", ".join(f"{k}={v:.6f}" for k, v in scores.items())
              + f" ({dt:.1f} s, process included); relative gap to the JAX scorer: {gaps}",
              flush=True)


if __name__ == "__main__":
    main()
