"""Toy cells written as files only (a configuration, a workload and a copy
of a traffic, of the loops and of the metric readers) in a directory of
their own, at a size the CPU runs in seconds, one for each scan layout:

- ``toy.<mix>``: ``dtu24`` cut to 16x20 renders, 8 views, 2 blocks,
  16-texel textures, K=2, batches of 2, on an IDR scan;
- ``toy_ns.<mix>``: campanile's own sections (``configs/nerfstudio/
  campanile.yml``: the nerfstudio loader with ``downscale_factor`` 2 and
  no ``img_size``, its scene placement and schedule, one step a call) cut
  the same way, on a nerfstudio capture of a 36x64 raw frame (18x32
  renders) with square pixels and an off-centre principal point."""

import argparse
import copy
import json
import shutil
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent

# configs/nerfstudio/campanile.yml as the harness runs it (its loader's
# n_workers dropped, as in the benchmark's configurations)
CAMPANILE = {
    "model": {
        "name": "dbw",
        "mesh": {"n_blocks": 10, "S_world": 1, "R_world": [-90, 20, 0],
                 "T_world": [-1.25, 0, -0.25], "T_range": [1, 0.5, 1], "txt_size": 256},
        "renderer": {"faces_per_pixel": 10, "cameras": {"name": "perspective"},
                     "detach_bary": True, "z_clip": 0.001},
        "rend_optim": {"coarse_learning": 250, "decimate_txt": 125, "decimate_factor": 8,
                       "kill_blocks": True, "decouple_rendering": True,
                       "opacity_noise": True},
        "loss": {"rgb_weight": 1, "perceptual_weight": 0.1, "parsimony_weight": 0.01,
                 "tv_weight": 0.1, "overlap_weight": 1},
    },
    "training": {
        "batch_size": 4,
        "optimizer": {"name": "adam", "lr": 5.0e-3, "texture": {"lr": 5.0e-2}},
        "scheduler": {"name": "multi_step", "gamma": [0.1, 0.1], "milestones": [300]},
        "n_epoches": 320, "train_stat_interval": 50, "val_stat_interval": 100,
        "seed": 222213, "resume": None,
    },
    "dataset": {"name": "nerfstudio", "tag": "campanile", "downscale_factor": 2},
}


# The fit mix's metrics: no cell of BENCHMARK.json runs the fit traffic
# (dtu24.fit left it: a host-bound rate on the host clock holds no bound),
# but its loop, traffic and readers stay, and the toy fit cell reports them.
FIT_METRICS = {
    "end_to_end": [("fit_steps_per_s", "steps/s")],
    "per_layer": [("device_idle_share.fit", "%"), ("launches_per_step.fit", "launches/step"),
                  ("interval_ms.fit", "ms"), ("kernel_roofline.fit", "%"),
                  ("step_mfu.fit", "%"), ("gather_ms.fit", "ms"),
                  ("forward_host_ms.fit", "ms"), ("backward_host_ms.fit", "ms")],
}


def toy_config(layout):
    """The toy configuration of a scan layout, ``idr`` or ``nerfstudio``."""
    c = json.loads((BENCH / "configs" / "dtu24.json").read_text())
    if layout == "idr":
        c["name"] = "toy"
        c["scan"].update(n_views=8, write_size=[16, 20])
        c["config"]["dataset"]["img_size"] = [16, 20]
    else:
        c["name"] = "toy_ns"
        c["scan"] = {"layout": "nerfstudio", "loader": "nerfstudio", "n_views": 8,
                     "raw_size": [36, 64], "write_size": [18, 32],
                     "intrinsics": {"fl_x": 45.0, "fl_y": 45.0, "cx": 33.5, "cy": 17.25}}
        c["config"] = copy.deepcopy(CAMPANILE)
    cf = c["config"]
    cf["model"]["mesh"].update(n_blocks=2, txt_size=16)
    cf["model"]["renderer"]["faces_per_pixel"] = 2
    cf["training"].update(batch_size=2, train_stat_interval=2, val_stat_interval=4)
    if layout == "idr":
        cf["training"]["steps_per_call"] = 2
    return c


def write_toy(root, mix, layout="idr"):
    """Write cell ``toy.<mix>`` (``toy_ns.<mix>`` for the nerfstudio layout)
    under ``root``; -> (root, args for ``run.run``)."""
    root = Path(root)
    for d in ("workloads", "configs", "traffic", "metrics", "limits", "entries"):
        (root / d).mkdir(parents=True, exist_ok=True)
    for d in ("metrics", "entries"):
        for f in (BENCH / d).glob("*.py"):
            shutil.copy(f, root / d)
    traffic = json.loads((BENCH / "traffic" / f"{mix}.json").read_text())
    (root / "traffic" / f"{mix}.json").write_text(json.dumps(traffic))
    c = toy_config(layout)
    (root / "configs" / f"{c['name']}.json").write_text(json.dumps(c))
    name = f"{c['name']}.{mix}"
    (root / "workloads" / f"{name}.json").write_text(json.dumps(
        {"name": name, "config": c["name"], "traffic": mix, "chips": 1, "why": "toy"}))
    (root / "limits" / f"{name}.json").write_text(json.dumps(
        {"loss1": 1e-4, "loss": 1e-4, "grad": 1e-3, "change": 1e-2}))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [name] if any(w.endswith(f".{mix}") for w in m["workloads"]) else []
    if mix == "fit":
        for section, entries in FIT_METRICS.items():
            known = {m["name"] for m in bench[section]}
            bench[section] += [{"name": n, "unit": u, "workloads": [name]}
                               for n, u in entries if n not in known]
    args = argparse.Namespace(workload=name, seed=2**31 + 5, seconds=1.0, trace=0,
                              bench=bench)
    return root, args
