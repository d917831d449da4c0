"""A toy cell written as files only (a configuration, a workload and a
copy of a traffic, of the loops and of the metric readers) in a directory of its own,
at a size the CPU runs in seconds: 16x20 renders, 8 views, 2 blocks,
16-texel textures, K=2, batches of 2."""

import argparse
import json
import shutil
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def write_toy(root, mix):
    """Write cell ``toy.<mix>`` under ``root``; -> (root, args for
    ``run.run``)."""
    root = Path(root)
    for d in ("workloads", "configs", "traffic", "metrics", "limits", "entries"):
        (root / d).mkdir(parents=True, exist_ok=True)
    for d in ("metrics", "entries"):
        for f in (BENCH / d).glob("*.py"):
            shutil.copy(f, root / d)
    traffic = json.loads((BENCH / "traffic" / f"{mix}.json").read_text())
    (root / "traffic" / f"{mix}.json").write_text(json.dumps(traffic))
    c = json.loads((BENCH / "configs" / "dtu24.json").read_text())
    c["name"] = "toy"
    c["scan"].update(n_views=8, write_size=[16, 20])
    cf = c["config"]
    cf["dataset"]["img_size"] = [16, 20]
    cf["model"]["mesh"].update(n_blocks=2, txt_size=16)
    cf["model"]["renderer"]["faces_per_pixel"] = 2
    cf["training"].update(batch_size=2, steps_per_call=2, train_stat_interval=2,
                          val_stat_interval=4)
    (root / "configs" / "toy.json").write_text(json.dumps(c))
    name = f"toy.{mix}"
    (root / "workloads" / f"{name}.json").write_text(json.dumps(
        {"name": name, "config": "toy", "traffic": mix, "chips": 1, "why": "toy"}))
    (root / "limits" / f"{name}.json").write_text(json.dumps(
        {"loss1": 1e-4, "loss": 1e-4, "grad": 1e-3, "change": 1e-2}))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [name] if any(w.endswith(f".{mix}") or
                                           (mix == "fit" and w.endswith(".fit"))
                                           for w in m["workloads"]) else []
    args = argparse.Namespace(workload=name, seed=2**31 + 5, seconds=1.0, trace=0,
                              bench=bench)
    return root, args
