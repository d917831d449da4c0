"""The readings that the limits of ``check.py`` are set from, at a cell's
own size, several seeds in one process (the benchmark's runs never run
this):

    python3 benchmark/control.py --workload <cell> --seeds 1 2 3 [--out f.json]

For each seed: the program's first steps (the set-up of a run, without the
window) against the reference; the control, the reference computed one
step below each of the configuration's precisions (TF32 for its float32
with TF32 off, float8 for the inputs and filters of its bfloat16 VGG16
convolutions) in the program's place; TF32 alone, the same with the VGG16
left in bfloat16 (recorded, not required to fail); and the fault of half of
each batch left out (the mean over the rest), the reference so broken in
the program's place. A fault of a step that leaves the state unchanged
reads 1 on ``change`` by construction and needs no run."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:1] = [str(ROOT)]

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import shutil  # noqa: E402
import tempfile  # noqa: E402
import time  # noqa: E402


def readings(workload, seed, tmp, device="cuda", root=ROOT / "benchmark"):
    """{"program", "control", "tf32_alone", "half_batch": compared numbers, for each
    "<name>_at": where its worst readings lie, and "raw": the readings} of
    one seed."""
    import torch

    from benchmark import check, harness, scan

    cell, config, traffic = harness.load_cell(workload, root)
    scan_dir = scan.write(config, tmp / "scans", seed)
    cfg = harness.program_config(config, traffic, seed, tmp / "scans", root)
    loop = harness.make_loop(cfg, tmp / "run", traffic, harness.Spans(), device, root)
    prog = loop.first_steps()
    seeds = list(loop.seeds)
    loop.close()
    del loop
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    args = (cfg, config, traffic, scan_dir, seeds, prog["ids"], device)
    t = time.perf_counter()
    got = {"reference": check.reference_readings(*args)}
    t_ref = time.perf_counter() - t
    got["control"] = check.reference_readings(*args, lowered=check.CONTROL)
    got["tf32_alone"] = check.reference_readings(*args, lowered=("tf32",))
    got["half_batch"] = check.reference_readings(*args, half_batch=True)
    print(f"seed {seed}: the reference {t_ref:.1f} s, all four "
          f"{time.perf_counter() - t:.1f} s", file=sys.stderr)
    ref = got.pop("reference")
    out = {"raw": {"program": prog, "reference": ref, **got}}
    for name, r in (("program", prog), *got.items()):
        where = {}
        out[name] = check.compare(r, ref, where)
        out[name + "_at"] = where
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 3
    out = {}
    for seed in args.seeds:
        tmp = Path(tempfile.mkdtemp(prefix="dbw_control_"))
        try:
            out[seed] = readings(args.workload, seed, tmp)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        print(json.dumps({"seed": seed, **{k: v for k, v in out[seed].items() if k != "raw"}}),
              flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
