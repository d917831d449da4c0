"""The cost of ``dbw_torch.utils.profiling``'s recording on a benchmark
cell's loop, on one card:

    python3 scripts/torch_profiling_cost.py --workload dtu24.fit --seed 5800000001 \
        [--pairs 3] [--seconds 10] [--out chiprun_out/cost.json]

One process builds the cell as ``benchmark/run.py`` does (its scan from
``--seed``, its loop, the first steps and the interval work in set-up),
then runs 2 x ``--pairs`` windows of ``--seconds`` each, recording off and
on in turns (off, on, on, off, off, on, ...). Each window's rate is the
cell's rate metric: its work over its seconds, closed by a synchronize.
For each window with recording on, the median over its steps of each
span's host and stream ms and of the leaves' share of ``dbw.step``'s
stream ms. Prints one JSON line a window, then the medians of both sides
and the overhead."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:1] = [str(ROOT)]

import argparse  # noqa: E402
import json  # noqa: E402
import shutil  # noqa: E402
import statistics  # noqa: E402
import tempfile  # noqa: E402
from contextlib import nullcontext  # noqa: E402


def layer_medians(rows):
    """Median over the steps of ``rows`` (``profiling.summary()``) of each
    name's host and stream ms, and the leaves' share of the step's stream
    ms."""
    from dbw_torch.utils import profiling

    steps = [r for r in rows if r["step"] is not None]
    out = {}
    for kind in ("host_ms", "stream_ms"):
        names = sorted({n for r in steps for n in r[kind]})
        out[kind] = {n: statistics.median(r[kind].get(n, 0.0) for r in steps) for n in names}
    cover = [sum(v for n, v in r["stream_ms"].items()
                 if n in profiling.LEAVES or n.startswith(profiling.BACKWARD))
             / r["stream_ms"]["dbw.step"] for r in steps if r["stream_ms"]]
    out["leaf_share_of_step_stream"] = statistics.median(cover) if cover else None
    out["counters"] = steps[-1]["counters"] if steps else {}
    out["steps"] = len(steps)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--pairs", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_profiling_cost: no CUDA card", file=sys.stderr)
        return 3
    from benchmark import harness, scan
    from dbw_torch.utils import profiling

    root = ROOT / "benchmark"
    tmp = Path(tempfile.mkdtemp(prefix="dbw_cost_"))
    try:
        cell, config, traffic = harness.load_cell(args.workload, root)
        sc = config["scan"]
        scan.write_scan(tmp / "scans", config["config"]["dataset"]["tag"], args.seed,
                        sc["n_views"], tuple(sc["write_size"]), tuple(sc["raw_size"]))
        cfg = harness.program_config(config, traffic, args.seed, tmp / "scans", root)
        loop = harness.make_loop(cfg, tmp / "run", traffic, harness.Spans(), "cuda", root)
        loop.first_steps()
        loop.warm_intervals()
        torch.cuda.synchronize()
        order = [w for i in range(args.pairs) for w in ((False, True) if i % 2 == 0
                                                        else (True, False))]
        rates = {False: [], True: []}
        windows = []
        for on in order:
            profiling.reset()
            with profiling.recording() if on else nullcontext():
                seconds, steps, work = harness.run_window(loop, args.seconds)
            w = {"recording": on, "rate": work / seconds, "steps": steps, "seconds": seconds}
            if on:
                w["layers"] = layer_medians(profiling.summary())
            profiling.reset()
            rates[on].append(w["rate"])
            windows.append(w)
            print(json.dumps(w), flush=True)
        loop.close()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    off, on = statistics.median(rates[False]), statistics.median(rates[True])
    result = {"workload": args.workload, "seed": args.seed, "rate_metric": traffic["rate_metric"],
              "device": torch.cuda.get_device_name(0), "off": rates[False], "on": rates[True],
              "median_off": off, "median_on": on, "overhead": 1.0 - on / off}
    print(json.dumps(result), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"windows": windows, **result}, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
