"""The benchmark of the PyTorch port (``dbw_torch``) on one H100.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

One process a run, from the root of a checkout. It finds the card (no
card, or fewer than the cell asks for: exit 3, no result), writes the
cell's scan from ``--seed`` under TMPDIR in its configuration's layout
(``scan.py``), builds the program on it (the kernels build once per
checkout into ``.dbw_torch_build/``), runs the traffic's first steps and
warms its interval work (set-up), measures for
``--seconds`` (``--trace 1``: with the profiler over a steady part), then
checks the first steps against the plain reference (``check.py``) and
prints one JSON line: ``correct``, ``attempted``, ``failed``, ``metrics``
(the cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device`` (with ``--trace 1`` ``busy_s`` and ``window_s`` of the traced
span), with ``--trace 1`` ``breakdown``, and last ``checks``: each
compared number with its limit, which also close standard error.

A cell is ``workloads/<cell>.json``; it names a configuration
(``configs/<config>.json``) and a traffic (``traffic/<traffic>.json``),
whose ``entry`` names its loop (``entries/<entry>.py``); its compared
numbers' limits are ``limits/<cell>.json``; a per-layer metric is
``metrics/<metric>.py``, whose ``read(ctx)`` returns a number or None.
``BENCHMARK.json`` at the root says which metrics a cell reports.
"""

import os
import sys
import time
from pathlib import Path

T_IMPORT = time.time()
ROOT = Path(__file__).resolve().parents[1]
# the repository's root, not this directory, heads the import path: the
# harness's modules are imported as the package ``benchmark``
sys.path[:1] = [str(ROOT)]

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import tempfile  # noqa: E402

# the JAX side of the repository: none of it may be loaded by a run
BANNED_MODULES = ("jax", "jaxlib", "flax", "dbw_tpu", "__graft_entry__", "bench")
# settings of the program's environment that would change the cell: the
# VGG and LPIPS weights (the cells use the seeded random filters) and the
# seed executor (the protocol runs batched)
PINNED_ENV = ("DBW_VGG_WEIGHTS", "DBW_LPIPS_WEIGHTS", "DBW_SEED_EXEC")


def process_age():
    """Seconds since this process started."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time() - T_IMPORT


def banned_loaded():
    return sorted({m.split(".")[0] for m in sys.modules} & set(BANNED_MODULES))


def power_limit():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else None
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return None


def load_reader(name, root):
    from benchmark.harness import load_file

    return load_file(Path(root) / "metrics" / f"{name}.py",
                     "bench_metric_" + name.replace(".", "_")).read


def isolate_caches():
    """Build and kernel caches inside the checkout, at fixed paths."""
    cache = ROOT / ".bench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ.setdefault("USE_FLAX", "0")
    for k in PINNED_ENV:
        os.environ.pop(k, None)


def traced_counts(cfg, config, scan_dir, state, ids_list, n_slots, device):
    """The counts of the traced steps, summed: ``counts.record.step_counts``
    of each traced step's views on the parameters and at the epoch that
    the tracer found when it started."""
    import torch

    from benchmark import check, harness
    from benchmark.counts.record import step_counts

    model, (imgs, R, T) = check.reference_model(cfg, config, scan_dir, device)
    phase = model.phase_for_epoch(state["epoch"] - 1, training=True)
    params = {k: v.to(device) for k, v in state["params"].items()}
    gen = torch.Generator(device=device).manual_seed(0)
    total = {"steps": len(ids_list), "kernel_flops": 0, "kernel_bound_s": 0.0, "vgg_flops": 0}
    for ids in ids_list:
        idx = torch.from_numpy(harness.pad_ids(ids, cfg["training"]["batch_size"])[0]).to(device)
        c = step_counts(model, params, phase, imgs[idx], R[idx].repeat(n_slots, 1, 1),
                        T[idx].repeat(n_slots, 1), gen)
        for k in ("kernel_flops", "kernel_bound_s", "vgg_flops"):
            total[k] += c[k]
    return total


def run(args, tmp, root, device="cuda"):
    """One run of cell ``args.workload`` in the scratch directory ``tmp``
    -> the result's dict (without ``device``'s card fields)."""
    import torch

    from benchmark import check, harness, scan
    from benchmark.tracer import Tracer

    cell, config, traffic = harness.load_cell(args.workload, root)
    scan_root = tmp / "scans"
    scan_dir = scan.write(config, scan_root, args.seed)
    cfg = harness.program_config(config, traffic, args.seed, scan_root, root)
    spans = harness.Spans()
    loop = harness.make_loop(cfg, tmp / "run", traffic, spans, device, root)
    prog = loop.first_steps()
    loop.warm_intervals()
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.synchronize()
    setup_s = process_age()

    tracer = Tracer(traffic["trace_after_s"], traffic["trace_steps"]) if args.trace else None
    w0 = time.perf_counter()
    window_s, steps, work = harness.run_window(loop, args.seconds, tracer, sync=on_card)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    failed = loop.failed_steps()
    summary = tracer.summary() if tracer else None
    seeds, stacked, step_ids = list(loop.seeds), loop.stacked, loop.step_ids
    loop.close()
    del loop
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    counts = None
    if summary and summary["steps"] and tracer.state is not None:
        traced = step_ids[tracer.start_steps:tracer.start_steps + summary["steps"]]
        counts = traced_counts(cfg, config, scan_dir, tracer.state, traced,
                               len(seeds) if stacked else 1, device)
        tracer.state = None
    t_ref = time.perf_counter()
    ref = check.reference_readings(cfg, config, traffic, scan_dir, seeds, prog["ids"], device)
    numbers = check.compare(prog, ref)
    correct, rows = check.judge(numbers, harness.load_limits(args.workload, root))
    print(f"reference {time.perf_counter() - t_ref:.1f} s, window {window_s:.2f} s, "
          f"set-up {setup_s:.2f} s", file=sys.stderr)

    ctx = {"trace": summary, "spans": spans.items, "window": (w0, w0 + window_s),
           "steps": steps, "window_s": window_s, "counts": counts}
    result = {"correct": bool(correct), "attempted": int(steps), "failed": int(failed)}
    if args.trace:
        metrics = {}
        for m in cell_metrics(args.bench, "per_layer", args.workload):
            v = load_reader(m["name"], root)(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        values = {"setup_s": setup_s, traffic["rate_metric"]: work / window_s}
        metrics = {m["name"]: {"value": float(values[m["name"]]), "unit": m["unit"]}
                   for m in cell_metrics(args.bench, "end_to_end", args.workload)
                   if m["name"] in values}
    result["metrics"] = metrics
    result["device"] = {"memory_peak_bytes": int(peak)}
    if summary:
        result["device"].update(busy_s=summary["busy_s"], window_s=summary["window_s"])
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    result["checks"] = rows
    # for the tests: the counts and the spans (seconds from the window's start)
    result["_readings"] = {"counts": counts,
                           "spans": [(n, a - w0, b - w0) for n, a, b in spans.items]}
    return result


def cell_metrics(bench, section, cell):
    """The entries of ``BENCHMARK.json``'s ``section`` that cell ``cell``
    reports."""
    return [m for m in bench.get(section, []) if "workloads" not in m or cell in m["workloads"]]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    with open(ROOT / "BENCHMARK.json") as f:
        args.bench = json.load(f)
    isolate_caches()

    import torch

    from benchmark.harness import load_cell

    cell = load_cell(args.workload, ROOT / "benchmark")[0]
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"benchmark: the cell needs {cell['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    card = power_limit()
    tmp = Path(tempfile.mkdtemp(prefix="dbw_bench_"))
    try:
        result = run(args, tmp, ROOT / "benchmark")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    found = banned_loaded()
    if found:
        print(f"benchmark: the run loaded {found}, which it may not", file=sys.stderr)
        return 4
    result.pop("_readings")
    checks = result.pop("checks")
    result["device"] = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                        "count": int(cell["chips"]), **result["device"]}
    result["checks"] = checks
    print(f"card: {card}", file=sys.stderr)
    for k, r in checks.items():
        print(f"check {k}: {r['value']!r} (limit {r['limit']!r})", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
