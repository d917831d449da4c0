#!/usr/bin/env python3
"""Trace the bench step under torch.profiler and print its top ops (the
twin of scripts/trace_bench.py for the PyTorch port).

    python3 scripts/torch_trace_bench.py [--steps 3] [--top 40]
        [--blocks 10] [--band Hb [--batch B]] [--out trace.json] [--cpu]

Runs ``--steps`` steps of the bench workload (``dbw_torch.bench``: the
flagship model, forward, backward and Adam) after two warm-up steps under
``torch.profiler`` and prints the top ``--top`` ops by device time per
step with their count per step, the rest as one line, and the total. With
``--cpu`` the table is of CPU time (each op's own time, its children's
excluded). ``--band Hb [--batch B]`` traces the banded step instead: the
loss and gradient of one Hb-row band of B views at the worst
(block-dense, centred) offset, through the port's ``row_range`` entry
point, with the pixel losses on the band and the parameter-space losses
full, as the JAX script does. ``--out`` writes the profile as a Chrome
trace. Runs on the card unless ``--cpu``.
"""

import argparse
import sys
from collections import defaultdict
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from dbw_torch.bench import BenchStep, make_model  # noqa: E402
from dbw_torch.utils.device import DEFAULT_DEVICE, resolve_device  # noqa: E402


def capture(steps, blocks=10, band=None, batch=4, img_size=(300, 400), device="cuda"):
    """A torch.profiler profile of ``steps`` bench steps (after 2 warm-up
    steps); ``band`` traces the banded step of ``batch`` views."""
    b = BenchStep(make_model(img_size, blocks, device=device), batch=batch)
    cuda = b.device.type == "cuda"
    kw = {}
    if band is not None:
        H = img_size[0]
        Hb = min(band, H)
        row0 = max(0, min(H // 2 - Hb // 2, H - Hb))
        b.imgs = b.imgs[:, row0:row0 + Hb].contiguous()
        kw["row_range"] = (row0, Hb)

    def sync():
        if cuda:
            torch.cuda.synchronize(b.device)

    for _ in range(2):
        b.step(**kw)
    sync()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
        for _ in range(steps):
            b.step(**kw)
        sync()
    return prof


def op_times(prof, cuda):
    """{op name: (total ms, count)}: the device records (kernels and copies)
    on the card, each op's own CPU time on the CPU."""
    total, count = defaultdict(float), defaultdict(int)
    if cuda:
        for e in prof.events():
            if (e.device_type == torch.autograd.DeviceType.CUDA
                    and not getattr(e, "is_user_annotation", False)):
                total[e.name] += (e.time_range.end - e.time_range.start) / 1e3
                count[e.name] += 1
    else:
        for e in prof.key_averages():
            total[e.key] += e.self_cpu_time_total / 1e3
            count[e.key] += e.count
    return {n: (total[n], count[n]) for n in total}


def print_table(ops, steps, top, what):
    """Print the top ops by time per step; returns the table's rows as
    (ms per step, count per step, name), the rest's line last."""
    rows = sorted(ops.items(), key=lambda kv: -kv[1][0])
    total = sum(ms for ms, _ in ops.values())
    print(f"total {what} op time: {total:.3f} ms over {steps} steps "
          f"({total / steps:.3f} ms/step)\n")
    print(f"{'ms/step':>9}  {'count':>6}  op")
    out = []
    for name, (ms, n) in rows[:top]:
        out.append((ms / steps, n / steps, name))
        print(f"{ms / steps:9.3f}  {n / steps:6.1f}  {name[:110]}")
    other = sum(ms for _, (ms, _) in rows[top:])
    out.append((other / steps, None, f"[{max(len(rows) - top, 0)} other ops]"))
    print(f"{other / steps:9.3f}  {'':>6}  {out[-1][2]}", flush=True)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--top", type=int, default=40)
    p.add_argument("--blocks", type=int, default=10)
    p.add_argument("--img-size", type=int, nargs=2, default=(300, 400),
                   metavar=("H", "W"), help="render size (default: the "
                   "baseline 300x400; smaller sizes are for CPU smokes)")
    p.add_argument("--band", type=int, default=None,
                   help="trace the banded step at this band height")
    p.add_argument("--batch", type=int, default=4, help="views a step")
    p.add_argument("--out", type=str, default=None,
                   help="write the profile here as a Chrome trace (JSON)")
    p.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = p.parse_args(argv)
    device = resolve_device("cpu" if args.cpu else DEFAULT_DEVICE)
    cuda = device.type == "cuda"
    if cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    prof = capture(args.steps, args.blocks, args.band, args.batch,
                   tuple(args.img_size), device)
    if args.out:
        prof.export_chrome_trace(args.out)
        print(f"trace: {args.out}")
    return print_table(op_times(prof, cuda), args.steps, args.top,
                       "device" if cuda else "CPU")


if __name__ == "__main__":
    main()
