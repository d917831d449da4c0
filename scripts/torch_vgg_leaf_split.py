#!/usr/bin/env python3
"""The device time of the LPIPS leaf (the perceptual loss's forward and
backward) by kernel family, at a benchmark cell's shapes.

    python3 scripts/torch_vgg_leaf_split.py [--img-size 540 960] [--slots 5]
        [--views 4] [--steps 3] [--seed 0] [--out split.json]

Runs ``LPIPSLoss`` on the VGG16 trunk in its default dtype (bfloat16 on
the card) as the protocol's step runs it: ``--views`` target views shared
by ``--slots`` slots of rendered views (``slots * views`` renders in one
trunk call, ``slots=``), the renders requiring a gradient, forward and
backward, after two warm-up steps, under ``torch.profiler`` for
``--steps`` steps. Each device kernel is put in a family by the op that
launched it and the autograd node it ran in:

- ``conv``: the trunk's convolutions and their backward (``conv2d``,
  ``ConvolutionBackward0``); the elementwise kernels that run inside the
  convolution's backward node (layout copies, the engine's gradient sums
  into the slice outputs) are ``conv node: elementwise``;
- ``pool``: the max pools and their backward;
- ``bias/relu``: the trunk's bias adds and ReLUs (bfloat16) and their
  backward;
- ``glue``: the rest: the LPIPS distance (the float32 slice copies, the
  target tiling, the unit normalisation, the squared difference, the means;
  or the kernel pair K7) and its backward.

Prints one line per family and per (family, op, kernel), each in ms a
step, the CUDA-event time of a step, the peak memory and the card's name
and power limit; ``--out`` writes them as JSON. Runs on the card only.
"""

import argparse
import json
import subprocess
import sys
from collections import defaultdict
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from dbw_torch.losses.vgg import LPIPSLoss, VGG16Features  # noqa: E402

NODE = "autograd::engine::evaluate_function: "


def family(chain, kernel):
    """The family of a kernel launched by the innermost op of ``chain``
    (op names from the innermost outwards)."""
    for name in chain:
        if name.startswith(NODE):
            node = name[len(NODE):]
            if "Convolution" in node:
                return "conv" if not any(k in kernel for k in ("elementwise", "copy")) \
                    else "conv node: elementwise"
            if "MaxPool" in node:
                return "pool"
            if "Relu" in node or "Threshold" in node:
                return "bias/relu"
            return "glue"
    if any("conv" in n for n in chain):
        return "conv"
    if any("max_pool" in n for n in chain):
        return "pool"
    if any(n in ("aten::relu", "aten::relu_") for n in chain):
        return "bias/relu"
    return "glue"


def anchor(chain):
    """The op a kernel is listed under: its autograd node, else the
    outermost aten op."""
    for name in chain:
        if name.startswith(NODE):
            return name[len(NODE):]
    aten = [n for n in chain if n.startswith("aten::")]
    return aten[-1] if aten else chain[0]


def split(prof, steps, trunk_ops):
    """(family -> ms a step, (family, op, kernel) -> ms a step)."""
    fam, rows = defaultdict(float), defaultdict(float)
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CPU or not e.kernels:
            continue
        chain, p = [], e
        while p is not None:
            chain.append(p.name)
            p = p.cpu_parent
        for k in e.kernels:
            f = family(chain, k.name)
            # the trunk's bias add (bfloat16, under the trunk's range)
            if f == "glue" and "vgg.trunk" in chain and anchor(chain) in trunk_ops:
                f = "bias/relu"
            ms = k.duration / 1e3 / steps
            fam[f] += ms
            rows[(f, anchor(chain), k.name[:90])] += ms
    return dict(fam), rows


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--img-size", type=int, nargs=2, default=(540, 960))
    ap.add_argument("--slots", type=int, default=5)
    ap.add_argument("--views", type=int, default=4)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--top", type=int, default=30)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = torch.device("cuda")
    H, W = args.img_size
    rng = np.random.default_rng(args.seed)
    imgs = torch.from_numpy(rng.random((args.views, H, W, 3), dtype=np.float32)).to(dev)
    rec = torch.from_numpy(rng.random((args.slots * args.views, H, W, 3),
                                      dtype=np.float32)).to(dev).requires_grad_(True)
    loss_fn = LPIPSLoss(vgg=VGG16Features.from_env_or_random(seed=0, device=dev))
    # the trunk's forward under a range of its own, so that its bias adds
    # are told from the distance's float32 adds
    trunk = type(loss_fn.vgg)
    for name in ("forward", "slices"):
        if hasattr(trunk, name):
            fn = getattr(trunk, name)

            def ranged(self, *a, _fn=fn, **kw):
                with torch.profiler.record_function("vgg.trunk"):
                    return _fn(self, *a, **kw)
            setattr(trunk, name, ranged)

    def step():
        rec.grad = None
        loss_fn(imgs, rec, slots=args.slots).sum().backward()

    for _ in range(2):
        step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(args.steps):
        step()
    b.record()
    torch.cuda.synchronize()
    event_ms = a.elapsed_time(b) / args.steps
    peak = torch.cuda.max_memory_allocated()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(args.steps):
            step()
        torch.cuda.synchronize()
    fam, rows = split(prof, args.steps, {"aten::add"})
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    out = dict(card=card.stdout.strip(), img_size=[H, W], renders=args.slots * args.views,
               targets=args.views, steps=args.steps, event_ms_per_step=event_ms,
               device_ms_per_step=sum(fam.values()), peak_bytes=peak,
               families={k: fam[k] for k in sorted(fam, key=fam.get, reverse=True)},
               rows=[dict(family=f, op=op, kernel=k, ms=ms) for (f, op, k), ms in
                     sorted(rows.items(), key=lambda kv: -kv[1])])
    print(f"{out['card']}; {H}x{W}, {out['renders']} renders, {args.views} targets; "
          f"a step {event_ms:.3f} ms (CUDA events), device {out['device_ms_per_step']:.3f} "
          f"ms (profiler), peak {peak} B")
    for f, ms in out["families"].items():
        print(f"  {f:24s} {ms:9.3f} ms a step")
    for r in out["rows"][:args.top]:
        print(f"  {r['ms']:9.3f}  {r['family']:24s} {r['op'][:36]:36s} {r['kernel']}")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
