#!/usr/bin/env python3
"""The device time of the render leaves (``dbw.raster`` and ``dbw.shade``,
forward and backward) by kernel family, at the benchmark cells' shapes.

    python3 scripts/torch_render_leaf_split.py [--cells campanile.protocol5 ...]
        [--seed 0] [--steps 3] [--base DIR] [--out split.json]

Each cell is built as ``benchmark/run.py`` builds it (its scan written from
``--seed``, the program configured by its traffic, the traffic's first
steps taken), then one batch of its views is rendered by the render leaves
alone: the env pass and the blocks pass of every slot's scene, each
scene's vertices, atlas and opacities detached from the parameters (the
scene build is not a render leaf), each pass through ``Renderer.render``
and a seeded weighted sum of its RGBA, forward and backward, after a
warm-up, under ``torch.profiler`` for ``--steps`` steps. The blend
(``dbw.blend``) runs only so that the passes' cotangents are the step's
(zero on empty slots); its kernels and the weighted sum's are listed
apart, as "not render".

Each device kernel is put in a family:

- the hand-written kernels by name, from the device records: K1
  (``select_kernel``), K2
  (``frag_fwd_kernel``), K3 (``frag_bwd_kernel``), K4
  (``texel_grad_kernel``, ``texel_pack_kernel``), K5
  (``small_scatter_kernel``), K8 (``quad_sample_fwd_kernel``), and the
  blend's K6;
- in the forward, by the innermost of these ranges around the op that
  launched it: the quad sample's forward (``quad_forward``: the plain
  twin's 41 ops, or K8), ``fragment_streams``, the env pass's fragment
  math (the face rows' gather, ``residual``, ``alpha_math``, ``bary_uv``,
  ``texel_coords``), else the rest of ``dbw.raster`` or ``dbw.shade``;
- in the backward, by the autograd node it ran in: ``SelectBackward0``
  (the column reads of the env pass's gathered face rows: a zero fill of
  the (N, 20) rows and an add a column), the quad samples' nodes (K4, and
  the env pass's corner regather and d_wx, d_wy), else the family of the
  forward op that made the node (its sequence number), as ``bwd: ...``;
- device records that no op lists (copies, a launch outside any op), if
  any, as one family.

Prints per cell one line per family, in ms a step, then the top
(family, op, kernel) rows, the CUDA-event time of a step, the render
families' sum (the blend's left out) and the card's name and power limit;
``--out`` writes them as JSON. ``--base DIR`` imports ``dbw_torch`` (and
the benchmark) from another checkout, such as a parent commit unpacked by
``git archive``. Runs on the card only.
"""

import argparse
import contextlib
import json
import subprocess
import sys
import tempfile
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CELLS = ("campanile.protocol5", "dtu24.protocol5", "gundam50.protocol5")
NODE = "autograd::engine::evaluate_function: "
KERNELS = {"select_kernel": "K1", "frag_fwd_kernel": "K2", "frag_bwd_kernel": "K3",
           "texel_grad_kernel": "K4", "texel_pack_kernel": "K4",
           "small_scatter_kernel": "K5", "quad_sample_fwd_kernel": "K8",
           "blend_fwd_kernel": "K6 (blend, not render)",
           "blend_bwd_kernel": "K6 (blend, not render)"}
# the script's own ranges (innermost first wins), then the program's leaves
RANGES = {"split.quad_sample": "quad sample", "split.fragment_streams": "fragment_streams",
          "split.env_frag_math": "env fragment math", "split.loss": "weighted sum (not render)",
          "dbw.raster": "raster, other", "dbw.shade": "shade, other",
          "dbw.blend": "blend (not render)"}
# env fragment math: the renderer's names of the functions the env pass runs
ENV_MATH = ("gather_rows_partial", "residual", "alpha_math", "bary_uv", "texel_coords")


def ranged(name, fn):
    import torch

    def wrapper(*a, **kw):
        with torch.profiler.record_function(name):
            return fn(*a, **kw)
    return wrapper


@contextlib.contextmanager
def split_ranges():
    """The quad sample's forward, ``fragment_streams`` and the env fragment
    math under ranges of their own while the block runs."""
    from dbw_torch.render import meshes, renderer

    swaps = [(meshes, "quad_forward", "split.quad_sample"),
             (renderer, "fragment_streams", "split.fragment_streams")]
    swaps += [(renderer, n, "split.env_frag_math") for n in ENV_MATH]
    saved = [(m, n, getattr(m, n)) for m, n, _ in swaps]
    for m, n, r in swaps:
        setattr(m, n, ranged(r, getattr(m, n)))
    try:
        yield
    finally:
        for m, n, f in saved:
            setattr(m, n, f)


def leaf_scene(scene):
    """A scene whose vertices, atlas and opacities are leaves that require
    grad (detached from the scene build)."""
    from dbw_torch.render.meshes import TextureAtlas

    leaf = lambda t: t.detach().clone().requires_grad_(True)
    return scene._replace(verts=leaf(scene.verts), atlas=TextureAtlas(leaf(scene.atlas.maps)),
                          faces_alpha=leaf(scene.faces_alpha))


def render_step(model, params, phase, R, T, noise, gen):
    """-> a function that renders both passes of the views R, T (S * B of
    them) and back-propagates a seeded weighted sum of their RGBA."""
    import torch

    with torch.no_grad():
        env, _ = model.build_env(params, phase)
        blocks, _ = model.build_blocks(params, phase, noise=noise)
    passes = ((model.renderer_env, leaf_scene(env), None),
              (model.renderer, leaf_scene(blocks), phase.sigma))
    shape = (R.shape[0],) + tuple(model.renderer.config.raster_config().image_size) + (4,)
    w = torch.randn(shape, generator=gen, device=R.device)

    def step():
        loss = 0.0
        for rend, scene, sigma in passes:
            for t in (scene.verts, scene.atlas.maps, scene.faces_alpha):
                t.grad = None
            rgba = rend.render(scene, R, T, sigma=sigma)
            with torch.profiler.record_function("split.loss"):
                loss = loss + (rgba * w).sum()
        loss.backward()
    return step


def chain_of(e):
    out, p = [], e
    while p is not None:
        out.append(p)
        p = p.cpu_parent
    return out


def split(events, steps, on_card=True):
    """(family -> ms a step, (family, op, kernel) -> ms a step). On the
    CPU (a rehearsal) each op's self CPU time stands for its kernels."""
    import torch

    cpu = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU]
    # forward ops' sequence numbers -> their range's family. An op records
    # the number its node will take; ops that make no node before it record
    # the same one, so the last op to record a number made the node
    seq_family = {}
    for e in sorted(cpu, key=lambda e: e.time_range.start):
        chain = chain_of(e)
        if getattr(e, "sequence_nr", -1) >= 0 and not any(
                p.name.startswith(NODE) for p in chain):
            seq_family[e.sequence_nr] = next(
                (RANGES[p.name] for p in chain if p.name in RANGES), "outside the leaves")
    fam, rows = defaultdict(float), defaultdict(float)
    # the hand-written kernels by name from the device records: a launch
    # through ctypes may have no op of its own to list it
    device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    other_us = 0.0
    for e in device:
        us = e.time_range.end - e.time_range.start
        f = next((v for k, v in KERNELS.items() if k in e.name), None)
        if f is None:
            other_us += us
            continue
        fam[f] += us / 1e3 / steps
        rows[(f, "(by name)", e.name[:90])] += us / 1e3 / steps
    listed_us = 0.0
    for e in cpu:
        if on_card:
            launched = [(k.name, k.duration) for k in e.kernels
                        if not any(n in k.name for n in KERNELS)]
            listed_us += sum(us for _, us in launched)
        else:
            launched = [(e.name, e.self_cpu_time_total)] if e.self_cpu_time_total else []
        if not launched:
            continue
        chain = chain_of(e)
        names = [p.name for p in chain]
        node = next((n[len(NODE):] for n in names if n.startswith(NODE)), None)
        for kname, us in launched:
            f = None if on_card else next((v for k, v in KERNELS.items() if k in kname), None)
            if f is None and node is None:
                f = next((RANGES[n] for n in names if n in RANGES), "outside the leaves")
            elif f is None:
                if node == "SelectBackward0":
                    f = "bwd: env SelectBackward0 (fills, adds)"
                elif "SampleQuad" in node:
                    f = "bwd: quad sample node, other"
                else:
                    seq = next((getattr(p, "sequence_nr", -1) for p in chain
                                if p.name == node and getattr(p, "sequence_nr", -1) >= 0), -1)
                    f = "bwd: " + seq_family.get(seq, "other")
            ms = us / 1e3 / steps
            fam[f] += ms
            op = node or next((n for n in reversed(names) if n.startswith("aten::")), names[0])
            rows[(f, op, kname[:90])] += ms
    if other_us - listed_us > 0.5 * steps:
        fam["device records no op lists"] += (other_us - listed_us) / 1e3 / steps
    return dict(fam), rows


def profile_split(step, steps, on_card=True):
    """Warm-up, the CUDA-event time of a step, then ``steps`` traced."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with split_ranges():
        for _ in range(2):
            step()
        event_ms = None
        if on_card:
            torch.cuda.synchronize()
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            for _ in range(steps):
                step()
            b.record()
            torch.cuda.synchronize()
            event_ms = a.elapsed_time(b) / steps
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
        with profile(activities=acts) as prof:
            for _ in range(steps):
                step()
            if on_card:
                torch.cuda.synchronize()
    fam, rows = split(prof.events(), steps, on_card)
    return event_ms, fam, rows


def cell_inputs(cell, seed, tmp, device):
    """The cell's model, parameters after its first steps, the epoch's
    phase, a batch's views for every slot and the step's opacity noise."""
    import numpy as np
    import torch

    from benchmark import harness, scan
    from dbw_torch.train.trainer import gather_views

    root = ROOT / "benchmark"
    _, config, traffic = harness.load_cell(cell, root)
    scan.write(config, tmp / "scans", seed)
    cfg = harness.program_config(config, traffic, seed, tmp / "scans", root)
    loop = harness.make_loop(cfg, tmp / "run", traffic, harness.Spans(), device, root)
    loop.first_steps()
    _, _, ids = next(loop.batches)
    idx, _ = harness.pad_ids(ids, loop.batch_size)
    _, R, T = gather_views(loop.mt.dataset, np.asarray(idx), device)
    S = len(loop.seeds)
    gens = [torch.Generator(device=device).manual_seed(seed + s) for s in range(S)]
    model, params = loop.model, {k: v.detach() for k, v in loop.params.items()}
    noise = model.step_draws(params, gens, names=("opacity_noise",))["opacity_noise"]
    return loop, model, params, loop.phase, R.repeat(S, 1, 1), T.repeat(S, 1), noise


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cells", nargs="+", default=list(CELLS))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--base", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    global ROOT
    if args.base:
        ROOT = Path(args.base).resolve()
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    out = {"card": card.stdout.strip(), "root": str(ROOT), "cells": {}}
    for cell in args.cells:
        with tempfile.TemporaryDirectory() as tmp:
            loop, model, params, phase, R, T, noise = cell_inputs(cell, args.seed, Path(tmp), dev)
            gen = torch.Generator(device=dev).manual_seed(args.seed)
            step = render_step(model, params, phase, R, T, noise, gen)
            torch.cuda.reset_peak_memory_stats()
            event_ms, fam, rows = profile_split(step, args.steps)
            peak = torch.cuda.max_memory_allocated()
            loop.close()
            del loop, model, params, step
            torch.cuda.empty_cache()
        res = dict(views=int(R.shape[0]), event_ms_per_step=event_ms,
                   render_ms_per_step=sum(v for k, v in fam.items() if "not render" not in k),
                   other_ms_per_step=sum(v for k, v in fam.items() if "not render" in k),
                   peak_bytes=peak,
                   families={k: fam[k] for k in sorted(fam, key=fam.get, reverse=True)},
                   rows=[dict(family=f, op=op, kernel=k, ms=ms) for (f, op, k), ms in
                         sorted(rows.items(), key=lambda kv: -kv[1])])
        out["cells"][cell] = res
        print(f"{out['card']}; {cell} ({ROOT}): {res['views']} views; a step "
              f"{event_ms:.3f} ms (CUDA events, both passes with their blends), render "
              f"leaves {res['render_ms_per_step']:.3f} ms, the rest (not render) "
              f"{res['other_ms_per_step']:.3f} ms (profiler, device ms a step), peak {peak} B",
              flush=True)
        for f, ms in res["families"].items():
            print(f"  {f:40s} {ms:9.3f} ms a step")
        for r in res["rows"][:args.top]:
            print(f"  {r['ms']:9.3f}  {r['family'][:32]:32s} {r['op'][:32]:32s} {r['kernel']}")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
