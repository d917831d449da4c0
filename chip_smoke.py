#!/usr/bin/env python3
"""Drive the PyTorch port (dbw_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, one line each (or a few):
1. device: the card's name and power limit;
2. build: compile the CUDA kernels of dbw_torch/csrc with nvcc;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the flagship shapes taken from the real scene, with both times;
4. main path: the flagship model (configs/synthetic/dtu_shaped.yml with
   decouple_rendering=False, 300x400, 4 views, K=10, 10 blocks, 256 texels)
   takes 10 Adam steps; every kernel must launch in every step;
5. reference: a small model run on the card agrees with the same model run
   on the CPU (plain versions), losses and gradients.
The last two lines are a JSON object per kernel and the result line.
Exits non-zero, with no result line, when there is no CUDA device or any
phase fails.
"""

from __future__ import annotations

import copy
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
CONFIG = ROOT / "configs" / "synthetic" / "dtu_shaped.yml"
IMG_SIZE = (300, 400)
N_VIEWS = 4
N_STEPS = 10
# dataset-style NDC intrinsics of the flagship bench model
K_NDC = np.zeros((4, 4), np.float32)
K_NDC[0, 0], K_NDC[1, 1] = 2.8, 2.1
K_NDC[0, 2] = K_NDC[1, 2] = 0.02
K_NDC[2, 3] = K_NDC[3, 2] = 1.0

SOURCES = {
    "K1_select": ("dbw_torch/csrc/raster.cu",
                  "dbw_tpu/render/rasterize_pallas.py:97"),
    "K2_frag_fwd": ("dbw_torch/csrc/fragment.cu",
                    "dbw_tpu/render/fragment_fused.py:190"),
    "K3_frag_bwd": ("dbw_torch/csrc/fragment.cu",
                    "dbw_tpu/render/fragment_fused.py:218"),
    "K4_texel_grad": ("dbw_torch/csrc/texel.cu",
                      "dbw_tpu/ops/segment_sum_pallas.py:54"),
}


def say(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def cuda_ms(fn, reps=10):
    """Median of ``reps`` CUDA-event timings of fn() (after one warm-up)."""
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def load_model_cfg():
    from dbw_torch.utils.config import load_yaml

    cfg = load_yaml(CONFIG)
    cfg["model"]["rend_optim"]["decouple_rendering"] = False
    say("config", f"{CONFIG.relative_to(ROOT)} with override "
        "model.rend_optim.decouple_rendering=False")
    return cfg


def make_model(cfg, device, img_size=IMG_SIZE, mesh=None, renderer=None):
    """BlocksWorld from the config's model section (+ overrides of its mesh
    and renderer keys) with the flagship camera."""
    from dbw_torch.models.dbw import BlocksWorld

    m = copy.deepcopy(cfg["model"])
    m.pop("name", None)
    m["mesh"].update(mesh or {})
    m["renderer"].update(renderer or {})
    model = BlocksWorld(img_size, device=device, **m)
    model.set_camera(K_NDC)
    return model


def cameras(n, device):
    from dbw_torch.ops.rotations import look_at_rotation

    R, T = look_at_rotation(3.0, 25.0, torch.linspace(-40.0, 40.0, n))
    return R.to(device), T.to(device)


def phase_kernels(model, device):
    """Each kernel against its plain version at the flagship shapes."""
    from dbw_torch.ops import texel_grad as tg
    from dbw_torch.render import fragment as fr
    from dbw_torch.render import rasterize as rz
    from dbw_torch.render.cameras import ndc_pixel_centers
    from dbw_torch.render.renderer import fragment_streams

    params = model.init_params(seed=0)
    phase = model.phase_for_epoch(0)
    R, T = cameras(N_VIEWS, device)
    gen = torch.Generator(device=device).manual_seed(1)
    results = {}
    with torch.no_grad():
        noise = torch.randn((model.n_blocks,), generator=gen, device=device)
        scene, _, _ = model.build_scene(params, phase, noise=noise)
        rend = model.renderer
        sigma, blur = rend.sigma_blur(phase.sigma)
        geom = rz.project_faces(scene.verts, scene.faces, R, T, rend.camera,
                                z_clip=rend.config.z_clip)
        packed = rz.pack_faces(geom)
        rcfg = rend.config.raster_config()
        rcfg_plain = rcfg._replace(row_chunk=50)

        # K1
        p2f = rz.rasterize_cuda(packed, blur, rcfg)
        ref = rz.rasterize_plain(packed, blur, rcfg_plain)
        torch.cuda.synchronize()
        mism = (p2f != ref)
        n_mis = int(mism.sum())
        dz = 0.0
        if n_mis:
            b, i, j, k = torch.nonzero(mism, as_tuple=True)
            xs, ys = ndc_pixel_centers(IMG_SIZE, device)
            px, py = xs[j][:, None], ys[i][:, None]
            za = rz._score(px, py, packed[b, p2f[b, i, j, k].long().clamp(min=0)][:, None],
                           blur, rcfg.z_clip, True, True)
            zb = rz._score(px, py, packed[b, ref[b, i, j, k].long().clamp(min=0)][:, None],
                           blur, rcfg.z_clip, True, True)
            dz = float((za - zb).abs().max())
        frac = n_mis / p2f.numel()
        ok1 = frac <= 1e-3 and dz < 1e-5
        results["K1_select"] = dict(
            max_abs_err=dz, ms=cuda_ms(lambda: rz.rasterize_cuda(packed, blur, rcfg)),
            plain_ms=cuda_ms(lambda: rz.rasterize_plain(packed, blur, rcfg_plain)),
            ok=ok1)
        say("kernels", f"K1 select: {n_mis} of {p2f.numel()} slots differ "
            f"(max |dz| {dz:.3g}; tolerance: <= 0.1% of slots, near-ties "
            f"|dz| < 1e-5); valid slots {int((p2f >= 0).sum())}")

        # K2
        table, ids, vld, px, py = fragment_streams(scene, geom, p2f)
        M, TH, TW = scene.atlas.maps.shape[:3]
        flags = fr.FragFlags(True, True, rend.config.clip_inside, TH, TW)
        out = fr.frag_fwd_cuda(table, ids, vld, px, py, sigma, flags)
        refo = fr.frag_fwd_plain(table, ids, vld, px, py, sigma, flags)
        id_eq = float((out[0] == refo[0]).float().mean())
        err2 = max(float((a - b).abs().max()) for a, b in zip(out[1:], refo[1:]))
        ok2 = id_eq == 1.0 and err2 <= 1e-5
        results["K2_frag_fwd"] = dict(
            max_abs_err=err2,
            ms=cuda_ms(lambda: fr.frag_fwd_cuda(table, ids, vld, px, py, sigma, flags)),
            plain_ms=cuda_ms(lambda: fr.frag_fwd_plain(table, ids, vld, px, py, sigma, flags)),
            ok=ok2)
        say("kernels", f"K2 frag fwd: N={ids.numel()}, id00 equal on {id_eq:.6f}, "
            f"max |d| of wx/wy/alpha/res {err2:.3g} (tolerance: id00 exact, 1e-5)")

        # K3
        res = out[4]
        d_alpha = torch.randn(ids.shape, generator=gen, device=device) * vld
        rows = table.shape[0]
        d8 = fr.frag_bwd_cuda(ids, vld, px, py, res, d_alpha, sigma, flags.clip_inside, rows)
        d8r = fr.frag_bwd_plain(ids, vld, px, py, res, d_alpha, sigma, flags.clip_inside, rows)
        err3 = float((d8 - d8r).abs().max())
        scale3 = float(d8r.abs().max())
        ok3 = err3 <= 1e-4 * scale3
        results["K3_frag_bwd"] = dict(
            max_abs_err=err3,
            ms=cuda_ms(lambda: fr.frag_bwd_cuda(ids, vld, px, py, res, d_alpha, sigma,
                                                flags.clip_inside, rows)),
            plain_ms=cuda_ms(lambda: fr.frag_bwd_plain(ids, vld, px, py, res, d_alpha,
                                                       sigma, flags.clip_inside, rows)),
            ok=ok3)
        say("kernels", f"K3 frag bwd: d-table max |d| {err3:.3g} of max {scale3:.3g} "
            "(tolerance: 1e-4 of max; atomics sum in another order)")

        # K4
        id00, wx, wy = out[0], out[1], out[2]
        g = torch.randn((ids.numel(), 3), generator=gen, device=device) * vld[:, None]
        Rt = M * TH * TW
        dm = tg.quad_maps_grad_cuda(id00, wx, wy, g, Rt, TW)
        dmr = tg.quad_maps_grad_plain(id00, wx, wy, g, Rt, TW)
        err4 = float((dm - dmr).abs().max())
        scale4 = float(dmr.abs().max())
        ok4 = err4 <= 1e-5 * scale4
        results["K4_texel_grad"] = dict(
            max_abs_err=err4,
            ms=cuda_ms(lambda: tg.quad_maps_grad_cuda(id00, wx, wy, g, Rt, TW)),
            plain_ms=cuda_ms(lambda: tg.quad_maps_grad_plain(id00, wx, wy, g, Rt, TW)),
            ok=ok4)
        say("kernels", f"K4 texel grad: R={Rt}, d_maps max |d| {err4:.3g} of max "
            f"{scale4:.3g} (tolerance: 1e-5 of max; atomics sum in another order)")
    for name, r in results.items():
        say("kernels", f"{name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms "
            "(CUDA events, median)")
    bad = [n for n, r in results.items() if not r.pop("ok")]
    if bad:
        raise SystemExit(f"kernel check failed: {bad}")
    return results


def phase_main(cfg, device):
    """The flagship train step, N_STEPS times."""
    from dbw_torch import kernels
    from dbw_torch.train.optimizer import create_optimizer

    model = make_model(cfg, device)
    params = model.init_params(seed=0)
    opt = create_optimizer(cfg, params)
    say("main", "optimizer: Adam, lrs " + ", ".join(
        f"{g['name']} {g['lr']}" for g in opt.param_groups))
    phase = model.phase_for_epoch(0, training=True)
    imgs = torch.from_numpy(np.random.default_rng(0).random(
        (N_VIEWS,) + IMG_SIZE + (3,), np.float32)).to(device)
    R, T = cameras(N_VIEWS, device)
    gen = torch.Generator(device=device).manual_seed(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    times, totals = [], []
    for step in range(N_STEPS):
        before = dict(kernels.LAUNCHES)
        t0 = time.perf_counter()
        opt.zero_grad(set_to_none=True)
        losses = model.forward(params, phase, imgs, R, T, generator=gen)
        losses["total"].backward()
        opt.step()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        vals = {k: float(v.detach()) for k, v in losses.items()}
        totals.append(vals["total"])
        missing = [k for k in before if kernels.LAUNCHES[k] == before[k]]
        say("main", f"step {step}: " + " ".join(
            f"{k}={v:.6g}" for k, v in vals.items()) + f" ({times[-1] * 1e3:.1f} ms)")
        if not all(math.isfinite(v) for v in vals.values()):
            raise SystemExit(f"non-finite loss at step {step}")
        if missing:
            raise SystemExit(f"step {step}: kernels not launched: {missing}")
        for k, p in params.items():
            if not torch.isfinite(p).all():
                raise SystemExit(f"non-finite parameter {k} after step {step}")
    launches = dict(kernels.LAUNCHES)
    with torch.no_grad():
        rec, _ = model.predict(params, phase, R, T, noise=torch.zeros(
            model.n_blocks, device=device))
    if rec.shape != (N_VIEWS,) + IMG_SIZE + (3,) or not torch.isfinite(rec).all() \
            or rec.min() < -1e-6 or rec.max() > 1 + 1e-5:
        raise SystemExit(f"bad render: shape {tuple(rec.shape)}")
    say("main", f"render after {N_STEPS} steps: {tuple(rec.shape)}, finite, in "
        f"[{float(rec.min()):.3g}, {float(rec.max()):.3g}]")
    med = float(np.median(times[1:]))
    say("main", f"median step {med * 1e3:.2f} ms ({1.0 / med:.3f} steps/s, "
        f"steps 1-{N_STEPS - 1}, host clock around synchronized steps); "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    say("main", f"launches: {launches}")
    return launches


def phase_reference(cfg, device):
    """A small model on the card (kernels) against the same model on the CPU
    (plain versions): losses rtol 1e-4, gradients 1e-3 of each leaf's max."""
    from dbw_torch.convert import scene_params_from_numpy

    small = dict(mesh=dict(n_blocks=3, txt_size=32, T_range=[0.2, 0.2, 0.2]),
                 renderer=dict(faces_per_pixel=5))
    out = {}
    for dev in (device, "cpu"):
        model = make_model(cfg, dev, img_size=(48, 64), **small)
        params = scene_params_from_numpy(model.init_params_numpy(0), dev)
        rng = np.random.default_rng(2)
        imgs = torch.from_numpy(rng.random((2, 48, 64, 3), np.float32)).to(dev)
        noise = torch.from_numpy(rng.standard_normal(3).astype(np.float32)).to(dev)
        ou = torch.from_numpy(rng.random((3, 1000, 3), np.float32)).to(dev)
        R, T = cameras(2, dev)
        losses = model.forward(params, model.phase_for_epoch(0), imgs, R, T,
                               opacity_noise=noise, overlap_u=ou)
        losses["total"].backward()
        out[dev] = ({k: float(v.detach()) for k, v in losses.items()},
                    {k: p.grad.cpu() for k, p in params.items()})
    (lg, gg), (lc, gc) = out[device], out["cpu"]
    worst_l = max(abs(lg[k] - lc[k]) / max(abs(lc[k]), 1e-12) for k in lc)
    worst_g = max(float((gg[k] - gc[k]).abs().max()) / max(float(gc[k].abs().max()), 1e-30)
                  for k in gc)
    say("reference", f"48x64, 3 blocks, K=5, 2 views, card vs CPU: losses max rel "
        f"{worst_l:.3g} (tolerance 1e-4), grads max |d|/max|g| {worst_g:.3g} "
        f"(tolerance 1e-3); total {lg['total']:.6g} vs {lc['total']:.6g}")
    if not (worst_l <= 1e-4 and worst_g <= 1e-3):
        raise SystemExit("card and CPU disagree on the small model")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from dbw_torch import kernels

    device = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    say("device", f"{name}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say("device", f"torch.backends.cuda.matmul.allow_tf32="
        f"{torch.backends.cuda.matmul.allow_tf32} "
        f"torch.backends.cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")

    t0 = time.perf_counter()
    lib = kernels.build(verbose="-v" in sys.argv)
    kernels.library()
    say("build", f"{lib.relative_to(ROOT)} in {time.perf_counter() - t0:.1f} s")

    cfg = load_model_cfg()
    model = make_model(cfg, device)
    results = phase_kernels(model, device)
    del model
    torch.cuda.empty_cache()
    launches = phase_main(cfg, device)
    phase_reference(cfg, device)

    line = {"kernels": [
        {"name": n, "route": "cuda", "source": SOURCES[n][0],
         "replaces": SOURCES[n][1], "launches": launches[n], **results[n]}
        for n in SOURCES]}
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
