#!/usr/bin/env python3
"""Drive the PyTorch port (dbw_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py [-v]

Phases, one line each (or a few):
1. device: the card's name and power limit;
2. build: compile the CUDA kernels of dbw_torch/csrc with nvcc (-v: print
   ptxas register and spill info);
3. kernels: each kernel against its plain PyTorch version on the card, at
   the flagship shapes of every path that launches it (the blocks and env
   passes of the main path, the joint path's one scene), with both times;
4. main path: configs/synthetic/dtu_shaped.yml as shipped (decoupled env
   pass, 300x400, 4 views, K=10, 10 blocks, 256 texels) takes 10 Adam
   steps; every kernel must launch in every step. Then a few steps split by
   CUDA events into env pass, blocks pass, losses, backward and Adam, and
   a torch.profiler trace of 3 steps: the device's idle share and where
   its time goes;
5. joint path: the same config with decouple_rendering=False, 3 steps;
6. train: the port's synthetic ground truth of the config (49 views at
   300x400) rendered on the card, one epoch (13 batches of 4 in the
   loader's order, the scheduler's LRs), then a model.pkl round trip that
   must reproduce the next step;
7. reference: a small model run on the card agrees with the same model run
   on the CPU (plain versions), losses and gradients, decoupled and joint.
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
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
CONFIG = ROOT / "configs" / "synthetic" / "dtu_shaped.yml"
IMG_SIZE = (300, 400)
N_VIEWS = 4
N_STEPS = 10
N_JOINT_STEPS = 3
N_SPLIT_STEPS = 4
N_PROFILE_STEPS = 3
# dataset-style NDC intrinsics of the flagship bench model
K_NDC = np.zeros((4, 4), np.float32)
K_NDC[0, 0], K_NDC[1, 1] = 2.8, 2.1
K_NDC[0, 2] = K_NDC[1, 2] = 0.02
K_NDC[2, 3] = K_NDC[3, 2] = 1.0

SOURCES = {
    "K1_select": ("dbw_torch/csrc/raster.cu",
                  "dbw_tpu/render/rasterize_pallas.py:97"),
    "K1_select_hard": ("dbw_torch/csrc/raster.cu",
                       "dbw_tpu/render/rasterize_pallas.py:166"),
    "K2_frag_fwd": ("dbw_torch/csrc/fragment.cu",
                    "dbw_tpu/render/fragment_fused.py:190"),
    "K3_frag_bwd": ("dbw_torch/csrc/fragment.cu",
                    "dbw_tpu/render/fragment_fused.py:218"),
    "K4_texel_grad": ("dbw_torch/csrc/texel.cu",
                      "dbw_tpu/ops/segment_sum_pallas.py:54"),
    "K5_small_scatter": ("dbw_torch/csrc/scatter.cu",
                         "dbw_tpu/ops/segment_sum_pallas.py:169"),
}
# kernels of the joint-rendering path (no env pass)
JOINT_KERNELS = ("K1_select", "K2_frag_fwd", "K3_frag_bwd", "K4_texel_grad")


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


def load_cfg():
    from dbw_torch.utils.config import load_yaml

    cfg = load_yaml(CONFIG)
    say("config", f"{CONFIG.relative_to(ROOT)} as shipped (decouple_rendering="
        f"{cfg['model']['rend_optim']['decouple_rendering']})")
    return cfg


def make_model(cfg, device, img_size=None, mesh=None, renderer=None,
               rend_optim=None, K=K_NDC):
    """BlocksWorld from the config's model section (+ overrides of its mesh,
    renderer and rend_optim keys) with the flagship camera."""
    from dbw_torch.models.dbw import BlocksWorld

    m = copy.deepcopy(cfg["model"])
    m.pop("name", None)
    m["mesh"].update(mesh or {})
    m["renderer"].update(renderer or {})
    m["rend_optim"].update(rend_optim or {})
    model = BlocksWorld(img_size or IMG_SIZE, device=device, **m)
    model.set_camera(K)
    return model


def cameras(n, device):
    from dbw_torch.ops.rotations import look_at_rotation

    R, T = look_at_rotation(3.0, 25.0, torch.linspace(-40.0, 40.0, n))
    return R.to(device), T.to(device)


def check_selection(label, got, ref, packed, blur, rcfg):
    """K1: slot-for-slot equality with the plain version, except near-ties
    (at most 0.1% of slots, each within |dz| < 1e-5)."""
    from dbw_torch.render import rasterize as rz
    from dbw_torch.render.cameras import ndc_pixel_centers

    mism = got != ref
    n_mis = int(mism.sum())
    dz = 0.0
    if n_mis:
        b, i, j, k = torch.nonzero(mism, as_tuple=True)
        xs, ys = ndc_pixel_centers(rcfg.image_size, got.device)
        px, py = xs[j][:, None], ys[i][:, None]
        za, zb = (rz._score(px, py, packed[b, sel[b, i, j, k].long().clamp(min=0)][:, None],
                            blur, rcfg.z_clip, True, True) for sel in (got, ref))
        dz = float((za - zb).abs().max())
    ok = n_mis / got.numel() <= 1e-3 and dz < 1e-5
    say("kernels", f"{label}: {n_mis} of {got.numel()} slots differ (max |dz| "
        f"{dz:.3g}; tolerance: <= 0.1% of slots, near-ties |dz| < 1e-5); "
        f"valid slots {int((got >= 0).sum())}")
    return dz, ok


def check_close(label, got, ref, rel, note="atomics sum in another order"):
    """Float agreement within ``rel`` of the plain result's max."""
    err = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    say("kernels", f"{label}: max |d| {err:.3g} of max {scale:.3g} (tolerance: "
        f"{rel:g} of max; {note})")
    return err, err <= rel * scale


def record(checks, name, path, err, ok, fn, plain_fn):
    checks.setdefault(name, []).append(dict(
        path=path, max_abs_err=err, ms=cuda_ms(fn), plain_ms=cuda_ms(plain_fn), ok=ok))


def check_soft_pass(checks, path, model, scene, phase, R, T, gen):
    """K1 soft, K2, K3 and K4 against their plain versions on one scene of
    the soft renderer, at the shapes the path ``path`` gives them."""
    from dbw_torch.ops import texel_grad as tg
    from dbw_torch.render import fragment as fr
    from dbw_torch.render import rasterize as rz
    from dbw_torch.render.renderer import fragment_streams

    rend = model.renderer
    sigma, blur = rend.sigma_blur(phase.sigma)
    geom = rz.project_faces(scene.verts, scene.faces, R, T, rend.camera,
                            z_clip=rend.config.z_clip)
    packed = rz.pack_faces(geom)
    rcfg = rend.config.raster_config()
    rcfg_plain = rcfg._replace(row_chunk=50)

    # K1 soft
    p2f = rz.rasterize_cuda(packed, blur, rcfg)
    ref = rz.rasterize_plain(packed, blur, rcfg_plain)
    dz, ok = check_selection(f"K1 select [{path}, F={packed.shape[1]}, "
                             f"K={rcfg.faces_per_pixel}]", p2f, ref, packed, blur, rcfg)
    record(checks, "K1_select", path, dz, ok,
           lambda: rz.rasterize_cuda(packed, blur, rcfg),
           lambda: rz.rasterize_plain(packed, blur, rcfg_plain))

    # K2
    table, ids, vld, px, py = fragment_streams(scene, geom, p2f)
    M, TH, TW = scene.atlas.maps.shape[:3]
    flags = fr.FragFlags(True, True, rend.config.clip_inside, TH, TW)
    out = fr.frag_fwd_cuda(table, ids, vld, px, py, sigma, flags)
    refo = fr.frag_fwd_plain(table, ids, vld, px, py, sigma, flags)
    id_eq = float((out[0] == refo[0]).float().mean())
    err2 = max(float((a - b).abs().max()) for a, b in zip(out[1:], refo[1:]))
    say("kernels", f"K2 frag fwd [{path}, N={ids.numel()}]: id00 equal on {id_eq:.6f}, "
        f"max |d| of wx/wy/alpha/res {err2:.3g} (tolerance: id00 exact, 1e-5)")
    record(checks, "K2_frag_fwd", path, err2, id_eq == 1.0 and err2 <= 1e-5,
           lambda: fr.frag_fwd_cuda(table, ids, vld, px, py, sigma, flags),
           lambda: fr.frag_fwd_plain(table, ids, vld, px, py, sigma, flags))

    # K3
    res = out[4]
    d_alpha = torch.randn(ids.shape, generator=gen, device=ids.device) * vld
    rows = table.shape[0]
    args3 = (ids, vld, px, py, res, d_alpha, sigma, flags.clip_inside, rows)
    err3, ok3 = check_close(f"K3 frag bwd [{path}, N={ids.numel()}]: d-table",
                            fr.frag_bwd_cuda(*args3), fr.frag_bwd_plain(*args3), 1e-4)
    record(checks, "K3_frag_bwd", path, err3, ok3,
           lambda: fr.frag_bwd_cuda(*args3), lambda: fr.frag_bwd_plain(*args3))

    # K4
    g = torch.randn((ids.numel(), 3), generator=gen, device=ids.device) * vld[:, None]
    args4 = (out[0], out[1], out[2], g, M * TH * TW, TW)
    err4, ok4 = check_close(f"K4 texel grad [{path}, N={ids.numel()}, R={M * TH * TW}]: "
                            "d_maps", tg.quad_maps_grad_cuda(*args4),
                            tg.quad_maps_grad_plain(*args4), 1e-5)
    record(checks, "K4_texel_grad", path, err4, ok4,
           lambda: tg.quad_maps_grad_cuda(*args4), lambda: tg.quad_maps_grad_plain(*args4))


def check_env_pass(checks, model, params, phase, R, T, gen):
    """K1 hard, K4 and K5 against their plain versions on the env pass's
    own inputs (dome + ground, K=1), formed as Renderer.shade forms them."""
    from dbw_torch.ops import scatter as sc
    from dbw_torch.ops import texel_grad as tg
    from dbw_torch.render import rasterize as rz
    from dbw_torch.render.fragment import bary_uv, texel_coords
    from dbw_torch.render.renderer import fragment_streams

    path = "env pass"
    env, _ = model.build_env(params, phase)
    erend = model.renderer_env
    egeom = rz.project_faces(env.verts, env.faces, R, T, erend.camera,
                             z_clip=erend.config.z_clip)
    epacked = rz.pack_faces(egeom)
    ecfg = erend.config.raster_config()
    ecfg_plain = ecfg._replace(row_chunk=50)

    # K1 hard
    ep2f = rz.rasterize_cuda(epacked, 0.0, ecfg, hard=True)
    eref = rz.rasterize_plain(epacked, 0.0, ecfg_plain)
    dz, ok = check_selection(f"K1 select hard [{path}, F={epacked.shape[1]}, K=1]",
                             ep2f, eref, epacked, 0.0, ecfg)
    record(checks, "K1_select_hard", path, dz, ok,
           lambda: rz.rasterize_cuda(epacked, 0.0, ecfg, hard=True),
           lambda: rz.rasterize_plain(epacked, 0.0, ecfg_plain))

    # the gathered face rows of the real selection and their texel coords
    etable, eids, evld, epx, epy = fragment_streams(env, egeom, ep2f, detach_z=False)
    eidx = torch.where(evld > 0, eids, torch.full_like(eids, -1))
    rows = etable[eidx.clamp(min=0).long()]
    uv_u, uv_v = bary_uv(rows, epx, epy, ecfg.perspective_correct, ecfg.clip_barycentric)
    M, TH, TW = env.atlas.maps.shape[:3]
    id00, wx, wy = texel_coords(uv_u, uv_v, rows[:, 18], TH, TW)
    N = eidx.numel()

    # K4 (the d_maps of sample_quad_diff)
    g = torch.randn((N, 3), generator=gen, device=eidx.device) * evld[:, None]
    args4 = (id00, wx, wy, g, M * TH * TW, TW)
    err4, ok4 = check_close(f"K4 texel grad [{path}, N={N}, R={M * TH * TW}]: d_maps",
                            tg.quad_maps_grad_cuda(*args4),
                            tg.quad_maps_grad_plain(*args4), 1e-5)
    record(checks, "K4_texel_grad", path, err4, ok4,
           lambda: tg.quad_maps_grad_cuda(*args4), lambda: tg.quad_maps_grad_plain(*args4))

    # K5: a seeded cotangent of the (N, 20) gathered rows, its first 12
    # columns as the gather's backward passes them. A dome face sums up to
    # ~80,000 fragments, so the float32 rounding of both versions scales
    # with the summed |upd| of an entry, not with its sum: the tolerance is
    # 1e-6 of that, and a float64 sum shows each version's own error.
    n_rows = etable.shape[0]
    upd = torch.randn((N, etable.shape[1]), generator=gen, device=eidx.device)[:, :12]
    got5 = sc.small_table_scatter_add_cuda(eidx, upd, n_rows)
    ref5 = sc.small_table_scatter_add_plain(eidx, upd, n_rows)
    exact = sc.small_table_scatter_add_plain(eidx, upd.double(), n_rows)
    abs_sum = float(sc.small_table_scatter_add_plain(eidx, upd.abs(), n_rows).max())
    err5 = float((got5 - ref5).abs().max())
    ok5 = err5 <= 1e-6 * abs_sum
    say("kernels", f"K5 small scatter [{path}, N={N} (valid {int((eidx >= 0).sum())}), "
        f"table ({n_rows}, 12)]: max |d| {err5:.3g} (tolerance: 1e-6 of the largest "
        f"summed |upd|, {abs_sum:.4g}); to the float64 sum: kernel "
        f"{float((got5.double() - exact).abs().max()):.3g}, plain "
        f"{float((ref5.double() - exact).abs().max()):.3g}; max |sum| "
        f"{float(ref5.abs().max()):.3g}")
    record(checks, "K5_small_scatter", path, err5, ok5,
           lambda: sc.small_table_scatter_add_cuda(eidx, upd, n_rows),
           lambda: sc.small_table_scatter_add_plain(eidx, upd, n_rows))


def phase_kernels(model, device):
    """Each kernel against its plain version on the card, at the shapes of
    every path that launches it: the main path's blocks and env passes, and
    the joint path's one scene. The first check of each kernel is at the
    main path's shapes; its times go into the kernels line."""
    params = model.init_params(seed=0)
    phase = model.phase_for_epoch(0)
    R, T = cameras(N_VIEWS, device)
    gen = torch.Generator(device=device).manual_seed(1)
    checks = {}
    with torch.no_grad():
        noise = torch.randn((model.n_blocks,), generator=gen, device=device)
        blocks, _ = model.build_blocks(params, phase, noise=noise)
        check_soft_pass(checks, "blocks pass", model, blocks, phase, R, T, gen)
        check_env_pass(checks, model, params, phase, R, T, gen)
        joint, _, _ = model.build_scene(params, phase, noise=noise)
        check_soft_pass(checks, "joint", model, joint, phase, R, T, gen)
    for name, cs in checks.items():
        for c in cs:
            say("kernels", f"{name} [{c['path']}]: kernel {c['ms']:.4f} ms, plain "
                f"{c['plain_ms']:.4f} ms (CUDA events, median)")
    bad = [f"{n} [{c['path']}]" for n, cs in checks.items() for c in cs if not c.pop("ok")]
    if bad:
        raise SystemExit(f"kernel check failed: {bad}")
    return {n: dict(max_abs_err=max(c["max_abs_err"] for c in cs), ms=cs[0]["ms"],
                    plain_ms=cs[0]["plain_ms"], checks=cs) for n, cs in checks.items()}


def run_steps(tag, model, params, opt, n_steps, kernel_names, device):
    """n_steps flagship Adam steps through model.forward; every kernel of
    kernel_names must launch in every step, no other kernel may launch.
    Returns (launch counts, per-step seconds)."""
    from dbw_torch import kernels

    phase = model.phase_for_epoch(0, training=True)
    imgs = torch.from_numpy(np.random.default_rng(0).random(
        (N_VIEWS,) + IMG_SIZE + (3,), np.float32)).to(device)
    R, T = cameras(N_VIEWS, device)
    gen = torch.Generator(device=device).manual_seed(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    times = []
    for step in range(n_steps):
        before = dict(kernels.LAUNCHES)
        t0 = time.perf_counter()
        opt.zero_grad(set_to_none=True)
        losses = model.forward(params, phase, imgs, R, T, generator=gen)
        losses["total"].backward()
        opt.step()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        vals = {k: float(v.detach()) for k, v in losses.items()}
        missing = [k for k in kernel_names if kernels.LAUNCHES[k] == before[k]]
        stray = [k for k in kernels.LAUNCHES
                 if k not in kernel_names and kernels.LAUNCHES[k] != before[k]]
        say(tag, f"step {step}: " + " ".join(f"{k}={v:.6g}" for k, v in vals.items())
            + f" ({times[-1] * 1e3:.1f} ms)")
        if not all(math.isfinite(v) for v in vals.values()):
            raise SystemExit(f"{tag}: non-finite loss at step {step}")
        if missing or stray:
            raise SystemExit(f"{tag} step {step}: kernels not launched {missing}, "
                             f"launched off the path {stray}")
        for k, p in params.items():
            if not torch.isfinite(p).all():
                raise SystemExit(f"{tag}: non-finite parameter {k} after step {step}")
    launches = dict(kernels.LAUNCHES)
    with torch.no_grad():
        rec, _ = model.predict(params, phase, R, T, noise=torch.zeros(
            model.n_blocks, device=device))
    if rec.shape != (N_VIEWS,) + IMG_SIZE + (3,) or not torch.isfinite(rec).all() \
            or rec.min() < -1e-6 or rec.max() > 1 + 1e-5:
        raise SystemExit(f"{tag}: bad render: shape {tuple(rec.shape)}")
    say(tag, f"render after {n_steps} steps: {tuple(rec.shape)}, finite, in "
        f"[{float(rec.min()):.3g}, {float(rec.max()):.3g}]")
    med = float(np.median(times[1:]))
    say(tag, f"median step {med * 1e3:.2f} ms ({1.0 / med:.3f} steps/s, steps "
        f"1-{n_steps - 1}, host clock around synchronized steps); peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    say(tag, f"launches: {launches}")
    return launches, times


def phase_main(cfg, device):
    """The shipped config's train step (decoupled env pass), N_STEPS times,
    through model.forward; then the step split by CUDA events, and a
    profiler trace of a few steps."""
    from dbw_torch.train.optimizer import create_optimizer

    model = make_model(cfg, device)
    params = model.init_params(seed=0)
    opt = create_optimizer(cfg, params)
    say("main", "optimizer: Adam, lrs " + ", ".join(
        f"{g['name']} {g['lr']}" for g in opt.param_groups))
    launches, _ = run_steps("main", model, params, opt, N_STEPS, tuple(SOURCES),
                            device)
    split_step(model, params, opt, device)
    profile_steps(model, params, opt, device)
    return launches


# device kernels by family, matched on their names
KERNEL_FAMILIES = {
    "convolution": ("conv", "fft", "xmma", "cudnn", "dgrad", "wgrad", "gemm",
                    "region_transform"),
    "scan (cumprod blend)": ("scan",),
    "hand-written": ("select_kernel", "frag_fwd_kernel", "frag_bwd_kernel",
                     "texel_grad_kernel", "small_scatter_kernel"),
}


def profile_steps(model, params, opt, device):
    """torch.profiler over N_PROFILE_STEPS decoupled steps (after one
    warm-up): the device's busy time (the union of its kernel and copy
    intervals) against the span from the first one's start to the last
    one's end, each family's share of the summed device time, and the
    kernels that take the most."""
    from torch.profiler import ProfilerActivity, profile

    phase = model.phase_for_epoch(0, training=True)
    imgs = torch.from_numpy(np.random.default_rng(3).random(
        (N_VIEWS,) + IMG_SIZE + (3,), np.float32)).to(device)
    R, T = cameras(N_VIEWS, device)
    gen = torch.Generator(device=device).manual_seed(3)

    def step():
        opt.zero_grad(set_to_none=True)
        model.forward(params, phase, imgs, R, T, generator=gen)["total"].backward()
        opt.step()

    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(N_PROFILE_STEPS):
            step()
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / N_PROFILE_STEPS
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False)]
    if not dev:
        raise SystemExit("profile: the trace holds no device time")
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev)
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    span = spans[-1][1] - spans[0][0]
    per_name = {}
    for e in dev:
        per_name[e.name] = per_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start)
    total = sum(per_name.values())
    say("profile", f"{N_PROFILE_STEPS} decoupled steps under torch.profiler, "
        f"{wall:.2f} ms a step on the host clock: device busy {busy / 1e3:.2f} ms "
        f"of a {span / 1e3:.2f} ms span, idle share {1.0 - busy / span:.3f}; "
        f"summed device time {total / 1e3:.2f} ms")
    shares = {fam: sum(t for n, t in per_name.items() if any(k in n for k in keys)) / total
              for fam, keys in KERNEL_FAMILIES.items()}
    say("profile", "share of summed device time: " + ", ".join(
        f"{fam} {v:.3f}" for fam, v in shares.items()))
    for n, t in sorted(per_name.items(), key=lambda kv: -kv[1])[:15]:
        say("profile", f"{t / 1e3:9.3f} ms {t / total:.3f}  {n[:110]}")


def split_step(model, params, opt, device):
    """Time the parts of the decoupled step with CUDA events: the two passes
    that BlocksWorld.predict chains (env pass; blocks pass + composite), the
    losses, the backward and Adam. Median over N_SPLIT_STEPS - 1 steps."""
    phase = model.phase_for_epoch(0, training=True)
    imgs = torch.from_numpy(np.random.default_rng(1).random(
        (N_VIEWS,) + IMG_SIZE + (3,), np.float32)).to(device)
    R, T = cameras(N_VIEWS, device)
    gen = torch.Generator(device=device).manual_seed(2)
    parts = {k: [] for k in ("env pass", "blocks pass", "losses", "backward", "adam")}
    for step in range(N_SPLIT_STEPS):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
        opt.zero_grad(set_to_none=True)
        noise = torch.randn((model.n_blocks,), generator=gen, device=device)
        ev[0].record()
        env_out = model.env_pass(params, phase, R, T)
        ev[1].record()
        rec, aux = model.blocks_pass(params, phase, R, T, env_out, noise=noise)
        ev[2].record()
        losses = model.compute_losses(imgs, rec, params, phase, aux, generator=gen)
        ev[3].record()
        losses["total"].backward()
        ev[4].record()
        opt.step()
        ev[5].record()
        torch.cuda.synchronize()
        if step:
            for i, k in enumerate(parts):
                parts[k].append(ev[i].elapsed_time(ev[i + 1]))
    med = {k: float(np.median(v)) for k, v in parts.items()}
    say("split", "decoupled step by CUDA events (median of "
        f"{N_SPLIT_STEPS - 1}): " + ", ".join(f"{k} {v:.2f} ms" for k, v in med.items())
        + f"; sum {sum(med.values()):.2f} ms")


def phase_joint(cfg, device):
    """The joint-rendering path: the same config with decouple_rendering=False."""
    from dbw_torch.train.optimizer import create_optimizer

    model = make_model(cfg, device, rend_optim=dict(decouple_rendering=False))
    params = model.init_params(seed=0)
    opt = create_optimizer(cfg, params)
    run_steps("joint", model, params, opt, N_JOINT_STEPS, JOINT_KERNELS, device)


def phase_train(cfg, device):
    """One epoch on the port's synthetic ground truth of the config, then a
    model.pkl round trip that must reproduce the next step."""
    from dbw_torch.data import create_train_val_test_loader
    from dbw_torch.train import checkpoint as ck
    from dbw_torch.train.optimizer import create_optimizer
    from dbw_torch.train.scheduler import base_lrs, create_scheduler, set_lrs

    t0 = time.perf_counter()
    train, val, test = create_train_val_test_loader(cfg, device=device)
    torch.cuda.synchronize()
    ds = train.dataset
    say("train", f"synthetic GT rendered on the card: train {ds.imgs.shape}, val "
        f"{val.dataset.imgs.shape}, test {test.dataset.imgs.shape}, "
        f"{len(ds.pc_gt)} GT points, {time.perf_counter() - t0:.1f} s")
    if not (np.isfinite(ds.imgs).all() and ds.imgs.std() > 0.05):
        raise SystemExit("train: bad synthetic ground truth")
    model = make_model(cfg, device, img_size=ds.img_size, K=ds.K[0])
    params = model.init_params(seed=cfg["training"]["seed"])
    opt = create_optimizer(cfg, params)
    sched = create_scheduler(cfg, base_lrs(opt))
    imgs_all = torch.from_numpy(ds.imgs).to(device)
    R_all, T_all = torch.from_numpy(ds.R).to(device), torch.from_numpy(ds.T).to(device)
    bs = train.batch_size
    gen = torch.Generator(device=device).manual_seed(cfg["training"]["seed"])

    def batch(ids):
        # a ragged last batch repeats its last view, as the JAX trainer does
        ids = np.concatenate([ids, np.repeat(ids[-1:], bs - len(ids))])
        idx = torch.from_numpy(ids.astype(np.int64)).to(device)
        return imgs_all[idx], R_all[idx], T_all[idx]

    epoch = 0
    phase = model.phase_for_epoch(epoch, training=True)
    set_lrs(opt, sched.lrs(epoch))
    order = list(train.iter_indices())
    totals = []
    t0 = time.perf_counter()
    for ids in order:
        opt.zero_grad(set_to_none=True)
        losses = model.forward(params, phase, *batch(ids), generator=gen)
        losses["total"].backward()
        opt.step()
        totals.append(float(losses["total"].detach()))
    torch.cuda.synchronize()
    if not all(math.isfinite(v) for v in totals):
        raise SystemExit(f"train: non-finite loss in the epoch: {totals}")
    say("train", f"epoch {epoch}: {len(order)} batches of {bs} (loader order "
        f"{[list(map(int, o)) for o in order[:2]]}...), lrs "
        f"{ {g['name']: g['lr'] for g in opt.param_groups} }, total loss "
        f"{totals[0]:.6g} -> {totals[-1]:.6g}, {time.perf_counter() - t0:.2f} s")

    with tempfile.TemporaryDirectory() as run_dir:
        path = ck.save_checkpoint(Path(run_dir) / "model.pkl", params, opt,
                                  epoch + 1, len(order),
                                  model_kwargs=cfg["model"])
        state = ck.load_checkpoint(path)
        size = path.stat().st_size
    params2 = model.init_params(seed=1)
    opt2 = create_optimizer(cfg, params2)
    set_lrs(opt2, sched.lrs(epoch + 1))
    set_lrs(opt, sched.lrs(epoch + 1))
    ck.restore(state, params2, opt2)
    same = all(torch.equal(params[k], params2[k]) for k in params) and all(
        torch.equal(opt.state[params[k]][f], opt2.state[params2[k]][f])
        for k in params for f in ("step", "exp_avg", "exp_avg_sq"))
    if not same:
        raise SystemExit("train: reloaded state differs from the saved one")

    # the next step from both states: the same batch and random draws
    imgs, R, T = batch(next(iter(train.iter_indices())))
    noise = torch.randn((model.n_blocks,), generator=gen, device=device)
    ou = torch.rand((model.n_blocks, 1000, 3), generator=gen, device=device)
    phase = model.phase_for_epoch(epoch + 1, training=True)
    out = []
    for p, o in ((params, opt), (params2, opt2)):
        o.zero_grad(set_to_none=True)
        losses = model.forward(p, phase, imgs, R, T, opacity_noise=noise, overlap_u=ou)
        losses["total"].backward()
        out.append({k: float(v.detach()) for k, v in losses.items()})
    grad_rel = max(float((params2[k].grad - params[k].grad).abs().max())
                   / max(float(params[k].grad.abs().max()), 1e-30) for k in params)
    # the gradients pass through atomics, whose order varies from run to
    # run: the optimizer states are held exactly by stepping both from the
    # in-memory run's gradient
    for k in params:
        params2[k].grad = params[k].grad.clone()
    opt.step()
    opt2.step()
    same_params = all(torch.equal(params[k], params2[k]) for k in params)
    say("train", f"model.pkl ({size} bytes) round trip: state equal; next step "
        f"losses equal {out[0] == out[1]} (total {out[0]['total']:.9g} vs "
        f"{out[1]['total']:.9g}), grads max |d|/max|g| {grad_rel:.3g} "
        f"(tolerance 1e-5, atomics), params after the step equal {same_params}")
    if out[0] != out[1] or grad_rel > 1e-5 or not same_params:
        raise SystemExit("train: the reloaded checkpoint does not reproduce the step")


def reference_step(cfg, device, decouple):
    """The small reference model's loss and gradient on ``device``, from a
    seeded init and seeded draws: ({loss: value}, {leaf: grad on the CPU})."""
    from dbw_torch.convert import scene_params_from_numpy

    small = dict(mesh=dict(n_blocks=3, txt_size=32, T_range=[0.2, 0.2, 0.2]),
                 renderer=dict(faces_per_pixel=5))
    model = make_model(cfg, device, img_size=(48, 64), **small,
                       rend_optim=dict(decouple_rendering=decouple))
    params = scene_params_from_numpy(model.init_params_numpy(0), device)
    rng = np.random.default_rng(2)
    imgs = torch.from_numpy(rng.random((2, 48, 64, 3), np.float32)).to(device)
    noise = torch.from_numpy(rng.standard_normal(3).astype(np.float32)).to(device)
    ou = torch.from_numpy(rng.random((3, 1000, 3), np.float32)).to(device)
    R, T = cameras(2, device)
    losses = model.forward(params, model.phase_for_epoch(0), imgs, R, T,
                           opacity_noise=noise, overlap_u=ou)
    losses["total"].backward()
    return ({k: float(v.detach()) for k, v in losses.items()},
            {k: p.grad.cpu() for k, p in params.items()})


def grad_gap(ga, gb):
    """Per leaf, max |ga - gb| over max |gb|."""
    return {k: float((ga[k] - gb[k]).abs().max()) / max(float(gb[k].abs().max()), 1e-30)
            for k in gb}


def phase_reference(cfg, device):
    """A small model on the card (kernels) against the same model on the CPU
    (plain versions): losses rtol 1e-4, gradients 1e-3 of each leaf's max;
    decoupled (as configured) and joint."""
    for decouple in (True, False):
        (lg, gg), (lc, gc) = (reference_step(cfg, d, decouple) for d in (device, "cpu"))
        worst_l = max(abs(lg[k] - lc[k]) / max(abs(lc[k]), 1e-12) for k in lc)
        rel_g = grad_gap(gg, gc)
        leaf = max(rel_g, key=rel_g.get)
        worst_g = rel_g[leaf]
        mode = "decoupled" if decouple else "joint"
        say("reference", f"{mode}: 48x64, 3 blocks, K=5, 2 views, card vs CPU: "
            f"losses max rel {worst_l:.3g} (tolerance 1e-4), grads max |d|/max|g| "
            f"{worst_g:.3g} at {leaf} (tolerance 1e-3); total {lg['total']:.6g} vs "
            f"{lc['total']:.6g}")
        if not (worst_l <= 1e-4 and worst_g <= 1e-3):
            raise SystemExit(f"card and CPU disagree on the small {mode} model")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from dbw_torch import kernels

    t_start = time.perf_counter()
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

    cfg = load_cfg()
    model = make_model(cfg, device)
    results = phase_kernels(model, device)
    del model
    torch.cuda.empty_cache()
    launches = phase_main(cfg, device)
    phase_joint(cfg, device)
    phase_train(cfg, device)
    phase_reference(cfg, device)
    say("done", f"all phases in {time.perf_counter() - t_start:.1f} s")

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
