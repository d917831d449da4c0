#!/usr/bin/env python3
"""Time the PyTorch port's hand-written kernels of two checkouts on one card.

    python3 scripts/torch_kernel_ab.py --base DIR

DIR is another checkout of the repository, for example the parent commit
unpacked with ``git archive``. The script runs itself in one child process
for each of base, this checkout, this checkout, base (in turns, so that a
drift of the card shows). Each child builds its checkout's kernels and
times, on the shipped configs/synthetic/dtu_shaped.yml at 300x400 and 4
views (the flagship shapes of chip_smoke.py): K1 soft at the blocks pass's
and the joint scene's faces, K1 hard at the env pass's, K2 and K3 at the
blocks pass's, the joint scene's and the band path's fragments (the middle
band of 3), K4 at the blocks pass's, env pass's and joint scene's
fragments, and K5 at the env pass's rows; then the flagship step itself
(chip_smoke.py's run_steps: 10 steps of forward, backward and Adam, the
median of steps 1-9 on the host clock around synchronized steps, under the
key "step [decoupled]"). Each version gets its own
inputs where its signature differs: a K3 that takes a residual gets the
one its K2 saved, one that takes the table gets the table. Both checkouts
are timed by this checkout's chip_smoke.py: a time is the median of 5
CUDA-event pairs, each around 20 back-to-back calls of the wrapper, over
20; for K3 and K5 also the device time of one launch from a torch.profiler
trace. The last line is a JSON object with each kernel's times per
checkout. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import importlib.util
import inspect
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def timers():
    """This checkout's chip_smoke.py, for its timers (cuda_ms, device_ms),
    which import nothing of the checkout being timed."""
    spec = importlib.util.spec_from_file_location("chip_smoke_timers", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def child(root):
    sys.path.insert(0, str(root))
    import torch

    import chip_smoke as cs
    from dbw_torch import kernels
    from dbw_torch.ops import scatter as sc
    from dbw_torch.ops import texel_grad as tg
    from dbw_torch.render import fragment as fr
    from dbw_torch.render import rasterize as rz
    from dbw_torch.render.fragment import bary_uv, texel_coords
    from dbw_torch.render.renderer import fragment_streams

    tm = timers()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels.library()
    device = torch.device("cuda")
    cfg = cs.load_cfg()
    model = cs.make_model(cfg, device)
    params = model.init_params(seed=0)
    phase = model.phase_for_epoch(0)
    R, T = cs.cameras(cs.N_VIEWS, device)
    gen = torch.Generator(device=device).manual_seed(1)
    k3_takes_res = "res" in inspect.signature(fr.frag_bwd_cuda).parameters
    out, dev = {}, {}

    def time(key, fn, kernel=None):
        out[key] = tm.cuda_ms(fn)
        if kernel:
            dev[key] = tm.device_ms(fn, kernel)

    def k3(key, table, ids, vld, px, py, sigma, flags, K):
        fwd = fr.frag_fwd_cuda(table, ids, vld, px, py, sigma, flags)
        d_alpha = torch.randn(ids.shape, generator=gen, device=device) * vld
        if k3_takes_res:
            args = (ids, vld, px, py, fwd[4], d_alpha, sigma, flags.clip_inside,
                    table.shape[0])
        else:
            args = (table, ids, vld, px, py, d_alpha, sigma, flags.clip_inside, K)
        time(key, lambda: fr.frag_bwd_cuda(*args), "frag_bwd_kernel")
        return fwd

    with torch.no_grad():
        noise = torch.randn((model.n_blocks,), generator=gen, device=device)
        scenes = {"blocks pass": model.build_blocks(params, phase, noise=noise)[0],
                  "joint": model.build_scene(params, phase, noise=noise)[0]}
        rend = model.renderer
        sigma, blur = rend.sigma_blur(phase.sigma)
        rcfg = rend.config.raster_config()
        K = rcfg.faces_per_pixel
        for path, scene in scenes.items():
            geom = rz.project_faces(scene.verts, scene.faces, R, T, rend.camera,
                                    z_clip=rend.config.z_clip)
            packed = rz.pack_faces(geom)
            time(f"K1_select [{path}]", lambda: rz.rasterize_cuda(packed, blur, rcfg))
            p2f = rz.rasterize_cuda(packed, blur, rcfg)
            streams = fragment_streams(scene, geom, p2f)
            M, TH, TW = scene.atlas.maps.shape[:3]
            flags = fr.FragFlags(True, True, rend.config.clip_inside, TH, TW)
            time(f"K2_frag_fwd [{path}]", lambda: fr.frag_fwd_cuda(*streams, sigma, flags))
            id00, wx, wy = k3(f"K3_frag_bwd [{path}]", *streams, sigma, flags, K)[:3]
            g = torch.randn((id00.numel(), 3), generator=gen, device=device) * streams[2][:, None]
            time(f"K4_texel_grad [{path}]",
                 lambda: tg.quad_maps_grad_cuda(id00, wx, wy, g, M * TH * TW, TW, K))
            if path == "blocks pass":
                band = cs.BAND_SPLITS["3 bands"][1]
                bp2f = rz.rasterize_cuda(packed, blur, rcfg, row_range=band)
                bstreams = fragment_streams(scene, geom, bp2f, image_size=rcfg.image_size,
                                            row0=band[0])
                k3("K3_frag_bwd [band]", *bstreams, sigma, flags, K)

        env, _ = model.build_env(params, phase)
        erend = model.renderer_env
        egeom = rz.project_faces(env.verts, env.faces, R, T, erend.camera,
                                 z_clip=erend.config.z_clip)
        epacked = rz.pack_faces(egeom)
        ecfg = erend.config.raster_config()
        time("K1_select_hard [env pass]",
             lambda: rz.rasterize_cuda(epacked, 0.0, ecfg, hard=True))
        ep2f = rz.rasterize_cuda(epacked, 0.0, ecfg, hard=True)
        etable, eids, evld, epx, epy = fragment_streams(env, egeom, ep2f, detach_z=False)
        eidx = torch.where(evld > 0, eids, torch.full_like(eids, -1))
        rows = etable[eidx.clamp(min=0).long()]
        uv_u, uv_v = bary_uv(rows, epx, epy, ecfg.perspective_correct,
                             ecfg.clip_barycentric)
        M, TH, TW = env.atlas.maps.shape[:3]
        id00, wx, wy = texel_coords(uv_u, uv_v, rows[:, 18], TH, TW)
        g = torch.randn((eidx.numel(), 3), generator=gen, device=device) * evld[:, None]
        time("K4_texel_grad [env pass]",
             lambda: tg.quad_maps_grad_cuda(id00, wx, wy, g, M * TH * TW, TW, 1))
        upd = torch.randn((eidx.numel(), etable.shape[1]), generator=gen,
                          device=device)[:, :12]
        time("K5_small_scatter [env pass]",
             lambda: sc.small_table_scatter_add_cuda(eidx, upd, etable.shape[0]),
             "small_scatter_kernel")
    # the flagship step, by the checkout's own run_steps (stdout: its
    # per-step lines come before this function's JSON line)
    from dbw_torch.train.optimizer import create_optimizer

    step_params = model.init_params(seed=0)
    opt = create_optimizer(cfg, step_params)
    _, times = cs.run_steps("step", model, step_params, opt, cs.N_STEPS,
                            getattr(cs, "STEP_KERNELS", tuple(cs.SOURCES)), device)
    out["step [decoupled]"] = 1e3 * float(sorted(times[1:])[len(times[1:]) // 2])
    print(json.dumps({"root": str(root), "ms": out, "device_ms": dev,
                      "timer": "CUDA events around 20 calls, median of 5; "
                               "device_ms: torch.profiler, per launch"}), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--base", type=Path, help="the other checkout")
    ap.add_argument("--child", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        return child(args.child.resolve())
    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    order = [("base", args.base.resolve()), ("this", HERE), ("this", HERE),
             ("base", args.base.resolve())]
    runs = []
    for tag, root in order:
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--child",
                               str(root)], cwd=root, capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        print(tag, json.dumps({"ms": res["ms"], "device_ms": res["device_ms"]}), flush=True)
        runs.append((tag, res))
    # a device time the profiler did not record is None and left out
    table = {what: {k: {tag: sorted(r[what][k] for t, r in runs
                                    if t == tag and r[what][k] is not None)
                        for tag in ("base", "this")}
                    for k in runs[0][1][what]}
             for what in ("ms", "device_ms")}
    for what, rows in table.items():
        for k, v in rows.items():
            print(f"{k} ({what}): base {v['base']}, this {v['this']}", flush=True)
    print(json.dumps({"card": smi, **table}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
