#!/usr/bin/env python3
"""Hold the port's device mesh across cards against one card: one rank per
card under NCCL, on the flagship (configs/synthetic/dtu_shaped.yml as
shipped, 300x400, 10 blocks, K=10, B=4).

    torchrun --nproc-per-node 4 scripts/torch_multi_card.py [--probe-epochs 24]
        [--out runs/multi_card]

Every rank first runs the one-card references on its own card (the same
seeded steps and runs without the mesh; their largest pairwise gap, times
4, floored at the parity budget, is the tolerance, as in chip_smoke.py's
protocol phase). Then, on all ranks together:

- the main path's step (``chip_smoke.mesh_steps``: 5 Adam steps of one
  seed) on (seed=1, data=4), (seed=1, sp=4) and (seed=1, data=2, sp=2):
  losses and parameters against one card, every kernel launched in every
  step on every rank, each rank's K1 selections on its own rows only (its
  band on an sp axis, read from their pix_to_face), steps/s against one
  card, each rank's device idle
  share over 3 more steps under torch.profiler, the collectives timed
  alone (the gradient all_reduce, the band gather and its transpose);
- the 5-seed protocol (seeds 11 22 33 44 55, chip_smoke's
  PROTOCOL_OVERRIDES) on its default layout, factor_devices(4, 5) =
  (seed=4, data=1): 8 slots, 3 padded; its valid slots' final losses
  against one card, seed-steps/s against one card;
- 2 synthetic scenes (chip_smoke's scenes phase) as (scene=2, seed=1,
  data=2): each scene's final loss against one card;
- with ``--probe-epochs`` N > 0, the protocol for N epochs (the shipped
  stat intervals, no final evaluation) on the mesh and, before it, on one
  card (every rank on its own): their seed-steps/s and final losses.

Rank 0 prints the card's name and power limit, one line per check, and a
JSON summary as its last line (also written to ``--out``/summary.json),
and exits non-zero when a check fails (so does torchrun).
"""

import argparse
import copy
import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

LAYOUTS = {"seed=1, data=4": dict(n_seed=1, n_data=4),
           "seed=1, sp=4": dict(n_seed=1, n_data=1, n_spatial=4),
           "seed=1, data=2, sp=2": dict(n_seed=1, n_data=2, n_spatial=2)}
SCENES_LAYOUT = {"scene": 2, "seed": 1, "data": 2}
# Adam steps of each layout (and of the one-card runs); steps/s over all
# but the first
N_STEPS = 10


def scenes_run(root, device, world_size=None):
    """chip_smoke's two synthetic scenes, 1 seed each, SCENES_OVERRIDES, no
    evaluation -> (final (n_scene, 1) losses, seconds of the loop, mesh)."""
    from dbw_torch.train.multi_scene import MultiSceneTrainer
    from dbw_torch.utils.config import load_yaml

    cfgs = []
    for k, ds_seed in enumerate(cs.SCENE_DATASET_SEEDS):
        cfg = load_yaml(cs.CONFIG)
        cfg["training"].update(copy.deepcopy(cs.SCENES_OVERRIDES))
        cfg["training"]["seed"] += k
        cfg["dataset"].update(seed=ds_seed, tag=f"scene{ds_seed}")
        cfgs.append(cfg)
    tr = MultiSceneTrainer(cfgs, [Path(root) / f"scene{s}" for s in cs.SCENE_DATASET_SEEDS],
                           n_seeds=1, device=device, world_size=world_size)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, _, losses = tr.run()
    torch.cuda.synchronize()
    return np.asarray(losses), time.perf_counter() - t0, (None if tr.mesh is None
                                                          else dict(tr.mesh.shape))


def probe_cfg(epochs):
    """The probe's config: the shipped flagship for ``epochs`` epochs, no
    evolution stream."""
    from dbw_torch.utils.config import load_yaml

    cfg = load_yaml(cs.CONFIG)
    cfg["training"]["n_epoches"] = epochs
    cfg["training"]["multi_seed_viz"] = False
    return cfg


def largest_gap(runs):
    """The largest pairwise gap of a list of arrays, elementwise."""
    return np.max([np.abs(np.asarray(a) - np.asarray(b))
                   for i, a in enumerate(runs) for b in runs[i + 1:]], axis=0)


def main():
    import torch.distributed as dist

    from dbw_torch import kernels
    from dbw_torch.parallel.mesh import close_distributed, init_distributed, world
    from dbw_torch.utils.config import load_yaml

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--probe-epochs", type=int, default=24,
                   help="epochs of the protocol probe on the mesh (0: none)")
    p.add_argument("--out", default="runs/multi_card")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("torch_multi_card: no CUDA device", file=sys.stderr)
        return 2
    device = init_distributed("cuda")
    rank, n = world()
    out_dir = ROOT / args.out
    if rank == 0:
        out_dir.mkdir(parents=True, exist_ok=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    res = {"rank": rank, "device": str(device), "name": torch.cuda.get_device_name(device),
           "backend": dist.get_backend()}
    # the run directories of the mesh's runs, one for every rank
    shared = [tempfile.mkdtemp() if rank == 0 else None]
    try:
        if rank == 0:
            kernels.library()  # one build, then every rank loads it
        dist.barrier()
        kernels.library()
        dist.broadcast_object_list(shared, src=0)
        shared = Path(shared[0])
        cfg = load_yaml(cs.CONFIG)
        pcfg = load_yaml(cs.CONFIG)
        pcfg["training"].update(copy.deepcopy(cs.PROTOCOL_OVERRIDES))
        with tempfile.TemporaryDirectory() as tmp:
            # one-card references, one per rank on its own card
            res["one_card_steps"] = cs.mesh_steps(cfg, device, idle=True, n_steps=N_STEPS)
            _, loss, wall, _ = cs.protocol_run(pcfg, Path(tmp) / "p1", device, world_size=1)
            res["one_card_protocol"] = dict(losses=loss, wall_s=wall)
            loss, wall, _ = scenes_run(Path(tmp) / "s1", device, world_size=1)
            res["one_card_scenes"] = dict(losses=loss, wall_s=wall)
            if args.probe_epochs > 0:
                pr, loss, wall, _ = cs.protocol_run(probe_cfg(args.probe_epochs),
                                                    Path(tmp) / "q1", device, world_size=1)
                res["one_card_probe"] = dict(losses=loss, wall_s=wall,
                                             iterations=pr.n_epoches * pr.n_batches,
                                             n_valid=pr.n_valid)
            dist.barrier()
            for name, layout in LAYOUTS.items():
                res[name] = cs.mesh_steps(cfg, device, layout, idle=True, n_steps=N_STEPS)
            m, loss, wall, launches = cs.protocol_run(pcfg, shared / "protocol", device)
            res["protocol"] = dict(losses=loss, wall_s=wall, launches=launches,
                                   slots=len(m.seeds), n_valid=m.n_valid,
                                   mesh=dict(m.mesh.shape),
                                   iterations=m.n_epoches * m.n_batches)
            loss, wall, mesh = scenes_run(shared / "scenes", device)
            res["scenes"] = dict(losses=loss, wall_s=wall, mesh=mesh)
            if args.probe_epochs > 0:
                pr, loss, wall, _ = cs.protocol_run(probe_cfg(args.probe_epochs),
                                                    shared / "probe", device)
                res["probe"] = dict(losses=loss, wall_s=wall, epochs=args.probe_epochs,
                                    iterations=pr.n_epoches * pr.n_batches,
                                    n_valid=pr.n_valid, slots=len(pr.seeds))
        torch.save(res, shared / f"rank{rank}.pt")
        dist.barrier()
        ok = report(shared, out_dir, n) if rank == 0 else True
    finally:
        close_distributed()
        if rank == 0:
            shutil.rmtree(shared, ignore_errors=True)
    return 0 if ok else 1


def report(shared, out_dir, n):
    """Rank 0: every rank's results (in ``shared``) against one card; prints
    the summary and writes it to ``out_dir``. -> whether every check
    held."""
    outs = [torch.load(shared / f"rank{r}.pt", weights_only=False) for r in range(n)]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()
    print("\n".join(smi), flush=True)
    refs = [o["one_card_steps"] for o in outs]
    gap_l = float(largest_gap([r["losses"].numpy() for r in refs]).max())
    gap_p = max(float(largest_gap([r["params"][k].numpy() for r in refs]).max())
                for k in refs[0]["params"])
    tol_l = np.maximum(cs.PROTOCOL_SPREAD_FACTOR * gap_l,
                       cs.PROTOCOL_RTOL_FLOOR * refs[0]["losses"].abs().numpy())
    tol_p = max(cs.PROTOCOL_SPREAD_FACTOR * gap_p, cs.MESH_PARAM_ATOL)
    one_sps = float(np.median([r["steps_per_s"] for r in refs]))
    ok = all(o["backend"] == "nccl" for o in outs) and all(cs.own_rows(r, {}, 0) for r in refs)
    summary = {"ranks": n, "backend": outs[0]["backend"], "cards": [o["name"] for o in outs],
               "power": smi, "one_card": {
                   "steps_per_s": [r["steps_per_s"] for r in refs],
                   "idle_share": [r.get("idle_share") for r in refs],
                   "loss_gap": gap_l, "param_gap": gap_p,
                   "loss_tolerance": float(tol_l.max()), "param_tolerance": tol_p}}
    print(f"[multi-card] {n} ranks, backend {outs[0]['backend']}; one card: "
          f"{[round(r['steps_per_s'], 3) for r in refs]} steps/s, idle share "
          f"{[r.get('idle_share') for r in refs]}; the one-card runs' largest loss gap "
          f"{gap_l:.3e}, parameter gap {gap_p:.3e}", flush=True)
    for name in LAYOUTS:
        rows = []
        for r, o in enumerate(outs):
            x = o[name]
            lg = (x["losses"] - refs[0]["losses"]).abs().numpy()
            pg = max(float((x["params"][k] - refs[0]["params"][k]).abs().max())
                     for k in x["params"])
            every = all(all(v > 0 for v in st.values()) for st in x["per_step"])
            own_band = cs.own_rows(x, LAYOUTS[name], r)
            ok &= bool((lg <= tol_l).all()) and pg <= tol_p and every and own_band
            rows.append(dict(steps_per_s=x["steps_per_s"], idle_share=x.get("idle_share"),
                             allreduce_ms=x["allreduce_ms"],
                             allreduce_bytes=x["allreduce_bytes"],
                             allreduce_ranks=x["allreduce_ranks"],
                             band_gather_ms=x.get("band_gather_ms"),
                             loss_gap=float(lg.max()), param_gap=pg, launches=x["launches"],
                             every_kernel_every_step=every, k1_rows=x["rows"],
                             own_band=own_band))
            print(f"[multi-card] {name}, rank {r}: {x['steps_per_s']:.3f} steps/s "
                  f"({x['steps_per_s'] / one_sps:.3f}x one card), idle share "
                  f"{x.get('idle_share')}; loss gap {lg.max():.3e}, parameter gap {pg:.3e}; "
                  f"every kernel every step {every}; K1's (row0, rows) {x['rows']}, its own "
                  f"band {own_band}; all_reduce {x['allreduce_ms']:.3f} ms "
                  f"({x['allreduce_bytes']} B over {x['allreduce_ranks']} ranks), band "
                  f"gather {x.get('band_gather_ms')} ms", flush=True)
        summary[name] = rows
    one_p = [o["one_card_protocol"] for o in outs]
    tol_a = np.maximum(cs.PROTOCOL_SPREAD_FACTOR * largest_gap(
        [q["losses"] for q in one_p]).max(),
        cs.PROTOCOL_RTOL_FLOOR * np.abs(one_p[0]["losses"]))
    pm = outs[0]["protocol"]
    gaps = [float(np.abs(o["protocol"]["losses"] - one_p[0]["losses"]).max()) for o in outs]
    ok &= all((np.abs(o["protocol"]["losses"] - one_p[0]["losses"]) <= tol_a).all()
              for o in outs)
    ok &= pm["mesh"] == {"seed": 4, "data": 1} and pm["slots"] == 8
    S, it = pm["n_valid"], pm["iterations"]
    one_sss = float(np.median([S * it / q["wall_s"] for q in one_p]))
    summary["protocol"] = dict(mesh=pm["mesh"], slots=pm["slots"], seeds=S, iterations=it,
                               seed_steps_per_s=S * it / pm["wall_s"],
                               one_card_seed_steps_per_s=one_sss,
                               final_losses=pm["losses"].tolist(),
                               one_card_losses=one_p[0]["losses"].tolist(),
                               largest_gap=max(gaps), tolerance=float(tol_a.max()))
    print(f"[multi-card] protocol on {pm['mesh']}: {S} seeds in {pm['slots']} slots, {it} "
          f"iterations: {S * it / pm['wall_s']:.3f} seed-steps/s against one card's "
          f"{one_sss:.3f}; largest loss gap to one card {max(gaps):.3e} (tolerance "
          f"{tol_a.max():.3e})", flush=True)
    one_s = [o["one_card_scenes"] for o in outs]
    tol_s = np.maximum(cs.PROTOCOL_SPREAD_FACTOR * largest_gap(
        [q["losses"] for q in one_s]).max(), cs.PROTOCOL_RTOL_FLOOR * np.abs(one_s[0]["losses"]))
    sm = outs[0]["scenes"]
    sgaps = [float(np.abs(o["scenes"]["losses"] - one_s[0]["losses"]).max()) for o in outs]
    ok &= all((np.abs(o["scenes"]["losses"] - one_s[0]["losses"]) <= tol_s).all()
              for o in outs)
    ok &= sm["mesh"] == SCENES_LAYOUT
    summary["scenes"] = dict(mesh=sm["mesh"], wall_s=sm["wall_s"],
                             one_card_wall_s=float(np.median([q["wall_s"] for q in one_s])),
                             final_losses=sm["losses"].ravel().tolist(),
                             one_card_losses=one_s[0]["losses"].ravel().tolist(),
                             largest_gap=max(sgaps), tolerance=float(tol_s.max()))
    print(f"[multi-card] scenes on {sm['mesh']}: loop {sm['wall_s']:.2f} s against one "
          f"card's {summary['scenes']['one_card_wall_s']:.2f} s; largest loss gap "
          f"{max(sgaps):.3e} (tolerance {tol_s.max():.3e})", flush=True)
    if "probe" in outs[0]:
        pr = outs[0]["probe"]
        one_q = [o["one_card_probe"] for o in outs]
        sss = pr["n_valid"] * pr["iterations"] / pr["wall_s"]
        one_qsss = [q["n_valid"] * q["iterations"] / q["wall_s"] for q in one_q]
        summary["probe"] = dict(epochs=pr["epochs"], iterations=pr["iterations"],
                                seeds=pr["n_valid"], slots=pr["slots"], loop_s=pr["wall_s"],
                                seed_steps_per_s=sss, final_losses=pr["losses"].tolist(),
                                one_card_seed_steps_per_s=one_qsss,
                                one_card_final_losses=one_q[0]["losses"].tolist())
        print(f"[multi-card] probe, {pr['epochs']} epochs: {sss:.3f} seed-steps/s on the "
              f"mesh, {[round(v, 3) for v in one_qsss]} on one card "
              f"({sss / float(np.median(one_qsss)):.3f}x their median); final losses "
              f"{pr['losses'].tolist()} on the mesh, {one_q[0]['losses'].tolist()} on one "
              f"card", flush=True)
    summary["ok"] = bool(ok)
    (out_dir / "summary.json").write_text(json.dumps(summary, indent=1))
    print(json.dumps(summary), flush=True)
    return ok


if __name__ == "__main__":
    sys.exit(main())
