#!/usr/bin/env python3
"""Time each viz stream of a finished run with the PyTorch port (the twin
of scripts/viz_probe.py).

    python3 scripts/torch_viz_probe.py --run runs/synthetic/<tag>
        [--ckpt model.pkl] [--cpu]

The Trainer renders its viz streams once a val interval
(``Trainer.viz_images``). This probe loads a finished run's checkpoint
and times each stream on 4 views of its training set: the soft predict,
the edge overlay (the 4x supersampled hard raster of ``renderer_viz.
draw_edges``), the hard predict (``filter_transparent``), the synthetic
predict, their sum, and the pull of three uint8 renders to the host. Then
the save path of ``Trainer.save``: the bytes of ``train/checkpoint.py``'s
``snapshot`` (the parameters and the Adam state), its time, and the time
of pulling it to the host. Each time is the host clock around 5 calls
that end in a device synchronize, over 5, after one call. Runs on the card
unless ``--cpu``. Returns {label: ms} (and the snapshot's bytes).
"""

import argparse
import sys
import time
from dataclasses import replace
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from dbw_torch.data import create_train_val_test_loader  # noqa: E402
from dbw_torch.models import load_model_from_checkpoint  # noqa: E402
from dbw_torch.render.trajectory import to_u8  # noqa: E402
from dbw_torch.train import checkpoint as ck  # noqa: E402
from dbw_torch.train.optimizer import create_optimizer  # noqa: E402
from dbw_torch.utils.config import load_yaml  # noqa: E402
from dbw_torch.utils.device import DEFAULT_DEVICE, resolve_device  # noqa: E402

N_VIEWS = 4
N_CALLS = 5


def timeit(label, fn, device, n=N_CALLS):
    """Seconds of one fn() call; prints the label and the milliseconds."""
    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    sync()
    dt = (time.perf_counter() - t0) / n
    print(f"{label:28s} {dt * 1e3:9.3f} ms", flush=True)
    return dt


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--run", required=True)
    p.add_argument("--ckpt", default="model.pkl")
    p.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = p.parse_args(argv)
    device = resolve_device("cpu" if args.cpu else DEFAULT_DEVICE)
    run_dir = Path(args.run)
    cfg = load_yaml(sorted(run_dir.glob("*.yml"))[0])
    train_loader, _, _ = create_train_val_test_loader(cfg, device=device)
    ds = train_loader.dataset
    model, params, state = load_model_from_checkpoint(run_dir / args.ckpt, ds.img_size,
                                                      device=device)
    model.set_camera(ds.K[0])
    R = torch.as_tensor(ds.R[:N_VIEWS]).to(device)
    T = torch.as_tensor(ds.T[:N_VIEWS]).to(device)
    phase = model.phase_for_epoch(int(cfg["training"]["n_epoches"]) - 1, training=False)
    phase_hard = replace(phase, filter_transparent=True)
    face_cols = torch.cat([torch.zeros((model.env_n_faces, 3), device=device),
                           torch.ones((model.n_blocks * model.BNF, 3), device=device)])

    def edges(rec):
        scene, _, _ = model.build_scene(params, phase)
        return model.renderer_viz.draw_edges(rec, scene, R, T, face_cols)

    ms = {}
    with torch.no_grad():
        rec = model.predict(params, phase, R, T)[0]
        streams = {
            "soft predict (4 views)": lambda: model.predict(params, phase, R, T)[0],
            "edge overlay (ss4 raster)": lambda: edges(rec),
            "hard predict": lambda: model.predict(params, phase_hard, R, T)[0],
            "synthetic predict": lambda: model.predict_synthetic(params, phase, R, T),
        }
        for label, fn in streams.items():
            ms[label] = 1e3 * timeit(label, fn, device)
        ms["SUM (viz streams)"] = sum(ms.values())
        print(f"{'SUM (viz streams)':28s} {ms['SUM (viz streams)']:9.3f} ms")

        # the pull of the viz outputs to the host (uint8, what the Trainer's
        # host worker receives)
        u8 = [to_u8(rec)] * 3
        ms["viz D2H pull (3x uint8)"] = 1e3 * timeit(
            "viz D2H pull (3x uint8)", lambda: [x.cpu().numpy() for x in u8], device)

    # the save path: a detached copy of the parameters and the Adam state,
    # then its pull to the host (write_snapshot's input)
    optimizer = create_optimizer(cfg, params)
    ck.restore(state, params, optimizer)
    snap = ck.snapshot(params, optimizer)
    tensors = list(snap[0].values()) + [
        v for st in (snap[1] or {}).values() for v in st.values() if torch.is_tensor(v)]
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    print(f"{'ckpt snapshot bytes':28s} {nbytes / 1e6:9.3f} MB")
    ms["ckpt snapshot (device copy)"] = 1e3 * timeit(
        "ckpt snapshot (device copy)", lambda: ck.snapshot(params, optimizer), device)
    ms["ckpt D2H pull"] = 1e3 * timeit(
        "ckpt D2H pull", lambda: [t.cpu().numpy() for t in tensors], device)
    return ms, nbytes


if __name__ == "__main__":
    main()
