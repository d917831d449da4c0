"""Benchmark: the DTU-shaped optimization step's throughput on one card.

    python -m dbw_torch.bench [--steps N] [--blocks 10|50] [--no-perceptual]
                              [--img-size H W] [--cpu]

The port's twin of the JAX repo's ``bench.py`` and of its flagship forward
``__graft_entry__.entry``. The workload is the reference's derived
throughput row (BASELINE.md): 300x400 renders, a batch of 4 views, 10
blocks (up to 50, the width of configs/bmvs/gundam_50.yml) with the env
pass, K=10 faces a pixel, the full loss stack, forward, backward and Adam
with a texture group. It runs on the card unless ``--cpu`` asks for the
CPU, and prints ONE JSON line with bench.py's keys (``metric``, ``value``,
``unit``, ``vs_baseline``, ``extra``); ``extra`` adds the kernels'
launches per step (``dbw_torch.kernels.LAUNCHES``) and the peak device
memory.

Timing is bench.py's: every call of ``--steps-per-call`` steps is timed on
its own, warm-up calls go on until two in a row agree within 10% (at most
``--max-warmup-calls`` calls and ``--max-warmup-s`` seconds;
``warmup_stable`` says whether they did), then ``value`` is steps per
second of the median of ``max(steps // steps_per_call, 4)`` timed calls.

Where it differs from bench.py, and why:
- bench.py runs a call's steps in one device program (``lax.scan``). Here
  they run one after the other in a Python loop, with one
  ``torch.cuda.synchronize()`` a call. Each step's random draws come from
  a generator seeded by (0, the step counter), as the Trainer seeds its
  steps; bench.py folds the counter into a key.
- bench.py's ``--backend xla|pallas`` picks a TPU route. The port has one
  route, its hand-written kernels; running their plain PyTorch twins on
  the card would be a fallback, which the port does not have. So there is
  no such flag.
- There is no executable or compile cache: the first call builds the
  kernels (``dbw_torch/kernels.py``, one ``nvcc`` per source) unless a
  build for these sources exists, and that time is in ``cold_start_s``.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from . import kernels
from .models.dbw import BlocksWorld
from .ops.rotations import look_at_rotation
from .train.optimizer import create_optimizer
from .train.trainer import step_seed
from .utils.device import DEFAULT_DEVICE, resolve_device

REFERENCE_STEPS_PER_SEC = 1.0 / 0.65  # BASELINE.md derived: ~0.65 s/step
N_VIEWS = 4
OPTIMIZER_CFG = {"training": {"optimizer": {"name": "adam", "lr": 5e-3,
                                            "texture": {"lr": 5e-2}}}}
# DTU-like NDC intrinsics
K_NDC = np.zeros((4, 4), np.float32)
K_NDC[0, 0], K_NDC[1, 1] = 2.8, 2.1
K_NDC[0, 2] = K_NDC[1, 2] = 0.02
K_NDC[2, 3] = K_NDC[3, 2] = 1.0


def make_model(img_size=(300, 400), n_blocks=10, txt_size=256, fpp=10,
               with_perceptual=True, device=DEFAULT_DEVICE):
    """The flagship bench model, as ``__graft_entry__._make_model`` builds it."""
    loss = dict(rgb_weight=1, parsimony_weight=0.01, tv_weight=0.1,
                overlap_weight=1)
    if with_perceptual:
        loss["perceptual_weight"] = 0.1
    model = BlocksWorld(
        tuple(img_size),
        mesh=dict(n_blocks=n_blocks, S_world=0.5, R_world=[115, 0, 0],
                  txt_size=txt_size),
        renderer=dict(faces_per_pixel=fpp, detach_bary=True, z_clip=0.001),
        rend_optim=dict(coarse_learning=1500, decimate_txt=750,
                        kill_blocks=True, decouple_rendering=True,
                        opacity_noise=True),
        loss=loss, device=device,
    )
    model.set_camera(K_NDC)
    return model


def cams(b, device=DEFAULT_DEVICE):
    """(R, T) of ``b`` views on an arc, as ``__graft_entry__._cams``."""
    R, T = look_at_rotation(3.0, 25.0, torch.linspace(-40.0, 40.0, b))
    return R.to(device), T.to(device)


def entry(device=DEFAULT_DEVICE, img_size=(300, 400), **model_kw):
    """(fn, example_args): the forward (render + losses) of the flagship
    model; ``fn(*example_args)`` returns ``losses["total"]`` on ``device``.
    ``model_kw`` go to ``make_model``."""
    model = make_model(img_size, device=device, **model_kw)
    params = model.init_params(seed=0)
    phase = model.phase_for_epoch(0, training=True)
    R, T = cams(N_VIEWS, model.device)
    imgs = torch.full((N_VIEWS, *img_size, 3), 0.5, device=model.device)
    gen = torch.Generator(device=model.device).manual_seed(0)

    def fn(params, imgs, R, T, gen):
        return model.forward(params, phase, imgs, R, T, generator=gen)["total"]

    return fn, (params, imgs, R, T, gen)


class BenchStep:
    """bench.py's workload on ``model`` (a ``make_model`` model): its
    init_params(seed=0), Adam at 5e-3 with the texture group at 5e-2, the
    curriculum's phase 0, ``batch`` views of images from
    ``np.random.default_rng(0)``."""

    def __init__(self, model, batch=N_VIEWS):
        self.model = model
        self.device = model.device
        self.params = model.init_params(seed=0)
        self.optimizer = create_optimizer(OPTIMIZER_CFG, self.params)
        self.phase = model.phase_for_epoch(0, training=True)
        self.R, self.T = cams(batch, self.device)
        rng = np.random.default_rng(0)
        self.imgs = torch.from_numpy(
            rng.random((batch, *model.img_size, 3), np.float32)).to(self.device)
        self.ctr = 0

    def step(self, **forward_kw):
        """One forward, backward and Adam step. ``forward_kw`` go to
        ``model.forward``: draws that replace the generator's
        (``opacity_noise``, ``overlap_u``), a ``row_range``. Returns the
        losses."""
        gen = torch.Generator(device=self.device).manual_seed(step_seed(0, self.ctr))
        self.ctr += 1
        self.optimizer.zero_grad(set_to_none=True)
        losses = self.model.forward(self.params, self.phase, self.imgs, self.R, self.T,
                                    generator=gen, **forward_kw)
        losses["total"].backward()
        self.optimizer.step()
        return losses


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, default=40)
    parser.add_argument("--max-warmup-calls", type=int, default=40,
                        help="cap on stability-seeking warmup calls")
    parser.add_argument("--max-warmup-s", type=float, default=900.0,
                        help="wall-clock cap on the warmup phase")
    parser.add_argument("--steps-per-call", type=int, default=5,
                        help="optimizer steps per timed call (one device "
                        "synchronize a call)")
    parser.add_argument("--no-perceptual", action="store_true")
    parser.add_argument("--blocks", type=int, default=10,
                        help="number of superquadric blocks (reference max 50)")
    parser.add_argument("--img-size", type=int, nargs=2, default=(300, 400),
                        metavar=("H", "W"),
                        help="render size (default: the baseline 300x400; "
                        "smaller sizes are for CPU smokes, not benching)")
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU (default: the CUDA card)")
    args = parser.parse_args(argv)

    device = resolve_device("cpu" if args.cpu else DEFAULT_DEVICE)
    cuda = device.type == "cuda"
    if cuda:
        # TF32 off, the parity setting of the port's checks
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    H, W = args.img_size
    bench = BenchStep(make_model((H, W), args.blocks,
                                 with_perceptual=not args.no_perceptual, device=device))
    SPC = max(args.steps_per_call, 1)

    def timed_call():
        t0 = time.perf_counter()
        for _ in range(SPC):
            loss = bench.step()["total"].detach()
        if cuda:
            torch.cuda.synchronize()
        return time.perf_counter() - t0, loss

    # warm up until two calls in a row agree within 10%, under both caps
    warmup_times = []
    warmup_t0 = time.perf_counter()
    warmup_stable = False
    while len(warmup_times) < args.max_warmup_calls:
        dt, loss = timed_call()
        warmup_times.append(dt)
        if len(warmup_times) >= 2:
            a, b = warmup_times[-2], warmup_times[-1]
            if abs(a - b) <= 0.10 * min(a, b):
                warmup_stable = True
                break
        if time.perf_counter() - warmup_t0 > args.max_warmup_s:
            break
    cold_start_s = time.perf_counter() - warmup_t0

    # the timed calls: the median of the per-call times
    n_calls = max(args.steps // SPC, 4)
    kernels.reset_launches()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    call_times = []
    for _ in range(n_calls):
        dt, loss = timed_call()
        call_times.append(dt)
    n_steps = n_calls * SPC
    launches = {k: v / n_steps for k, v in kernels.LAUNCHES.items()}

    median_call = float(np.median(call_times))
    steps_per_sec = SPC / median_call
    # rendered Mpix/s fwd+bwd: soft blocks pass + hard env pass per view
    mpix = N_VIEWS * H * W * 2 * steps_per_sec / 1e6
    print(json.dumps({
        "metric": (f"optim steps/sec (DTU-shaped: {N_VIEWS}x{H}x{W}, "
                   f"{args.blocks} blocks, K=10, fwd+bwd+adam)"),
        "value": round(steps_per_sec, 4),
        "unit": "steps/s",
        # the derived reference figure is for the 10-block 300x400
        # workload; other shapes have no published baseline
        "vs_baseline": (round(steps_per_sec / REFERENCE_STEPS_PER_SEC, 4)
                        if args.blocks == 10 and (H, W) == (300, 400) else None),
        "extra": {
            "backend": device.type,
            "device": torch.cuda.get_device_name(device) if cuda else "cpu",
            "rendered_mpix_per_sec": round(mpix, 2),
            "final_loss": float(loss),
            "warmup_calls": len(warmup_times),
            "warmup_stable": warmup_stable,
            "cold_start_s": round(cold_start_s, 2),
            "timed_calls": n_calls,
            "steps_per_call": SPC,
            "call_s_median": round(median_call, 4),
            "call_s_min": round(float(np.min(call_times)), 4),
            "call_s_max": round(float(np.max(call_times)), 4),
            "launches_per_step": launches,
            "peak_memory_gib": (torch.cuda.max_memory_allocated(device) / 2**30
                                if cuda else None),
        },
    }), flush=True)


if __name__ == "__main__":
    main()
