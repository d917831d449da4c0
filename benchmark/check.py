"""How ``correct`` is decided: the program's first steps against the plain
reference's, from the same inputs.

The program's readings are taken in set-up (``harness.Loop.first_steps``):
each step's total loss, the first step's gradient as Adam holds it (its
first moment over 1 - beta1) and the change of every parameter over the
steps, each slot of a stacked run apart. After the window the reference
(``reference/dbwref``, a frozen plain copy of the step, float32 with TF32
off, the VGG16 features in bfloat16 as the configuration states) follows
the same steps from what it works out itself: the scan's images and
cameras read from the files, the initial parameters and VGG filters from
the seeds, each step's random draws from a generator seeded as the port
seeds its steps, the step's view ids as the traffic handed them to the
program.

Four numbers are compared, each the worst over slots:
- ``loss1``: the relative gap of the first step's total loss (the
  forward alone, before any step of Adam);
- ``loss``: the largest relative gap of a step's total loss;
- ``grad``: the worst leaf's gap between the program's gradient norm and
  the reference's, over the larger of the reference leaf's norm and the
  median leaf's;
- ``change``: the same of the parameters' change over the steps.
Leaves whose reference gradient is under a thousandth of the median
leaf's are left out of ``grad`` and ``change``: Adam moves them by
round-off alone.
"""

from __future__ import annotations

from bisect import bisect_right

import numpy as np
import torch

from . import scan

TEXTURE_PARAM_NAMES = ("texture_bkg", "texture_ground", "textures")
NEGLIGIBLE = 1e-3
NOT_FINITE = 1e300


def step_seed(seed, counter, stream=0):
    """The seed of one step's generator from the training seed and the
    global step counter (the port's rule)."""
    return int(np.random.SeedSequence([int(seed), stream, int(counter)])
               .generate_state(1, np.uint64)[0] >> np.uint64(1))


def epoch_lrs(cfg, epoch):
    """{group: lr} during 0-based ``epoch`` under the config's multi-step
    schedule."""
    t = cfg["training"]
    opt = t.get("optimizer") or {}
    main = float(opt.get("lr", 1e-3))
    lrs = {"main": main, "texture": float((opt.get("texture") or {}).get("lr", main))}
    sch = dict(t.get("scheduler") or {})
    if (sch.get("name") or "multi_step") != "multi_step":
        raise ValueError(f"the reference has no scheduler {sch.get('name')!r}")
    gamma = sch.get("gamma", 0.1)
    gamma = dict(zip(lrs, gamma if isinstance(gamma, list) else [gamma] * 2))
    warm = sch.get("warmup", 0)
    if warm > epoch:
        return {g: lr / warm * (epoch + 1) for g, lr in lrs.items()}
    k = bisect_right(sorted(sch.get("milestones") or []), epoch)
    return {g: lr * gamma[g] ** k for g, lr in lrs.items()}


def reference_model(cfg, config, scan_dir, device):
    """The reference model on the scan's own reading. -> (model, (imgs, R,
    T) of every view on the device)."""
    from .reference.dbwref.models.dbw import BlocksWorld

    img_size = scan.render_size(config)
    imgs, K, R, T = scan.read(config, scan_dir)
    kw = dict(cfg["model"])
    kw.pop("name")
    model = BlocksWorld(img_size, device=device, **kw)
    model.set_camera(K[0])
    views = tuple(torch.from_numpy(a).to(device) for a in (imgs, R, T))
    return model, views


CONTROL = ("tf32", "fp8")


def reference_readings(cfg, config, traffic, scan_dir, seeds, step_ids, device,
                       lowered=(), half_batch=False):
    """The reference's readings of the first steps, one slot (seed) after
    the other. ``lowered``: the configuration's precisions taken one step
    lower, "tf32" (TF32 on for its float32) and "fp8" (float8 e4m3, with a
    per-tensor scale, for the inputs and filters of its bfloat16 VGG16
    convolutions); the control, ``CONTROL``, lowers both. ``half_batch``: a
    fault, each step's losses the mean over the first half of its views."""
    from .harness import leaf_norms, pad_ids

    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = "tf32" in lowered
    try:
        model, (imgs, R, T) = reference_model(cfg, config, scan_dir, device)
        if model.perceptual_loss is not None:
            model.perceptual_loss.vgg.fp8 = "fp8" in lowered
        epoch = int(traffic.get("start_epoch", 1)) - 1
        phase = model.phase_for_epoch(epoch, training=True)
        lrs = epoch_lrs(cfg, epoch)
        ocfg = cfg["training"].get("optimizer") or {}
        betas = tuple(ocfg.get("betas", (0.9, 0.999)))
        eps = float(ocfg.get("eps", 1e-8))
        B = cfg["training"].get("batch_size", 4)
        out = {"losses": [], "grad": [], "change": []}
        for s in seeds:
            params = model.init_params(seed=s)
            p0 = {k: v.detach().clone() for k, v in params.items()}
            opt = torch.optim.Adam(
                [{"params": [v for k, v in params.items() if k not in TEXTURE_PARAM_NAMES],
                  "lr": lrs["main"]},
                 {"params": [v for k, v in params.items() if k in TEXTURE_PARAM_NAMES],
                  "lr": lrs["texture"]}], betas=betas, eps=eps, foreach=False)
            losses, grad = [], None
            for k, ids in enumerate(step_ids):
                idx = torch.from_numpy(pad_ids(ids, B)[0]).to(device)
                if half_batch:
                    idx = idx[:B // 2]
                gen = torch.Generator(device=device).manual_seed(step_seed(s, k))
                opt.zero_grad(set_to_none=True)
                L = model.forward(params, phase, imgs[idx], R[idx], T[idx], generator=gen)
                L["total"].backward()
                for p in params.values():
                    if p.grad is None:
                        p.grad = torch.zeros_like(p)
                if k == 0:
                    grad = leaf_norms({n: p.grad for n, p in params.items()})
                opt.step()
                losses.append(float(L["total"].detach()))
            out["losses"].append(losses)
            out["grad"].append(grad)
            out["change"].append(leaf_norms({n: params[n].detach() - p0[n] for n in params}))
            del params, opt, L
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def leaf_gaps(got, ref, counted):
    """{leaf: |‖got‖ - ‖ref‖| over the larger of ‖ref‖ and the median
    leaf's ‖ref‖} of the counted leaves."""
    med = float(np.median([ref[k] for k in ref]))
    return {k: abs(got[k] - ref[k]) / max(ref[k], med) for k in counted}


def compare(prog, ref, where=None):
    """The compared numbers of two readings (the program's, or the
    control's, against the reference's). ``where``: a dict that receives,
    for each number, the slot, step or leaf that gave it."""
    vals = {"loss1": 0.0, "loss": 0.0, "grad": 0.0, "change": 0.0}
    at = {}

    def worst(name, value, place):
        value = value if np.isfinite(value) else np.inf
        if value > vals[name]:
            vals[name], at[name] = value, place

    for s in range(len(ref["losses"])):
        lr, lp = np.asarray(ref["losses"][s]), np.asarray(prog["losses"][s])
        gaps = np.abs(lp - lr) / np.abs(lr)
        worst("loss1", float(gaps[0]), f"slot {s}")
        worst("loss", float(gaps.max()), f"slot {s} step {int(gaps.argmax()) + 1}")
        g_ref = ref["grad"][s]
        med = float(np.median(list(g_ref.values())))
        counted = [k for k, v in g_ref.items() if v >= NEGLIGIBLE * med]
        for name, got, r in (("grad", prog["grad"][s], g_ref),
                             ("change", prog["change"][s], ref["change"][s])):
            for leaf, v in leaf_gaps(got, r, counted).items():
                worst(name, v, f"slot {s} {leaf}")
    if where is not None:
        where.update(at)
    # a reading that is not a finite number fails every limit, and stays a
    # number that JSON can carry
    return {k: (v if np.isfinite(v) else NOT_FINITE) for k, v in vals.items()}


def judge(numbers, limits):
    """-> (correct, {name: {"value", "limit"}}); a number without a limit
    fails."""
    rows = {k: {"value": numbers[k], "limit": limits.get(k, float("-inf"))}
            for k in numbers}
    return all(r["value"] <= r["limit"] for r in rows.values()), rows
