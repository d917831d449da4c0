"""The seed axis on one card (PyTorch port of dbw_tpu/parallel/seeds.py in
its ``map`` mode): S optimizations of one model config keep every parameter
as one stacked leaf (S, ...), and each step runs the slots one after the
other, slot s seeing ``{k: v[s]}``. One torch Adam over the stacked leaves
is S Adams: its update is elementwise and the slots share its step count.

Left out: ``MultiSeedRunner`` (shard_map over a device mesh; ROADMAP.md
queue 1, item 7), and the ``DBW_SEED_EXEC`` knob with its vmap guard."""

from __future__ import annotations

import numpy as np
import torch


def slot(x, s):
    """Slot s of a stacked value: a dict of stacked leaves, a tensor or a
    per-slot list."""
    if isinstance(x, dict):
        return {k: v[s] for k, v in x.items()}
    return x[s]


def n_slots(x):
    if isinstance(x, dict):
        return len(next(iter(x.values())))
    return len(x)


def seed_axis_exec(fn, *xs):
    """``fn`` over the leading (seed) axis of ``xs``, one slot after the
    other; the per-slot results stacked (tensors) or listed."""
    outs = [fn(*(slot(x, s) for x in xs)) for s in range(n_slots(xs[0]))]
    return torch.stack(outs) if torch.is_tensor(outs[0]) else outs


def stack_params(params_list):
    """Per-seed dicts of tensors -> one dict with a leading seed axis."""
    return {k: torch.stack([p[k] for p in params_list]) for k in params_list[0]}


def stacked_leaves(params_list):
    """Per-seed parameter dicts -> stacked leaf tensors that require grad."""
    with torch.no_grad():
        return {k: v.detach().requires_grad_(True)
                for k, v in stack_params(params_list).items()}


def unstack_params(stacked, i):
    return slot(stacked, i)


def pad_seeds(seeds, n_slots):
    """Pad a seed list to ``n_slots`` by repeating seeds cyclically; the
    padded slots are left out of selection by ``n_valid``. Returns
    (padded_seeds, n_valid)."""
    seeds = list(seeds)
    n_valid = len(seeds)
    assert n_slots >= n_valid, (n_slots, n_valid)
    padded = seeds + [seeds[i % n_valid] for i in range(n_slots - n_valid)]
    return padded, n_valid


def select_best_seed(stacked_params, losses, n_valid=None):
    """Selection by the lowest train loss (reference README.md:152-157);
    slots at or beyond ``n_valid`` are masked with inf. -> (params of the
    best slot, its index)."""
    losses = np.asarray(losses, np.float64)
    if n_valid is not None:
        losses = np.where(np.arange(len(losses)) >= n_valid, np.inf, losses)
    best = int(np.argmin(losses))
    return unstack_params(stacked_params, best), best


def slot_backward(model, params, phase, imgs, R, T, generator=None, draws=None):
    """One slot's forward and backward: its gradients accumulate into the
    stacked leaves' ``grad`` at its slot. ``draws``: the forward's random
    draws (``opacity_noise``, ``overlap_u``) when given, else they come
    from ``generator``. Returns the slot's detached total loss."""
    losses = model.forward(params, phase, imgs, R, T, generator=generator,
                           **(draws or {}))
    losses["total"].backward()
    return losses["total"].detach()


def adam_step(optimizer, params):
    """The optimizer step over the stacked leaves. A leaf the step's losses
    do not reach (alpha_logit in the fine phase) takes a zero gradient, so
    that Adam still advances its moments, as optax does (the port
    Trainer's rule)."""
    for p in params.values():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    optimizer.step()


def seed_backward(model, params, phase, imgs, R, T, generators=None, draws=None):
    """Every seed slot's forward and backward on the same views, one after
    the other; the gradients accumulate into the stacked leaves. Returns the
    (S,) total losses, on the device."""
    S = n_slots(params)
    return seed_axis_exec(
        lambda p, g, d: slot_backward(model, p, phase, imgs, R, T, g, d),
        params, generators or [None] * S, draws or [None] * S)


def seed_step(model, params, optimizer, phase, imgs, R, T, generators=None,
              draws=None):
    """One Adam step of every seed slot on the same views: ``seed_backward``,
    then one step of ``optimizer`` over the stacked leaves. Returns the (S,)
    total losses, on the device."""
    optimizer.zero_grad(set_to_none=True)
    losses = seed_backward(model, params, phase, imgs, R, T, generators, draws)
    adam_step(optimizer, params)
    return losses
