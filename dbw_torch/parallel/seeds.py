"""The seed axis (PyTorch port of dbw_tpu/parallel/seeds.py): S
optimizations of one model config keep every parameter as one stacked leaf
(S, ...) under one torch Adam, which is S Adams: its update is elementwise
and the slots share its step count.

``seed_axis_exec`` runs a step's slots as the JAX package's executor does,
by ``DBW_SEED_EXEC``:
- ``vmap``: one batched call on the stacked values. The model takes the
  leading slot axis itself (``models/dbw.py``): one forward renders the S
  slots' S * B views with one launch of each kernel and gives the (S,)
  losses; one ``backward()`` of their sum gives each slot exactly its own
  gradient, since slot s's loss reads only slot s's leaves;
- ``map``: the slots one after the other, slot s seeing ``{k: v[s]}``
  (the sequential executor the batched one is held against);
- ``auto`` (the default): JAX's rule, a direct call for one local slot,
  ``map`` where a compact pipeline is live, ``vmap`` otherwise. The port
  has no compact pipeline, so ``auto`` is ``vmap`` on the card and on the
  CPU. (JAX's guard against ``vmap`` with its Pallas texel kernel is for
  a Mosaic lowering limit the card does not have.)
Each slot's random draws (opacity noise (N,), overlap points (N, 1000, 3))
come from its own generator in either mode, so both see the same draws.

Across ranks, ``MultiSeedRunner`` is JAX's (seed, data[, sp]) sharded step
on a ``mesh.Mesh``: each rank holds its seed column's slots, renders its
view shard (and, on the ``sp`` axis, its row band, the band images
gathered by ``band_gather``), averages the gradients and losses over its
column, and steps its own Adam.

Left out: the scanned multi-step and the device-resident dataset (TPU
machinery)."""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from ..models.dbw import OVERLAP_N_POINTS
from ..utils import profiling


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


def seed_exec_mode():
    """``DBW_SEED_EXEC``: ``vmap``, ``map`` or ``auto`` (the default)."""
    return os.environ.get("DBW_SEED_EXEC", "auto").lower()


def _stacked(outs):
    """Per-slot results stacked leaf by leaf (tensors, and dicts and tuples
    of them); anything else listed."""
    o = outs[0]
    if torch.is_tensor(o):
        return torch.stack(outs)
    if isinstance(o, dict):
        return {k: _stacked([x[k] for x in outs]) for k in o}
    if isinstance(o, tuple):
        return tuple(_stacked(list(x)) for x in zip(*outs))
    return outs


def seed_axis_exec(fn, *xs):
    """``fn`` over the leading (seed) axis of ``xs`` (dicts of stacked
    tensors, tensors or per-slot lists), by ``seed_exec_mode()``: ``map``
    calls it on each slot and stacks the results (``_stacked``);
    ``vmap`` calls it once on the stacked ``xs`` (``fn`` takes the leading
    slot axis itself: the model's functions do); ``auto`` calls it on the
    slot of a one-slot axis and keeps the leading axis, else is ``vmap``
    (the port has no compact pipeline, JAX's reason for ``map``)."""
    n = n_slots(xs[0])
    mode = seed_exec_mode()
    if mode not in ("vmap", "map"):  # auto
        if n == 1:
            return _stacked([fn(*(slot(x, 0) for x in xs))])
        mode = "vmap"
    if mode == "map":
        return _stacked([fn(*(slot(x, s) for x in xs)) for s in range(n)])
    return fn(*xs)


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


def slot_draws(model, generator, draws=None):
    """One slot's random draws as its forward makes them, in its order:
    the opacity noise (N,), then, with an overlap loss, the overlap points
    (N, 1000, 3), from ``generator``; those in ``draws`` are taken as
    given."""
    out = dict(draws or {})
    N, dev = model.n_blocks, model.device
    if out.get("opacity_noise") is None:
        out["opacity_noise"] = torch.randn((N,), generator=generator, device=dev)
    if "overlap" in model.loss_weights and out.get("overlap_u") is None:
        out["overlap_u"] = torch.rand((N, OVERLAP_N_POINTS, 3), generator=generator,
                                      device=dev)
    return out


def stack_draws(model, generators, draws):
    """Every slot's ``slot_draws``, stacked: {name: (S, ...)}."""
    per = [slot_draws(model, g, d) for g, d in zip(generators, draws)]
    return {k: torch.stack([d[k] for d in per]) for k in per[0]}


def batched_backward(model, params, phase, imgs, R, T, draws, band=None):
    """The batched step's forward and backward: S stacked slots, R (S * B,
    3, 3) and T (S * B, 3) per view (slot s in views s * B .. s * B + B -
    1), imgs per view or the B views every slot shares, ``draws`` stacked
    (``stack_draws``). One forward, one ``backward()`` of the (S,) totals'
    sum: each slot's gradient lands in its slot of the stacked leaves.
    Returns the detached (S,) totals."""
    losses = model.forward(params, phase, imgs, R, T, **draws, **(band or {}))
    with profiling.span("dbw.loss.other"):
        total = profiling.mark(losses["total"].sum(), "dbw.loss.other")
    with profiling.span("dbw.backward"):
        total.backward()
    return losses["total"].detach()


def slot_backward(model, params, phase, imgs, R, T, generator=None, draws=None,
                  band=None):
    """One slot's forward and backward: its gradients accumulate into the
    stacked leaves' ``grad`` at its slot. ``draws``: the forward's random
    draws (``opacity_noise``, ``overlap_u``) when given, else they come
    from ``generator``. ``band``: the forward's ``row_range`` and
    ``rec_gather`` on the pixel-band axis. Returns the slot's detached
    total loss. Stacked ``params`` (S, ...) with per-slot lists of
    generators and draws run the S slots batched on the same views
    (``batched_backward``) and return the (S,) totals."""
    lead = model.slot_shape(params)
    if lead:
        S = lead[0]
        with profiling.span("dbw.build"):
            R, T = R.repeat(S, 1, 1), T.repeat(S, 1)
            draws = stack_draws(model, generator, draws)
        return batched_backward(model, params, phase, imgs, R, T, draws, band)
    losses = model.forward(params, phase, imgs, R, T, generator=generator,
                           **(draws or {}), **(band or {}))
    with profiling.span("dbw.backward"):
        losses["total"].backward()
    return losses["total"].detach()


def adam_step(optimizer, params):
    """The optimizer step over the leaves (stacked, or the Trainer's). A
    leaf the step's losses do not reach (alpha_logit in the fine phase)
    takes a zero gradient, so that Adam still advances its moments, as
    optax does, instead of skipping it. The leaf ``dbw.optimizer``."""
    with profiling.span("dbw.optimizer"):
        _zero_fill(params)
        optimizer.step()


def _zero_fill(params):
    for p in params.values():
        if p.grad is None:
            p.grad = torch.zeros_like(p)


def seed_backward(model, params, phase, imgs, R, T, generators=None, draws=None,
                  band=None):
    """Every seed slot's forward and backward on the same views, through
    ``seed_axis_exec`` (batched, or one slot after the other); the
    gradients accumulate into the stacked leaves. Returns the (S,) total
    losses, on the device."""
    S = n_slots(params)
    return seed_axis_exec(
        lambda p, g, d: slot_backward(model, p, phase, imgs, R, T, g, d, band),
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


def mean_and_step(mesh, optimizer, params, losses):
    """The gradients in ``params`` and the ``losses`` averaged over the
    mesh's seed column (one all_reduce), then the optimizer step (the leaf
    ``dbw.optimizer``). -> ``losses``, averaged."""
    with profiling.span("dbw.optimizer"):
        _zero_fill(params)  # the zero gradient adam_step would give it
        mesh.mean([p.grad for p in params.values()] + [losses])
        optimizer.step()
    return losses


class _BandGather(torch.autograd.Function):
    """The band images of every rank of the ``sp`` axis, tiled on the row
    axis and cropped to H (JAX's tiled ``all_gather`` on axis 1). The
    backward is its transpose: the full-image cotangents summed over the
    axis (an all_reduce), of which each rank keeps its own rows."""

    @staticmethod
    def forward(ctx, band, axis, H):
        ctx.axis, ctx.H, ctx.Hb = axis, H, band.shape[1]
        parts = [torch.empty_like(band) for _ in range(axis.size)]
        dist.all_gather(parts, band.contiguous(), group=axis.group)
        return torch.cat(parts, dim=1)[:, :H]

    @staticmethod
    def backward(ctx, g):
        axis, Hb = ctx.axis, ctx.Hb
        full = g.new_zeros((g.shape[0], axis.size * Hb) + tuple(g.shape[2:]))
        full[:, :ctx.H] = g
        dist.all_reduce(full, group=axis.group)
        k = axis.index
        return full[:, k * Hb:(k + 1) * Hb].contiguous(), None, None


def band_gather(band, axis, H):
    """(B, Hb, W, C) band of this rank -> the (B, H, W, C) image of the
    bands of ``axis`` (a ``mesh.Axis``), differentiable."""
    return _BandGather.apply(band, axis, H)


class MultiSeedRunner:
    """One rank's step of the (seed, data[, sp]) sharded protocol (JAX
    ``MultiSeedRunner.step``).

    ``params`` are this rank's slots (``mesh.slot_slice``) as stacked leaves
    under ``optimizer``; the views are this rank's shard
    (``mesh.data_slice``). On the ``sp`` axis the rank renders the rows
    ``(k * Hb, Hb)``, Hb = ceil(H / n_sp), and the losses see the gathered
    image. Gradients and losses are averaged over the seed column, then
    Adam steps locally."""

    def __init__(self, model, optimizer, mesh):
        self.model = model
        self.optimizer = optimizer
        self.mesh = mesh
        n_sp = mesh.shape.get("sp", 1)
        self.band = None
        if n_sp > 1:
            H = model.img_size[0]
            Hb = -(-H // n_sp)  # the last band may overhang H
            axis = mesh.axis("sp")
            self.band = {"row_range": (axis.index * Hb, Hb),
                         "rec_gather": lambda rec: band_gather(rec, axis, H)}

    def step(self, params, phase, imgs, R, T, generators=None, draws=None):
        """One Adam step of this rank's slots on its views. Returns the
        slots' (S_local,) total losses, averaged over the seed column (the
        span ``dbw.step``)."""
        with profiling.step():
            self.optimizer.zero_grad(set_to_none=True)
            losses = seed_backward(self.model, params, phase, imgs, R, T, generators, draws,
                                   self.band)
            return mean_and_step(self.mesh, self.optimizer, params, losses)

    def select_best(self, params, losses, n_valid=None):
        """Selection by the lowest train loss over every seed column's slots:
        the slots and losses gathered first. -> (params of the best slot,
        its index among all slots)."""
        full = {k: self.mesh.gather(v.detach()) for k, v in params.items()}
        return select_best_seed(full, self.mesh.gather(losses).cpu().numpy(), n_valid)
