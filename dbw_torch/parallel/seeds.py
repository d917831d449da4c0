"""The seed axis (PyTorch port of dbw_tpu/parallel/seeds.py): S
optimizations of one model config keep every parameter as one stacked leaf
(S, ...) under one torch Adam, which is S Adams: its update is elementwise
and the slots share its step count.

``train_step`` is the optimizer step of every trainer of the port: the
Trainer's one set of leaves, the protocol's S stacked slots and the
multi-scene trainer's (n_scene, S) slots, on one card or one rank of a
mesh. Its forward and backward (``seed_backward``) run stacked slots as
the JAX package's executor does, by ``DBW_SEED_EXEC`` (``one_by_one``):
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
come from its own generator (``BlocksWorld.step_draws``) before the
forward, so both executors see the same draws.

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


def one_by_one(n):
    """Whether the executor, ``DBW_SEED_EXEC`` (``vmap``, ``map`` or
    ``auto``, the default), runs ``n`` slots one after the other: under
    ``map``, and under ``auto`` for one slot (JAX's direct call); else
    (``vmap``, ``auto`` for several) one batched call. The port has no
    compact pipeline, JAX's reason for ``map`` under ``auto``."""
    mode = os.environ.get("DBW_SEED_EXEC", "auto").lower()
    return mode == "map" or (mode != "vmap" and n == 1)


def seed_axis_exec(fn, *xs):
    """``fn`` over the leading (seed) axis of ``xs`` (dicts of stacked
    tensors, tensors or per-slot lists): one slot after the other
    (``one_by_one``), the results stacked (``_stacked``), the leading axis
    kept; else one call on the stacked ``xs`` (``fn`` takes the leading
    slot axis itself: the model's functions do)."""
    n = n_slots(xs[0])
    if one_by_one(n):
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


def seed_backward(model, params, phase, imgs, R, T, draws, band=None):
    """The forward and ``backward()`` of ``params``, one set or S stacked
    slots, as ``model.forward`` takes them: R and T per view (S * B, ...),
    slot s in views s * B .. s * B + B - 1, imgs per view or the B views
    every slot shares, ``draws`` the step's (``model.step_draws``).
    Stacked slots run by the executor: batched, one forward and one
    ``backward()`` of the (S,) totals' sum, each slot's gradient landing in
    its slot of the stacked leaves; or one slot after the other
    (``one_by_one``). ``band``: the forward's ``row_range`` and
    ``rec_gather`` on the pixel-band axis. -> the detached losses
    {name: (S,) or scalar}."""
    lead = model.slot_shape(params)
    if lead and one_by_one(lead[0]):
        S, B = lead[0], len(R) // lead[0]
        view = lambda x, s: x[s * B:(s + 1) * B] if len(x) == len(R) else x
        return _stacked([seed_backward(model, slot(params, s), phase, view(imgs, s),
                                       view(R, s), view(T, s), slot(draws, s), band)
                         for s in range(S)])
    losses = model.forward(params, phase, imgs, R, T, **draws, **(band or {}))
    with profiling.span("dbw.loss.other"):
        total = profiling.mark(losses["total"].sum(), "dbw.loss.other")
    with profiling.span("dbw.backward"):
        total.backward()
    return {k: v.detach() for k, v in losses.items()}


def train_step(model, optimizer, params, phase, views, generators=None, draws=None,
               mesh=None, band=None, cameras=None):
    """One optimizer step of ``params`` under ``optimizer``: the Trainer's
    leaves, S stacked slots, or with ``cameras`` (one ``camera_state`` a
    scene) (n_scene, S) stacked slots.

    1. the gradients zeroed;
    2. the step's draws from ``generators`` (``model.step_draws``), unless
       ``draws`` gives them;
    3. the forward and backward: ``seed_backward`` on ``views``, the
       (imgs, R, T) of the B views every slot shares; with ``cameras``,
       ``scenes.scene_backward`` on ``views``, one (imgs, R, T) a scene;
    4. the leaf ``dbw.optimizer``: a leaf the losses do not reach
       (alpha_logit in the fine phase) takes a zero gradient, so that Adam
       still advances its moments, as optax does; on a ``mesh``, the
       gradients and the totals averaged over its reduction axis (one
       all_reduce); the optimizer step.

    -> the detached losses, {name: tensor of the slot shape}."""
    optimizer.zero_grad(set_to_none=True)
    lead = model.slot_shape(params)
    with profiling.span("dbw.build"):
        if draws is None:
            draws = model.step_draws(params, generators)
        if cameras is None and lead:
            imgs, R, T = views
            views = imgs, R.repeat(lead[0], 1, 1), T.repeat(lead[0], 1)
    if cameras is None:
        losses = seed_backward(model, params, phase, *views, draws, band)
    else:
        from .scenes import scene_backward  # scenes.py imports this module

        losses = scene_backward(model, params, phase, views, cameras, draws)
    with profiling.span("dbw.optimizer"):
        for p in params.values():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if mesh is not None:
            mesh.mean([p.grad for p in params.values()] + [losses["total"]])
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
        """One Adam step of this rank's slots on its views (``train_step``).
        Returns the slots' (S_local,) total losses, averaged over the seed
        column (the span ``dbw.step``)."""
        with profiling.step():
            return train_step(self.model, self.optimizer, params, phase, (imgs, R, T),
                              generators, draws, self.mesh, self.band)["total"]

    def select_best(self, params, losses, n_valid=None):
        """Selection by the lowest train loss over every seed column's slots:
        the slots and losses gathered first. -> (params of the best slot,
        its index among all slots)."""
        full = {k: self.mesh.gather(v.detach()) for k, v in params.items()}
        return select_best_seed(full, self.mesh.gather(losses).cpu().numpy(), n_valid)
