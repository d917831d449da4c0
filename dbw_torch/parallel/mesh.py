"""The device mesh over torch.distributed (PyTorch port of
dbw_tpu/parallel/mesh.py): one process per rank, started by torchrun.

A run of N ranks is the JAX package's mesh of N devices. Rank r sits at
``np.unravel_index(r, shape)``, JAX's row-major ``reshape`` of the device
list, with the last axis innermost: ``(seed, data[, sp])`` for the
multi-seed protocol, ``(scene, seed, data)`` for the multi-scene trainer.
What JAX's ``shard_map`` does with collectives over named axes, a ``Mesh``
does with the process groups of those axes:

- ``reduce``: the ranks that hold the same slots (every axis but ``seed``
  and ``scene``), over which gradients and losses are averaged (JAX's
  ``pmean`` over ``("data", "sp")``);
- ``sp``: the ranks that render the bands of the same views, over which
  the band images are gathered;
- ``gather``: the ranks that hold the other slots (the ``seed`` and
  ``scene`` axes at this rank's ``data`` and ``sp``), over which per-slot
  values are gathered for selection, bookkeeping and checkpoints.

Only ``all_reduce``, ``all_gather`` and ``broadcast`` are used: gloo has
no ``reduce_scatter`` for CUDA tensors. A mesh of one rank has no groups,
and its collectives do nothing.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.distributed as dist

from ..utils.device import DEFAULT_DEVICE, resolve_device
from ..utils.logger import print_log


def factor_devices(n, n_seeds=None):
    """Factor n devices into (seed, data) axes, preferring the seed axis:
    seeds are independent optimizations with no traffic between them, while
    the data axis pays a gradient all-reduce every step.

    Without a requested seed count, all devices go on the seed axis. With
    ``n_seeds``, the seed axis is the smallest divisor of n that fits all
    seeds (the leftover slots hold duplicate seeds, masked out of
    selection: ``seeds.pad_seeds``), and the remaining factor becomes the
    data axis."""
    if n_seeds is None:
        return n, 1
    for seed_ax in sorted(d for d in range(1, n + 1) if n % d == 0):
        if seed_ax >= n_seeds:
            return seed_ax, n // seed_ax
    return n, 1  # more seeds than devices: caller batches seeds per slot


@dataclass
class Axis:
    """A process group over some mesh axes: its ranks, in rank order, and
    this rank's index among them. ``group`` is None for a group of one."""

    ranks: list
    index: int
    group: object = None

    @property
    def size(self):
        return len(self.ranks)


@dataclass
class Mesh:
    """A mesh of ``world_size`` ranks: axis names, their sizes, this rank's
    coordinates, and the process groups of its collectives (``reduce``,
    ``sp``, ``gather``; module docstring)."""

    axis_names: tuple
    shape: dict
    rank: int = 0
    coords: dict = field(default_factory=dict)
    groups: dict = field(default_factory=dict)

    @property
    def world_size(self):
        return int(np.prod(list(self.shape.values())))

    def axis(self, name):
        if name not in self.groups:
            raise RuntimeError(f"a mesh of {self.world_size} ranks outside a process group "
                               "of that size is a layout only: it has no collectives")
        return self.groups[name]

    def data_slice(self, batch_size):
        """This rank's contiguous view shard of a batch (JAX ``P("data")``)."""
        n = self.shape["data"]
        if batch_size % n:
            raise ValueError(f"batch_size={batch_size} is not divisible by n_data={n}")
        b = batch_size // n
        d = self.coords["data"]
        return slice(d * b, (d + 1) * b)

    def slot_slice(self, n_slots):
        """This rank's slots of ``n_slots`` stacked slots (JAX ``P("seed")``)."""
        n = self.shape["seed"]
        if n_slots % n:
            raise ValueError(f"{n_slots} slots do not divide over a seed axis of {n}")
        s = n_slots // n
        k = self.coords["seed"]
        return slice(k * s, (k + 1) * s)

    def mean(self, tensors, over="reduce"):
        """Average ``tensors`` in place over an axis group: one all_reduce of
        their concatenation (JAX's ``pmean``)."""
        ax = self.axis(over)
        if ax.size == 1:
            return tensors
        flat = torch.cat([t.reshape(-1) for t in tensors])
        dist.all_reduce(flat, group=ax.group)
        flat /= ax.size
        i = 0
        for t in tensors:
            t.copy_(flat[i:i + t.numel()].view_as(t))
            i += t.numel()
        return tensors

    def gather(self, t, over="gather"):
        """``t`` of every rank of an axis group, concatenated on the first
        axis in rank order."""
        ax = self.axis(over)
        if ax.size == 1:
            return t
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(ax.size)]
        dist.all_gather(parts, t, group=ax.group)
        return torch.cat(parts)


def world():
    """(rank, world size) of the default process group; (0, 1) without
    one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _groups(shape, rank, axes_of):
    """{name: Axis} of the groups that vary along the axes ``axes_of[name]``
    (indices into ``shape``). Every rank creates every group, in one order,
    as ``dist.new_group`` requires; groups of one rank are not created."""
    ranks = np.arange(int(np.prod(shape))).reshape(shape)
    out = {}
    for name, vary in axes_of.items():
        keep = [i for i in range(len(shape)) if i not in vary]
        parts = ranks.transpose(keep + list(vary)).reshape(-1, int(np.prod(
            [shape[i] for i in vary], dtype=np.int64)))
        for part in parts.tolist():
            g = dist.new_group(part) if len(part) > 1 else None
            if rank in part:
                out[name] = Axis(part, part.index(rank), g)
    return out


def _mesh(names, shape, world_size, rank, axes_of):
    if rank is None:
        rank = world()[0] if world_size > 1 else 0
    coords = dict(zip(names, (int(c) for c in np.unravel_index(rank, shape))))
    mesh = Mesh(tuple(names), dict(zip(names, shape)), rank, coords)
    if world_size > 1:
        if world() != (rank, world_size):
            # a layout only (no process group of this size): no collectives
            mesh.groups = {}
            return mesh
        mesh.groups = _groups(shape, rank, axes_of)
    else:
        mesh.groups = {name: Axis([0], 0) for name in axes_of}
    return mesh


def make_mesh(n_seed=None, n_data=None, world_size=None, n_seeds=None, n_spatial=1,
              rank=None):
    """(seed, data[, sp]) mesh of ``world_size`` ranks (default: the process
    group's). ``n_spatial`` > 1 adds the pixel-band axis (each sp rank
    renders H/n_spatial image rows) as the innermost axis. A missing axis
    is derived from the given one, as JAX's ``make_mesh`` does. Outside a
    process group of ``world_size`` ranks the mesh is a layout only (its
    shape and ``rank``'s coordinates), with no groups."""
    n = world()[1] if world_size is None else int(world_size)
    world_n = n
    if n_spatial > 1:
        if n % n_spatial:
            raise ValueError(f"n_spatial={n_spatial} does not divide {n} devices")
        n = n // n_spatial
    if n_seed is None and n_data is None:
        n_seed, n_data = factor_devices(n, n_seeds=n_seeds)
    elif n_seed is None:  # one axis given: derive the other, don't discard
        if n % n_data:
            raise ValueError(f"n_data={n_data} does not divide {n} devices")
        n_seed = n // n_data
    elif n_data is None:
        if n % n_seed:
            raise ValueError(f"n_seed={n_seed} does not divide {n} devices")
        n_data = n // n_seed
    if n_seed * n_data != n:
        raise ValueError(f"a ({n_seed}, {n_data}) mesh is not {n} devices")
    if n_spatial > 1:
        return _mesh(("seed", "data", "sp"), (n_seed, n_data, n_spatial), world_n, rank,
                     {"reduce": (1, 2), "sp": (2,), "gather": (0,)})
    return _mesh(("seed", "data"), (n_seed, n_data), world_n, rank,
                 {"reduce": (1,), "gather": (0,)})


def init_distributed(device=DEFAULT_DEVICE, cards=None, init_method="env://", rank=None,
                     world_size=None):
    """Join the process group of a run of several ranks, one process per
    rank, and return this rank's device. The rank and world size come from
    torchrun's ``RANK`` and ``WORLD_SIZE`` unless given; the card is
    ``cuda:LOCAL_RANK``, or ``LOCAL_RANK`` modulo ``cards`` (default: the
    cards present) when the ranks outnumber the cards. A world of one
    rank joins nothing: the device as resolved.

    The backend follows from the layout: NCCL when every rank owns its
    card, gloo on the CPU and when ranks share a card (NCCL refuses two
    ranks on one device)."""
    rank = int(os.environ.get("RANK", 0)) if rank is None else int(rank)
    world_size = (int(os.environ.get("WORLD_SIZE", 1)) if world_size is None
                  else int(world_size))
    device = resolve_device(device)
    if world_size == 1:
        return device
    backend = "gloo"
    if device.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank))
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
        cards = torch.cuda.device_count() if cards is None else int(cards)
        device = torch.device("cuda", local % cards)
        torch.cuda.set_device(device)
        if local_world <= cards:
            backend = "nccl"
    print_log(f"[mesh] rank {rank} of {world_size} on {device}, backend {backend}")
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size,
                            device_id=device if backend == "nccl" else None)
    return device


def close_distributed():
    """Leave the process group, if this process joined one."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
