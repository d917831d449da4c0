"""The benchmark's general runner: a cell's files found by name, the
program's configuration, the spans the harness records around its calls,
the base of the loops and the measured window.

A traffic file (``traffic/<mix>.json``) names its loop, ``entry``: the
class ``Loop`` of ``entries/<entry>.py``, loaded from the file by name, so
that a loop is added as a file alone. The loops are closed: the next call
is issued when the previous one returns. A loop's ``first_steps`` run in
set-up, one batch a call, through the window's own calls; the readings of
those steps (each step's loss, the first gradient as Adam holds it, the
change of the parameters after them) are what ``check.py`` holds against
the reference. A run is one process (``run.py``): a loop that spans
chips starts its other ranks itself.
"""

from __future__ import annotations

import copy
import importlib.util
import json
import time
from contextlib import contextmanager
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent


def load_json(path):
    with open(path) as f:
        return json.load(f)


def load_cell(name, root=HERE):
    """The cell ``name``: its workload file, its configuration and its
    traffic, found by name under ``root``."""
    root = Path(root)
    cell = load_json(root / "workloads" / f"{name}.json")
    config = load_json(root / "configs" / f"{cell['config']}.json")
    traffic = load_json(root / "traffic" / f"{cell['traffic']}.json")
    return cell, config, traffic


def load_limits(name, root=HERE):
    """The limits of cell ``name``'s compared numbers ({number: limit},
    with the readings they were set from beside them)."""
    return {k: float(v) for k, v in load_json(Path(root) / "limits" / f"{name}.json").items()
            if k in ("loss1", "loss", "grad", "change")}


def load_file(path, name):
    """The module of the Python file ``path``, loaded under ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_ENTRIES = {}


def load_entry(name, root=HERE):
    """The loop class of entry ``name``: ``Loop`` of ``entries/<name>.py``
    under ``root``."""
    path = (Path(root) / "entries" / f"{name}.py").resolve()
    if path not in _ENTRIES:
        _ENTRIES[path] = load_file(path, "bench_entry_" + name).Loop
    return _ENTRIES[path]


def program_config(config, traffic, seed, scan_root, root=HERE):
    """The program's config dict: the configuration as run, read from the
    written scan, with what the traffic's loop takes from ``--seed``."""
    cfg = copy.deepcopy(config["config"])
    cfg["dataset"]["root"] = str(scan_root)
    load_entry(traffic["entry"], root).configure(cfg, traffic, seed)
    return cfg


class Spans:
    """Host-clock spans of the harness's calls into the program, kept in
    memory: (name, start, end) in seconds of ``time.perf_counter``. Each
    span also opens a ``torch.profiler.record_function`` of the same name,
    so that a trace sees it."""

    def __init__(self):
        self.items = []

    @contextmanager
    def __call__(self, name):
        t0 = time.perf_counter()
        with torch.profiler.record_function(name):
            yield
        self.items.append((name, t0, time.perf_counter()))


def pad_ids(ids, batch_size):
    """A ragged last batch padded with its last view, as the port's
    loops pad it. -> (ids, number of real views)."""
    ids = np.asarray(ids, np.int64)
    n = len(ids)
    if n < batch_size:
        ids = np.concatenate([ids, np.repeat(ids[-1:], batch_size - n)])
    return ids, n


def leaf_norms(tensors):
    """{leaf: float64 norm} of a dict of tensors."""
    return {k: float(torch.linalg.vector_norm(v.detach().double())) for k, v in tensors.items()}


def per_slot(tensors, n_slots, stacked):
    """A dict of (stacked) tensors -> one dict per slot."""
    if not stacked:
        return [tensors]
    return [{k: v[s] for k, v in tensors.items()} for s in range(n_slots)]


class Loop:
    """The base of the loops: the batches of ``iter_indices()`` pass after
    pass from ``start_epoch``, the first steps and their readings. A loop
    sets ``model``, ``params``, ``optimizer``, ``loader`` and ``seeds`` (one
    a slot) and gives ``one_step``, ``unit``, ``failed_steps`` and
    ``close``; ``stacked``: its parameters carry a leading slot axis."""

    stacked = False

    @classmethod
    def configure(cls, cfg, traffic, seed):
        """Set in the program's config dict what the loop takes from
        ``--seed``."""

    def __init__(self, traffic, spans, device):
        self.traffic = traffic
        self.spans = spans
        self.device = torch.device(device)
        self.steps = 0          # optimizer steps issued
        self.work = 0           # units of the rate: steps, or real slot-steps
        self.step_ids = []      # the view ids of every step, in order
        self.epoch = None

    def _batches(self):
        epoch = int(self.traffic.get("start_epoch", 1))
        self.loader.set_epoch(epoch - 1)
        while True:
            self.epoch = epoch
            self.begin_epoch(epoch)
            for batch, ids in enumerate(self.loader.iter_indices(), start=1):
                yield epoch, batch, np.asarray(ids)
            self.end_epoch(epoch)
            epoch += 1

    def begin_epoch(self, epoch):
        pass

    def end_epoch(self, epoch):
        pass

    def warm_intervals(self):
        """The loop's interval work once, in set-up."""

    def quiet_steps(self):
        """The steps the loop can issue before its next interval action."""
        return float("inf")

    def finish(self):
        """The end of the window."""

    def snapshot(self):
        """What the traced steps' counts start from: the parameters, on
        the host, and the epoch."""
        return {"params": {k: v.detach().to("cpu", copy=True) for k, v in self.params.items()},
                "epoch": self.epoch}

    def first_steps(self):
        """The first ``first_steps`` steps, one batch a call, and their
        readings: {"losses": [[per step] per slot], "grad": [{leaf: norm}
        per slot], "change": [...], "ids": [...]}."""
        n = int(self.traffic["first_steps"])
        p0 = {k: v.detach().clone() for k, v in self.params.items()}
        losses, grad = [], None
        self.batches = self._batches()
        for i in range(n):
            epoch, batch, ids = next(self.batches)
            losses.append(self.one_step(epoch, batch, ids))
            if i == 0:
                grad = self.first_gradient()
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        change = {k: self.params[k].detach() - p0[k] for k in p0}
        S = len(self.seeds)
        return {"losses": [[float(l[s]) for l in losses] for s in range(S)],
                "grad": [leaf_norms(g) for g in per_slot(grad, S, self.stacked)],
                "change": [leaf_norms(c) for c in per_slot(change, S, self.stacked)],
                "ids": [list(map(int, i)) for i in self.step_ids[:n]]}

    def first_gradient(self):
        """The gradient of the first step as Adam holds it: its first
        moment over (1 - beta1)."""
        opt = self.optimizer
        out = {}
        for group in opt.param_groups:
            b1 = group["betas"][0]
            for p in group["params"]:
                name = next(k for k, v in self.params.items() if v is p)
                out[name] = opt.state[p]["exp_avg"].detach() / (1.0 - b1)
        return out


def make_loop(cfg, run_dir, traffic, spans, device, root=HERE):
    return load_entry(traffic["entry"], root)(cfg, run_dir, traffic, spans, device)


def run_window(loop, seconds, tracer=None, sync=True):
    """The measured window: units of the loop until ``seconds`` have
    passed, then the loop's end (the host worker joined) and a
    synchronize. ``tracer``: a ``tracer.Tracer`` started after its
    ``after_s`` at a unit's boundary, with the loop's snapshot, and stopped
    after its steps. ->
    (window seconds, steps, work units)."""
    s0, w0 = loop.steps, loop.work
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        if tracer is not None:
            tracer.maybe_toggle(time.perf_counter() - t0, loop.steps, loop.quiet_steps(),
                                loop.snapshot)
        loop.unit()
    if tracer is not None:
        tracer.stop(loop.steps)
    loop.finish()
    if sync:
        torch.cuda.synchronize()
    return time.perf_counter() - t0, loop.steps - s0, loop.work - w0
