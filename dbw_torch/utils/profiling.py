"""Layer spans and counters of the optimizer step, kept in memory (the
port's twin of dbw_tpu/utils/profiling.py, which wraps jax.profiler: here
the layers of a step are cut from inside the program, since autograd's
backward runs on its own thread where no caller's span can split it).

Recording is on while a ``torch.profiler`` session records, or inside
``with recording():`` (layer timings without the profiler's own cost).
Off, ``span`` and ``step`` return one shared no-op context, ``mark``
returns its argument and ``count`` does nothing: no event, no autograd
node, no record.

A span is (name, parent, step, thread, host start and end on
``time.perf_counter``, and where CUDA is initialized a pair of timing
events on the current stream, resolved after a synchronize). ``step``
is the ordinal of the ``dbw.step`` span open when the span opened, None
outside one.

The leaves partition a step's device work; each is also opened as a
``torch.profiler.record_function`` of its name, so that a trace's host
ops under it carry it:

- ``dbw.gather``: the host index and the H2D copy of the step's views;
- ``dbw.build``: the scenes' verts, maps, decimation and atlas, and the
  step's random draws;
- ``dbw.raster``: projection and selection (K1);
- ``dbw.shade``: the fragment stage (K2), the texture sample, the light;
- ``dbw.blend``: the layered blend, the supersampling pool, the composite
  over the env pass, a pixel band's gather;
- ``dbw.loss.vgg``: the perceptual loss (the VGG16 trunk);
- ``dbw.loss.other``: the other losses and their total;
- ``dbw.optimizer``: missing gradients zero-filled, the seed column's mean,
  the optimizer step.

A name may occur more than once in a step; its times are summed. The
enclosing spans stay in memory only (mirrored, ``dbw.step`` would be the
outermost host op of every moment of the step): ``dbw.step``
(``Trainer._train_step``, ``MultiSeedRunner.step``) holds ``dbw.gather``,
``dbw.forward`` (``BlocksWorld.forward``), ``dbw.backward`` (the
``backward()`` call) and ``dbw.optimizer``; ``dbw.forward`` holds
``dbw.env_pass`` and ``dbw.blocks_pass`` (each a build, raster, shade and
blend) and the losses. Every step's draws (``dbw.build``, in
``parallel.seeds.train_step``) come before its forward, and the Trainer's
stacked losses (``dbw.loss.other``) after its optimizer step.

The backward's leaves, ``dbw.bwd.<leaf>`` (``dbw.bwd.raster`` for
``dbw.raster``), are children of ``dbw.backward``. ``mark(outputs, leaf)``
puts an identity autograd node (a view, no kernel) on a forward leaf's
outputs; its backward closes the open backward leaf and opens the leaf's
own. ``dbw.backward`` opens the leaf of the latest mark as ``backward()``
starts (the engine's own start counts to it) and closes the last leaf
when ``backward()`` returns, so the backward's leaves tile it.
They carry host time (on autograd's thread for a card) and stream time,
and are not mirrored into the profiler: a range opened in one node's
backward and closed in another's would cross autograd's own ranges.

The order rule: autograd runs the ready nodes of a device by descending
sequence number, that is, latest created first, and a leaf's marker is
created after every node of its leaf and before any node of a later one.
So the backward's leaves come out as contiguous segments in the reverse
order of the forward's marked leaves, a run of one name making one leaf.
A backward outside a ``dbw.backward`` span records no leaves.

Counters of a step: ``h2d_bytes`` (the bytes ``dbw.gather`` copies to a
card), ``launches.<kernel>``, the step's change of
``dbw_torch.kernels.LAUNCHES``, and on a card the device memory that the
forward holds: ``mem.held_bytes.<leaf>``, the bytes allocated on the card
when a forward leaf (one that opens in the step before its
``dbw.backward``) closes less when it opened, summed over the leaf's
spans, and ``mem.held_bytes``, the same from the open of ``dbw.step`` to
the open of ``dbw.backward``: the step's growth by then, which bounds
how many slots a card batches. The leaves sum to more than the step:
what a leaf's caller frees after its close (temporaries dropped when a
function returns) and the last step's gradients (freed by ``zero_grad``
before the forward) count in the step and not in the leaves. Each reading
is taken inside its span, from the caching allocator's counters
(``_allocated``): no device sync, and the peak statistics are left as
they are.

    with profiling.recording():
        trainer.run()
    profiling.summary()   # per step: host and stream ms, self ms, counters
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager, nullcontext

import torch

LEAVES = ("dbw.gather", "dbw.build", "dbw.raster", "dbw.shade", "dbw.blend",
          "dbw.loss.vgg", "dbw.loss.other", "dbw.optimizer")
ENCLOSING = ("dbw.step", "dbw.forward", "dbw.backward", "dbw.env_pass", "dbw.blocks_pass")
BACKWARD = "dbw.bwd."

_NOOP = nullcontext()
_FORCED = 0


def _profiler_on():
    return torch._C._autograd._profiler_enabled()


def on():
    """Whether spans, marks and counters record now."""
    return _FORCED > 0 or _profiler_on()


class Span:
    __slots__ = ("name", "parent", "step", "thread", "host0", "host1", "ev0", "ev1",
                 "stream_ms")

    def __init__(self, name, parent, step):
        self.name, self.parent, self.step = name, parent, step
        self.thread = threading.get_ident()
        self.host1 = self.ev1 = self.stream_ms = None
        self.ev0 = _event()
        self.host0 = time.perf_counter()

    def close(self):
        self.ev1 = _event()
        self.host1 = time.perf_counter()

    @property
    def host_ms(self):
        return 1e3 * (self.host1 - self.host0)


def _allocated():
    """The bytes the caching allocator has handed out on the current card,
    read from its counters (no device sync), or None before CUDA is
    initialized."""
    if not torch.cuda.is_initialized():
        return None
    return torch.cuda.memory_stats_as_nested_dict()["allocated_bytes"]["all"]["current"]


def _event():
    if not torch.cuda.is_initialized():
        return None
    e = torch.cuda.Event(enable_timing=True)
    e.record()
    return e


class _Recorder:
    def __init__(self):
        self.lock = threading.Lock()
        self.reset()

    def reset(self):
        self.spans = []
        self.counters = {}          # step ordinal (or None) -> {name: value}
        self.n_steps = 0            # dbw.step spans opened
        self.cur_step = None        # the open dbw.step's ordinal
        self.step_mem = None        # card bytes at the step's open, till dbw.backward
        self.bwd = None             # [dbw.backward's index, open backward leaf]
        self.last_mark = None       # the backward leaf of the latest mark
        self.resolved = 0           # spans before this index hold no event
        self.local = threading.local()

    def _stack(self):
        st = getattr(self.local, "stack", None)
        if st is None:
            st = self.local.stack = []
        return st

    def open(self, name, parent):
        s = Span(name, parent, self.cur_step)
        with self.lock:
            self.spans.append(s)
            return len(self.spans) - 1

    @contextmanager
    def span(self, name):
        rf = None
        if name not in ENCLOSING and _profiler_on():
            rf = torch.profiler.record_function(name)
            rf.__enter__()
        stack = self._stack()
        i = self.open(name, stack[-1] if stack else None)
        stack.append(i)
        outer_bwd = self.bwd
        if name == "dbw.backward":
            self.bwd = [i, None]
            self.enter_backward(self.last_mark)
        mem0 = None
        if self.step_mem is not None and name == "dbw.backward":
            self.count("mem.held_bytes", _allocated() - self.step_mem)
            self.step_mem = None
        elif self.step_mem is not None and name in LEAVES:
            mem0 = _allocated()
        try:
            yield
        finally:
            if mem0 is not None:
                self.count("mem.held_bytes." + name, _allocated() - mem0)
            if name == "dbw.backward":
                self.enter_backward(None)
                self.bwd = outer_bwd
            stack.pop()
            self.spans[i].close()
            if rf is not None:
                rf.__exit__(None, None, None)

    @contextmanager
    def step(self):
        from .. import kernels

        before = dict(kernels.LAUNCHES)
        self.cur_step = ordinal = self.n_steps
        self.n_steps += 1
        self.step_mem = _allocated()
        try:
            with self.span("dbw.step"):
                yield
        finally:
            self.cur_step = self.step_mem = None
            c = self.counters.setdefault(ordinal, {})
            for k, v in kernels.LAUNCHES.items():
                c["launches." + k] = c.get("launches." + k, 0) + v - before.get(k, 0)
            self.resolve(block=False)

    def count(self, name, value):
        c = self.counters.setdefault(self.cur_step, {})
        c[name] = c.get(name, 0) + value

    def enter_backward(self, name):
        """Close the open backward leaf and open ``name`` (None: none)."""
        b = self.bwd
        if b is None or (b[1] is not None and self.spans[b[1]].name == name):
            return
        if b[1] is not None:
            self.spans[b[1]].close()
        b[1] = None if name is None else self.open(name, b[0])

    def resolve(self, block):
        """Stream ms of the closed spans whose events have completed, in
        order of opening (``block``: after a synchronize, all of them)."""
        if block and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        while self.resolved < len(self.spans):
            s = self.spans[self.resolved]
            if s.host1 is None:
                break
            if s.ev0 is not None:
                if not block and not s.ev1.query():
                    break
                s.stream_ms = s.ev0.elapsed_time(s.ev1)
            s.ev0 = s.ev1 = None
            self.resolved += 1


_REC = _Recorder()


def span(name):
    """A span of ``name`` (a leaf of ``LEAVES`` or a span of ``ENCLOSING``)
    around a ``with`` block."""
    return _REC.span(name) if on() else _NOOP


def step():
    """The ``dbw.step`` span of one optimizer step, with its counters."""
    return _REC.step() if on() else _NOOP


def count(name, value):
    """Add ``value`` to the counter ``name`` of the open step."""
    if on():
        _REC.count(name, value)


class _Mark(torch.autograd.Function):
    @staticmethod
    def forward(ctx, name, *xs):
        ctx.name = name
        ctx.set_materialize_grads(False)
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        _REC.enter_backward(ctx.name)
        return (None, *grads)


def _map_tensors(fn, x):
    if torch.is_tensor(x):
        return fn(x)
    if isinstance(x, dict):
        return {k: _map_tensors(fn, v) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_map_tensors(fn, v) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(_map_tensors(fn, v) for v in x)
    return x


def mark(outputs, leaf):
    """``outputs`` of the forward leaf ``leaf`` (a tensor, or tuples, named
    tuples, lists and dicts of them), its tensors that require grad passed
    through one marker node: the backward's leaf of ``leaf`` starts where
    their gradients are complete. Off, or without grad: ``outputs``
    itself."""
    if not on() or not torch.is_grad_enabled():
        return outputs
    found = {}
    _map_tensors(lambda t: found.setdefault(id(t), t) if t.requires_grad else t, outputs)
    if not found:
        return outputs
    _REC.last_mark = BACKWARD + leaf[len("dbw."):]
    views = dict(zip(found, _Mark.apply(_REC.last_mark, *found.values())))
    return _map_tensors(lambda t: views.get(id(t), t), outputs)


@contextmanager
def recording():
    """Record spans, marks and counters inside the block, profiler or not."""
    global _FORCED
    _FORCED += 1
    try:
        yield
    finally:
        _FORCED -= 1


def reset():
    """Drop every record."""
    _REC.reset()


def records():
    """The spans recorded so far (``Span``: name, parent index, step, thread,
    host0/host1 seconds, stream_ms once resolved) and the counters by step,
    after a synchronize."""
    _REC.resolve(block=True)
    return list(_REC.spans), {k: dict(v) for k, v in _REC.counters.items()}


def summary():
    """Per step, in order: {"step", "host_ms", "stream_ms", "self_host_ms",
    "self_stream_ms", "counters"}, each a {name: value} summed over the
    step's spans of that name; self time is a span's time less its
    children's; ``stream_ms`` is empty off a card. The spans and counters
    outside any ``dbw.step`` come last, under "step" None, if any."""
    spans, counters = records()
    children = {}
    for i, s in enumerate(spans):
        if s.parent is not None:
            children.setdefault(s.parent, []).append(s)
    out = {}
    for i, s in enumerate(spans):
        if s.host1 is None:
            continue
        row = out.setdefault(s.step, {"step": s.step, "host_ms": {}, "stream_ms": {},
                                      "self_host_ms": {}, "self_stream_ms": {}})
        kids = children.get(i, [])
        _add(row["host_ms"], s.name, s.host_ms)
        _add(row["self_host_ms"], s.name,
             s.host_ms - sum(k.host_ms for k in kids if k.host1 is not None))
        if s.stream_ms is not None:
            _add(row["stream_ms"], s.name, s.stream_ms)
            _add(row["self_stream_ms"], s.name,
                 s.stream_ms - sum(k.stream_ms for k in kids if k.stream_ms is not None))
    for k, c in counters.items():
        out.setdefault(k, {"step": k, "host_ms": {}, "stream_ms": {}, "self_host_ms": {},
                           "self_stream_ms": {}})["counters"] = c
    rows = [out[k] for k in sorted(k for k in out if k is not None)]
    if None in out:
        rows.append(out[None])
    for r in rows:
        r.setdefault("counters", {})
    return rows


def _add(d, k, v):
    d[k] = d.get(k, 0.0) + v
