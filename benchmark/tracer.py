"""The ``--trace 1`` run's profiler and what is read from it.

``torch.profiler`` (CPU and CUDA activities) is on for a steady part of the
window: from the first unit boundary after the traffic's ``trace_after_s``
until ``trace_steps`` optimizer steps have been issued, between two
synchronizes. The device records (kernels and copies) give the busy time
(the union of their intervals), the launches and each op's time; the idle
gaps between busy intervals are named by the harness span and the host op
that the device waited for. ``device_events`` and
``device_busy`` are copies of ``chip_smoke.py``'s, ``op_times`` of
``scripts/torch_trace_bench.py``'s.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict

import torch

# the port's hand-written kernels, by the name of their device function
HAND_WRITTEN = ("select_kernel", "frag_fwd_kernel", "frag_bwd_kernel", "texel_grad_kernel",
                "texel_pack_kernel", "small_scatter_kernel")
TOP = 10


def device_events(events):
    """The device records (kernels and copies) of a profiler's events."""
    return [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def merged(spans):
    """Sorted (start, end) intervals -> their union as disjoint intervals."""
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def device_busy(intervals):
    """(busy, span) of (start, end) intervals: the length of their union,
    and the span from the first start to the last end."""
    u = merged(intervals)
    return sum(b - a for a, b in u), u[-1][1] - u[0][0]


def op_times(events):
    """{op name: (total seconds, count)} of device records (profiler
    microseconds)."""
    total, count = defaultdict(float), defaultdict(int)
    for e in events:
        total[e.name] += (e.time_range.end - e.time_range.start) / 1e6
        count[e.name] += 1
    return {n: (total[n], count[n]) for n in total}


def is_launch(name):
    return not (name.startswith("Memcpy") or name.startswith("Memset"))


def idle_gaps(busy, host_ops, spans, lead_us=5.0):
    """The gaps between the busy intervals, summed by what ended each: the
    harness span and the outermost host op (of any thread: the backward
    runs on autograd's) that was running ``lead_us`` before the next
    device record began, the op whose launch the device waited for:
    '<harness span>/<host op>'. ``busy``: merged intervals; ``host_ops``:
    per thread, sorted, disjoint (start, end, name); ``spans``: the same of
    the harness's spans. -> [(label, seconds)], longest first."""
    starts_s = [s for s, _, _ in spans]
    starts_o = [[s for s, _, _ in ops] for ops in host_ops]

    def at(items, starts, t):
        i = bisect.bisect_right(starts, t) - 1
        return items[i] if i >= 0 and items[i][1] > t else None

    out = defaultdict(float)
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        t = max(s1 - lead_us, e0)
        span = at(spans, starts_s, t)
        ops = [o for o in (at(ops, st, t) for ops, st in zip(host_ops, starts_o)) if o]
        op = min(ops)[2] if ops else "python"
        out[f"{span[2] if span else 'outside'}/{op}"] += (s1 - e0) / 1e6
    return sorted(out.items(), key=lambda kv: -kv[1])


def outermost(events):
    """Sorted, disjoint (start, end, name) of the outermost of ``events``
    (events nested in an earlier one dropped)."""
    out = []
    for s, e, n in sorted(events):
        if out and s < out[-1][1]:
            continue
        out.append((s, e, n))
    return out


class Tracer:
    """The profiler over ``steps`` optimizer steps from the first unit
    boundary after ``after_s`` seconds of the window from which as many
    steps run without interval work."""

    def __init__(self, after_s, steps):
        self.after_s, self.steps = float(after_s), int(steps)
        self.prof = None
        self.start_steps = None
        self.done = False
        self.host_s = None
        self.state = None

    def maybe_toggle(self, elapsed, steps, quiet, snapshot=None):
        """Called before each unit of the loop; ``quiet``: the steps the
        loop can issue before its next interval action; ``snapshot``: called
        once before the profiler starts, its value kept as ``state``."""
        if self.done:
            return
        if self.prof is None and elapsed >= self.after_s and quiet > 2 * self.steps:
            from torch.profiler import ProfilerActivity, profile

            if snapshot is not None:
                self.state = snapshot()
            torch.cuda.synchronize()
            self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            self.prof.__enter__()
            self.start_steps = steps
            self._t0 = time.perf_counter()
        elif self.prof is not None and steps - self.start_steps >= self.steps:
            self.stop(steps)

    def stop(self, steps=None):
        if self.prof is None or self.done:
            return
        torch.cuda.synchronize()
        self.host_s = time.perf_counter() - self._t0
        self.prof.__exit__(None, None, None)
        self.done = True
        if steps is not None:
            self.traced_steps = steps - self.start_steps

    def summary(self):
        """What the per-layer readers and the result's ``device`` and
        ``breakdown`` take from the trace, or None with no device
        record."""
        if self.prof is None:
            return None
        events = self.prof.events()
        dev = device_events(events)
        if not dev:
            return None
        ivals = [(e.time_range.start, e.time_range.end) for e in dev]
        busy_us, span_us = device_busy(ivals)
        ops = op_times(dev)
        by_thread = defaultdict(list)
        spans = []
        for e in events:
            if e.device_type != torch.autograd.DeviceType.CPU:
                continue
            item = (e.time_range.start, e.time_range.end, e.name)
            (spans if e.name.startswith("bench.") else by_thread[e.thread]).append(item)
        gaps = idle_gaps(merged(ivals), [outermost(v) for v in by_thread.values()],
                         outermost(spans))
        hand = {n: v for n, v in ops.items() if any(k in n for k in HAND_WRITTEN)}
        top = sorted(ops.items(), key=lambda kv: -kv[1][0])[:TOP]
        return {
            "busy_s": busy_us / 1e6,
            "window_s": span_us / 1e6,
            "host_s": self.host_s,
            "steps": getattr(self, "traced_steps", None),
            "launches": sum(n for name, (_, n) in ops.items() if is_launch(name)),
            "hand_written": {n: list(v) for n, v in hand.items()},
            "device_ops": [[n, t] for n, (t, _) in top],
            "idle_gaps": [[n, t] for n, t in gaps[:TOP]],
        }
