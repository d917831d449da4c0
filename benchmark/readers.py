"""What the per-layer metrics read, from the ``--trace 1`` run's context:

- ``trace``: ``tracer.Tracer.summary()`` (device busy and span over the
  traced steps, their launches, the hand-written kernels' device time),
  or None;
- ``spans``: the harness's (name, start, end) host-clock spans;
- ``window``: (start, end) of the measured window on the same clock;
- ``steps``, ``window_s``: the optimizer steps and seconds of the window;
- ``counts``: ``run.traced_counts``, the counts of the traced steps
  summed, with their number (``steps``), or None.

Each returns None where it finds nothing to read, and the harness then
leaves the metric out of the line."""

from __future__ import annotations

from .counts.kernels import BF16_FLOPS_PER_S, FP32_FLOPS_PER_S

INTERVAL_SPANS = ("bench.interval.log", "bench.interval.val", "bench.interval.viz",
                  "bench.interval.save")


def idle_share(ctx):
    """% of the traced span in which no kernel or copy ran on the device."""
    t = ctx.get("trace")
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def launches_per_step(ctx):
    """Device kernel launches in the trace over the steps traced."""
    t = ctx.get("trace")
    if not t or not t.get("steps"):
        return None
    return t["launches"] / t["steps"]


def interval_ms(ctx):
    """Host ms of the interval calls over the window, per val interval."""
    w0, w1 = ctx["window"]
    inside = [(n, a, b) for n, a, b in ctx["spans"] if a >= w0 and b <= w1]
    n_val = sum(1 for n, _, _ in inside if n == "bench.interval.val")
    if not n_val:
        return None
    return 1e3 * sum(b - a for n, a, b in inside if n in INTERVAL_SPANS) / n_val


def kernel_roofline(ctx):
    """% of the hand-written kernels' device time in the trace that their
    bound (``counts.kernels``) at the traced steps' shapes accounts for."""
    t, c = ctx.get("trace"), ctx.get("counts")
    if not t or not c or not t["hand_written"]:
        return None
    device_s = sum(s for s, _ in t["hand_written"].values())
    return 100.0 * c["kernel_bound_s"] / device_s


def step_mfu(ctx):
    """% of the card's peak that the window's steps used, on the host
    clock: the operations of a traced step (the LPIPS trunk's at the
    bfloat16 peak, the kernels' at the float32 one), times the window's
    steps, over the window's seconds."""
    c = ctx.get("counts")
    if not c or not c["steps"] or not ctx["steps"]:
        return None
    per_step_s = (c["vgg_flops"] / BF16_FLOPS_PER_S + c["kernel_flops"] / FP32_FLOPS_PER_S) \
        / c["steps"]
    return 100.0 * per_step_s * ctx["steps"] / ctx["window_s"]
