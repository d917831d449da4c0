"""The per-layer metric `vgg_stream_ms.protocol`, in the cells that report the
protocol rate: the stream ms of the leaf `dbw.loss.vgg` and of its backward
leaf, per optimizer step, averaged over the traced `dbw.step` spans that
`dbw_torch.utils.profiling` recorded while the profiler ran. None without
such records (a program without the spans; no card, for stream ms)."""

KIND = "stream_ms"
NAMES = ("dbw.loss.vgg", "dbw.bwd.loss.vgg")


def read(ctx):
    try:
        from dbw_torch.utils import profiling
    except ImportError:
        return None
    steps = [s for s in profiling.summary() if s["step"] is not None and "dbw.step" in s[KIND]]
    if not steps:
        return None
    return sum(s[KIND].get(n, 0.0) for s in steps for n in NAMES) / len(steps)
