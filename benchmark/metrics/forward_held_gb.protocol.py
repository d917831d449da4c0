"""The per-layer metric `forward_held_gb.protocol`, in the cells that report
the protocol rate: the counter `mem.held_bytes` of `dbw_torch.utils.profiling`
(the bytes allocated on the card from the open of `dbw.step` to the open of
`dbw.backward`: what the forward holds for the backward), in GB (1e9 bytes),
averaged over the traced `dbw.step` spans recorded while the profiler ran.
None without such counters (a program without them; no card)."""

NAME = "mem.held_bytes"


def read(ctx):
    try:
        from dbw_torch.utils import profiling
    except ImportError:
        return None
    held = [s["counters"][NAME] for s in profiling.summary()
            if s["step"] is not None and NAME in s["counters"]]
    if not held:
        return None
    return sum(held) / len(held) / 1e9
