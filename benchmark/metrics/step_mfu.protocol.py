"""The per-layer metric `step_mfu.protocol`: `readers.step_mfu` in the cells that report
the protocol rate."""

from benchmark.readers import step_mfu as read  # noqa: F401
