"""The per-layer metric `step_mfu.fit`: `readers.step_mfu` in the cells that report
the fit rate."""

from benchmark.readers import step_mfu as read  # noqa: F401
