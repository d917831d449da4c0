"""The per-layer metric `launches_per_step.fit`: `readers.launches_per_step` in the cells that report
the fit rate."""

from benchmark.readers import launches_per_step as read  # noqa: F401
