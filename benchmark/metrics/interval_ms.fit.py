"""The per-layer metric `interval_ms.fit`: `readers.interval_ms` in the cells that report
the fit rate."""

from benchmark.readers import interval_ms as read  # noqa: F401
