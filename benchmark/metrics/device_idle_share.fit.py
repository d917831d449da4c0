"""The per-layer metric `device_idle_share.fit`: `readers.idle_share` in the cells that report
the fit rate."""

from benchmark.readers import idle_share as read  # noqa: F401
