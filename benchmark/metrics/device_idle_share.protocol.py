"""The per-layer metric `device_idle_share.protocol`: `readers.idle_share` in the cells that report
the protocol rate."""

from benchmark.readers import idle_share as read  # noqa: F401
