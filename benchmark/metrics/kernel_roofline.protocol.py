"""The per-layer metric `kernel_roofline.protocol`: `readers.kernel_roofline` in the cells that report
the protocol rate."""

from benchmark.readers import kernel_roofline as read  # noqa: F401
