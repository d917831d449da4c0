"""The per-layer metric `kernel_roofline.fit`: `readers.kernel_roofline` in the cells that report
the fit rate."""

from benchmark.readers import kernel_roofline as read  # noqa: F401
