"""Share of the traced training window, %, in which the device runs no
kernel, copy or memset."""

from h100bench.core.readers import device_idle as read  # noqa: F401
