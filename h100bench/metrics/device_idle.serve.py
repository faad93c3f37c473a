"""Share of the traced window, %, in which the device runs no kernel, copy or
memset; a request of a served stream."""

from h100bench.core.readers import device_idle as read  # noqa: F401
