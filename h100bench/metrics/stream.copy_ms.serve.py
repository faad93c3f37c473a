"""Device ms in host<->device copies, a request of the offline batch stream
(moves serve_mps): ``parallel.streaming``'s pinned slots."""

from h100bench.core.readers import copy_ms as read  # noqa: F401
