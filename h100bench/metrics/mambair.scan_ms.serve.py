"""Device ms a request of MambaIR spends in its SS2D scan kernel
(``m2t_ss2d_scan``)."""

from h100bench.core.mambair_readers import scan_ms as read  # noqa: F401
