"""MambaIR's SS2D scan kernel's share of its roofline, %: the frozen bound
of a request's 36 launches (FP32 operations at 67 TFLOP/s or bytes at 3.35
TB/s, the larger) over the device ms in ``m2t_ss2d_scan``, a request of the
offline batch stream (moves serve_mps)."""

from h100bench.core.mambair_readers import scan_roofline as read  # noqa: F401
